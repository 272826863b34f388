"""Import hygiene of the port and the drift guard for its copies.

* ``repro_torch`` imports neither ``jax`` nor any module of ``repro``
  (checked in a fresh interpreter, so this process's imports cannot hide
  a leak).
* Entry points default to the card and raise on this CPU-only host
  instead of falling back (``--disagg`` and ``--trace`` included); the
  backend pairs the reference refuses are argparse errors here too.
* The port keeps its own copies of ``repro.sim.servicemodel`` /
  ``repro.sim.executor`` (under ``_``-prefixed names where the linter's
  twin-drift rule would see a second definition): every constant equals
  the reference's, every shared predicate agrees on a grid of inputs,
  and the sim executors take the reference's keyword defaults; the RG-LRU
  constant (``_C_RGLRU``) equals ``repro.models.rglru.C_RGLRU``.
* ``python -m repro.analysis`` still finds nothing new.
"""

import ast
import inspect
import json
import math
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.obs.tracer as jtracer
import repro.sim.executor as jexec
import repro.sim.servicemodel as jsm
import repro.core.network as jnet
import repro.models.rglru as jrglru
import repro_torch.core.network as tnet
import repro_torch.models.rglru as trglru
import repro_torch.obs.tracer as ttracer
import repro_torch.sim.executor as texec
import repro_torch.sim.servicemodel as tsm
from repro_torch.configs import get_config
from repro_torch.launch import serve

REPO = pathlib.Path(__file__).resolve().parents[1]




@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


_PROBE = """
import importlib, json, pkgutil, sys
import repro_torch
mods = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                    "repro_torch."))
for m in mods:
    if not m.endswith("__main__"):
        importlib.import_module(m)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(json.dumps({"modules": mods, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_repro():
    out = subprocess.run([sys.executable, "-c", _PROBE], check=True,
                         capture_output=True, text=True, cwd=REPO,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["bad"] == []
    for must in ("repro_torch.launch.serve", "repro_torch.kernels.ops",
                 "repro_torch.serving.engine", "repro_torch.core.network",
                 "repro_torch.models.rglru"):
        assert must in got["modules"]


def test_entry_points_default_to_the_card_and_raise_without_it():
    if torch.cuda.is_available():
        pytest.skip("this host has a card: the default device is usable")
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.run(cfg, nodes=1, requests=1)
    for flags in ([], ["--paged"], ["--spec"], ["--kv-quant"],
                  ["--spec", "--kv-quant"], ["--disagg"],
                  ["--trace", "t.json"], ["--disagg", "--trace", "t.json"]):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(flags)
    for flags in (["--kv-quant", "--disagg"], ["--spec", "--disagg"]):
        with pytest.raises(SystemExit):     # argparse error, not a silent
            serve.main(["--device", "cpu", *flags])  # switch of backend


def _public_consts(mod):
    tree = ast.parse(pathlib.Path(mod.__file__).read_text())
    names = []
    for node in tree.body:
        targets = (node.targets if isinstance(node, ast.Assign)
                   else [node.target] if isinstance(node, ast.AnnAssign)
                   else [])
        names += [t.id for t in targets
                  if isinstance(t, ast.Name) and t.id.isupper()]
    return names


def test_copied_constants_equal_the_reference():
    names = _public_consts(jsm)
    assert {"SPEC_K", "DIGEST_TIE_EPS", "KV_BYTES_PER_TOKEN",
            "TRANSFER_BYTES_PER_S", "TRANSFER_BASE_S", "SPEC_ALPHA0",
            "SPEC_OVERHEAD", "KV_TOKENS_PER_STREAM", "GPU_SCALE"} <= set(names)
    for name in names:
        assert getattr(tsm, "_" + name) == getattr(jsm, name), name
    assert ttracer._SIM == jtracer.SIM and ttracer._WALL == jtracer.WALL
    assert tnet._TREASURY == jnet.TREASURY
    assert trglru._C_RGLRU == jrglru.C_RGLRU
    for args in [("qwen3-8b", "RTX3090", "sglang", "bf16", 0.55),
                 ("qwen3-32b", "A100", "vllm", "fp8wo", 0.7)]:
        assert tsm.make_profile(*args).__dict__ == \
            jsm.make_profile(*args).__dict__


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen3-32b", "starcoder2-7b",
                                  "command-r-plus-104b",
                                  "granite-moe-1b-a400m", "dbrx-132b",
                                  "qwen2-vl-7b", "recurrentgemma-9b",
                                  "xlstm-1.3b", "whisper-base"])
def test_config_copies_equal_the_reference(arch):
    """Each config, its smoke size, its draft and its ``long_500k`` window
    variant equal ``repro.configs``' field by field; the port has every
    arch of the reference, and the copied input-shape grid and default
    window equal the reference's; an unknown arch raises ``KeyError`` in
    both."""
    import dataclasses
    import repro.configs as jconfigs
    import repro_torch.configs as tconfigs
    for shape in (None, "long_500k", "decode_32k"):
        want = jconfigs.get_config(arch, shape)
        got = tconfigs.get_config(arch, shape)
        for c_t, c_j in ((got, want), (got.smoke(), want.smoke()),
                         (got.draft(), want.draft())):
            assert dataclasses.asdict(c_t) == dataclasses.asdict(c_j)
    assert tconfigs.ARCHS == jconfigs.ARCHS
    assert {k: dataclasses.asdict(v)
            for k, v in tconfigs._INPUT_SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jconfigs.INPUT_SHAPES.items()}
    assert (tconfigs._DEFAULT_LONG_CONTEXT_WINDOW
            == jconfigs.DEFAULT_LONG_CONTEXT_WINDOW)
    for pkg in (tconfigs, jconfigs):
        with pytest.raises(KeyError, match="unknown arch"):
            pkg.get_config(arch + "-x")


@pytest.mark.parametrize("name", ["TokenBucketExecutor",
                                  "SpecTokenBucketExecutor",
                                  "DisaggTokenBucketExecutor"])
def test_sim_twins_take_the_reference_defaults(name):
    """The sim executors' keyword defaults (the spec and transfer constants
    the port imports under ``_`` names) equal the reference's."""
    def defaults(cls):
        return {k: p.default for k, p in
                inspect.signature(cls.__init__).parameters.items()
                if p.default is not inspect.Parameter.empty}
    want = defaults(getattr(jexec, name))
    assert defaults(getattr(texec, name)) == want
    assert name == "TokenBucketExecutor" or want


def test_copied_predicates_agree_on_a_grid():
    for tokens in range(0, 70):
        for page in (1, 3, 8, 16, 32):
            assert texec.pages_for(tokens, page) == jexec.pages_for(
                tokens, page)
            for matched in (0, 7, 16, 40, 70):
                assert texec.prefix_hit_pages(tokens, page, matched) == \
                    jexec.prefix_hit_pages(tokens, page, matched)
            for free in (0, 1, 2, 5):
                for resident in (False, True):
                    assert texec.paged_admit_ok(free, tokens, page,
                                                resident) == \
                        jexec.paged_admit_ok(free, tokens, page, resident)
    for n in (0, 1, 17):
        for q in (False, True):
            assert texec.quantized_pages(n, q) == jexec.quantized_pages(n, q)
    for alpha in np.linspace(-0.5, 1.5, 21):
        for k in (0, 1, 4, 8):
            assert math.isclose(texec.spec_expected_tokens(alpha, k),
                                jexec.spec_expected_tokens(alpha, k))
    for age in (-1.0, 0.0, 0.3, 5.0, 60.0):
        assert texec.digest_staleness_weight(age) == \
            jexec.digest_staleness_weight(age)
    for pid in ("", "sys-prompt", "prefix/42"):
        assert texec.prefix_fingerprint_id(pid) == \
            jexec.prefix_fingerprint_id(pid)


def test_linter_finds_nothing_new():
    out = subprocess.run([sys.executable, "-m", "repro.analysis", "--root",
                          "."], cwd=REPO, capture_output=True, text=True,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
