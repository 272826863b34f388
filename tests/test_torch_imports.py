"""Import hygiene of the port and the drift guard for its copies.

* ``repro_torch`` imports neither ``jax`` nor any module of ``repro``
  (checked in a fresh interpreter, so this process's imports cannot hide
  a leak).
* Entry points default to the card and raise on this CPU-only host
  instead of falling back (``--disagg`` and ``--trace`` included, the
  training launcher, and the dry run, whose fake tensors default to the
  card; the host mesh is built on the card); the backend pairs the
  reference refuses are argparse errors here too.
* The training and section 5 copies (``AdamWConfig``, ``DataConfig``,
  ``GameParams``, ``CreditSimParams``) keep the reference's defaults,
  and their shared functions agree on a grid of inputs.
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
from repro_torch.launch import serve, train

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
                 "repro_torch.models.rglru", "repro_torch.launch.train",
                 "repro_torch.training.optimizer",
                 "repro_torch.training.train_step",
                 "repro_torch.training.checkpoint",
                 "repro_torch.training.tree", "repro_torch.data.pipeline",
                 "repro_torch.core.gametheory",
                 "repro_torch.core.creditsim",
                 "repro_torch.compat.meshenv", "repro_torch.launch.mesh",
                 "repro_torch.launch.sharding", "repro_torch.launch.specs",
                 "repro_torch.launch.steps", "repro_torch.launch.dryrun",
                 "repro_torch.models.runtime"):
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
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", "qwen3-8b", "--steps", "1", "--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.train(cfg, steps=1, batch=1, seq=8)
    # the mesh layer: the dry run's fake tensors and the host mesh sit on
    # the card unless the caller asks for the CPU
    from repro_torch.compat import meshenv
    from repro_torch.launch import dryrun, make_host_mesh
    assert dryrun.main(["--arch", "qwen3-8b", "--shape", "decode_32k"]) == 1
    with meshenv.process_group("gloo"):
        assert make_host_mesh().device_type == "cuda"
        assert make_host_mesh("cpu").device_type == "cpu"


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


def test_training_and_section5_copies_equal_the_reference():
    """The defaults the port's copies keep as fields (``AdamWConfig``,
    ``DataConfig``, ``GameParams``, ``CreditSimParams``) equal the
    reference's, and the shared predicates agree on a grid: the learning
    rate schedule, the cross entropy, the payoff and both right-hand
    sides."""
    import dataclasses
    import jax.numpy as jnp
    import repro.core.creditsim as jcs
    import repro.core.gametheory as jgt
    import repro.data.pipeline as jpipe
    import repro.training.optimizer as jopt
    import repro.training.train_step as jstep
    import repro_torch.core.creditsim as tcs
    import repro_torch.core.gametheory as tgt
    import repro_torch.data.pipeline as tpipe
    import repro_torch.training.optimizer as topt
    import repro_torch.training.train_step as tstep
    assert topt.AdamWConfig()._asdict() == jopt.AdamWConfig()._asdict()
    assert topt.AdamWConfig._fields == jopt.AdamWConfig._fields
    assert [(f.name, f.default) for f in dataclasses.fields(
        tpipe.DataConfig)] == [(f.name, f.default) for f in
                               dataclasses.fields(jpipe.DataConfig)]
    assert tgt.GameParams._field_defaults == jgt.GameParams._field_defaults
    assert tcs.CreditSimParams._field_defaults == \
        jcs.CreditSimParams._field_defaults
    for cfg in (dict(), dict(warmup_steps=0, total_steps=3),
                dict(lr=2.0, warmup_steps=7, total_steps=7,
                     min_lr_ratio=0.5)):
        for step in range(0, 12):
            want = float(jopt.lr_schedule(jopt.AdamWConfig(**cfg),
                                          jnp.asarray(step)))
            got = float(topt.lr_schedule(topt.AdamWConfig(**cfg),
                                         torch.tensor(step)))
            assert math.isclose(got, want, rel_tol=1e-6, abs_tol=1e-12)
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 5)).astype(np.int32)
    assert math.isclose(
        float(tstep.cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels), 11)),
        float(jstep.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                  11)), rel_tol=1e-6)
    for q in ([0.9, 0.1], [0.2, 0.5, 0.7, 0.95]):
        s = rng.uniform(0.1, 3.0, len(q)).astype(np.float32)
        pt = tgt.GameParams(q=torch.tensor(q), c=torch.full((len(q),), 0.3),
                            p_d=0.4)
        pj = jgt.GameParams(q=jnp.asarray(q, jnp.float32),
                            c=jnp.full((len(q),), 0.3), p_d=0.4)
        for fn in ("payoff_delta", "stake_rhs", "share_rhs"):
            np.testing.assert_allclose(
                getattr(tgt, fn)(pt, torch.from_numpy(s)).numpy(),
                np.asarray(getattr(jgt, fn)(pj, jnp.asarray(s))),
                rtol=1e-6, atol=1e-7)


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
