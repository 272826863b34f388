"""The serving driver's scenario on the new architectures, both packages.

``repro_torch.launch.serve.run`` on the CPU against the reference driver's
replay (``tests/test_torch_serve.py``'s ``_reference_run``), both on the
same perturbed, bridged weights (``tests/test_torch_dense_variants.py``'s
``perturbed``: every norm scale, norm bias and bias moved off its start):
starcoder2-7b on slot engines (the driver's default), command-r-plus-104b
on paged engines (``--paged``), and granite-moe-1b-a400m and xlstm-1.3b,
whose engines serve left-padded waves.  The protocol's assignment, the
credit balances, the SLO attainment and every request's greedy tokens
must be the reference's.  whisper-base's wave engines pass the prefill
tokens alone, so both drivers raise the same ``KeyError``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serve as ts
from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import bridge
from test_torch_dense_variants import perturbed

CASES = {"starcoder2-7b-slot": ("starcoder2-7b", "slot"),
         "command-r-plus-104b-paged": ("command-r-plus-104b", "paged"),
         "granite-moe-1b-a400m-wave": ("granite-moe-1b-a400m", "slot"),
         "xlstm-1.3b-wave": ("xlstm-1.3b", "slot")}


@pytest.fixture(scope="module", params=sorted(CASES))
def runs(request):
    torch.set_num_threads(2)
    arch, mode = CASES[request.param]
    cfg_j = jax_get_config(arch).smoke().replace(dtype="float32")
    cfg_t = get_config(arch).smoke().replace(dtype="float32")
    trees = [perturbed(jax.tree_util.tree_map(
        np.asarray, jregistry.init(jax.random.PRNGKey(i), cfg_j)), 100 + i)
        for i in range(ts.NODES)]
    port = serve.run(cfg_t, nodes=ts.NODES, requests=ts.REQUESTS,
                     max_new=ts.MAX_NEW, seed=ts.SEED, device="cpu",
                     mode=mode, verbose=False,
                     params_fn=lambda i, c, d: bridge.params_from_jax(
                         trees[i], c, d))
    orig = ts._jax_params
    ts._jax_params = lambda i, c: jax.tree_util.tree_map(jnp.asarray,
                                                         trees[i])
    try:
        ref = ts._reference_run(cfg_j, mode, False)
    finally:
        ts._jax_params = orig
    return cfg_t, ref, port


def test_same_assignment_balances_and_tokens(runs):
    cfg, ref, port = runs
    assert port["assigned"] == ref["assigned"]
    assert port["balances"] == ref["balances"]
    assert port["slo_attainment"] == ref["slo_attainment"]
    assert sum(len(v) for v in port["assigned"].values()) == ts.REQUESTS
    assert port["results"].keys() == ref["results"].keys()
    for rid, toks in ref["results"].items():
        np.testing.assert_array_equal(port["results"][rid], toks,
                                      err_msg=rid)


def test_same_engine_stats(runs):
    """The engines did the same work: prefill batches and tokens, decode
    steps and tokens; a moe or ssm node served waves (no resident
    slots)."""
    cfg, ref, port = runs
    for nid, st in ref["stats"].items():
        got = port["stats"][nid]
        for f in ("served", "batches", "prefill_tokens", "decode_steps",
                  "decode_tokens", "peak_resident"):
            assert getattr(got, f) == getattr(st, f), (nid, f)
        if cfg.family in ("moe", "ssm"):
            assert got.peak_resident == 0 and got.batches >= 1


def test_whisper_driver_raises_as_the_reference_does():
    """whisper-base on the driver: each node builds a wave engine, and the
    first wave's prefill, given tokens alone, raises ``KeyError(
    'encoder_embeds')`` in both packages."""
    torch.set_num_threads(2)
    cfg_j = jax_get_config("whisper-base").smoke().replace(dtype="float32")
    cfg_t = get_config("whisper-base").smoke().replace(dtype="float32")
    with pytest.raises(KeyError) as ej:
        ts._reference_run(cfg_j, "slot", False)
    with pytest.raises(KeyError) as et:
        serve.run(cfg_t, nodes=ts.NODES, requests=ts.REQUESTS,
                  max_new=ts.MAX_NEW, seed=ts.SEED, device="cpu",
                  mode="slot", verbose=False)
    assert et.value.args == ej.value.args == ("encoder_embeds",)
