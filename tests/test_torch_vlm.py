"""Port vlm family (qwen2-vl-7b: M-RoPE and embedding inputs) vs the JAX
package (CPU).

* ``common.apply_mrope`` against ``repro.models.common.apply_mrope`` with
  distinct (t, h, w) position ids, per row and per position, at the smoke
  and the full sections, and with broadcast ids (where it equals plain
  RoPE); sections that do not sum to D/2 are refused.
* ``dense.apply`` and ``dense.prefill`` on ``embeds`` with explicit,
  distinct positions, then slot decode steps from that cache, whose
  position the reference broadcasts to all three axes: logits and caches
  within 1e-4 (``tests/test_torch_dense.py``'s tolerance) of the
  reference's on the same perturbed, bridged weights in fp32.
* The serving driver's scenario (``python -m repro.launch.serve --arch
  qwen2-vl-7b`` with no flag, ``--paged``, ``--spec``, ``--kv-quant``) on
  both packages: the protocol's assignment, the credit balances and every
  request's greedy tokens must be the reference's.  ``driver_runs`` is
  shared with ``tests/test_torch_rglru.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_serve as ts
from repro.configs import get_config as jax_get_config
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import bridge, dense
from repro_torch.models import common as cm
from test_torch_dense_variants import both_params, perturbed

ATOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _positions(kind, b, s, seed):
    """(B, S, 3) int32 (t, h, w) ids: ``distinct`` draws each axis of each
    position on its own; ``image`` is a text run then a 2-D patch grid
    (t fixed, h and w over the grid) as Qwen2-VL lays an image out, per
    row offset; ``broadcast`` repeats arange(S) on all three axes."""
    rng = np.random.default_rng(seed)
    if kind == "distinct":
        return rng.integers(0, 4 * s, size=(b, s, 3)).astype(np.int32)
    if kind == "broadcast":
        return np.broadcast_to(np.arange(s, dtype=np.int32)[None, :, None],
                               (b, s, 3)).copy()
    pos = np.zeros((b, s, 3), np.int32)
    for i in range(b):
        text = 3 + i
        pos[i, :text] = np.arange(text)[:, None]
        for j in range(s - text):
            pos[i, text + j] = (text, text + j // 4, text + j % 4)
    return pos


@pytest.mark.parametrize("kind", ["distinct", "image", "broadcast"])
@pytest.mark.parametrize("d,sections", [(64, (8, 12, 12)),
                                        (128, (16, 24, 24))])
def test_apply_mrope_matches_reference(kind, d, sections):
    rng = np.random.default_rng(d)
    x = rng.standard_normal((2, 11, 3, d)).astype(np.float32)
    pos = _positions(kind, 2, 11, d)
    want = jcm.apply_mrope(jnp.asarray(x), jnp.asarray(pos), 1e6, sections)
    got = cm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                         sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    if kind == "broadcast":     # equal ids on every axis: plain RoPE
        rope = cm.apply_rope(torch.from_numpy(x),
                             torch.from_numpy(pos[..., 0]), 1e6)
        torch.testing.assert_close(got, rope)
    with pytest.raises(AssertionError, match="sum to head_dim/2"):
        cm.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos), 1e6,
                       (8, 8, 8))


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    return both_params("qwen2-vl-7b", 5)


def _embeds_batch(cfg, b, s, kind, seed):
    rng = np.random.default_rng(seed)
    x = (0.5 * rng.standard_normal((b, s, cfg.d_model))).astype(np.float32)
    pos = _positions(kind, b, s, seed)
    return ({"embeds": jnp.asarray(x), "positions": jnp.asarray(pos)},
            {"embeds": torch.from_numpy(x), "positions": torch.from_numpy(pos)})


@pytest.mark.parametrize("kind", ["distinct", "image"])
def test_apply_on_embeds_with_positions_matches_reference(model, kind):
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _embeds_batch(cfg_j, 2, 19, kind, 7)
    want = jdense.apply(pj, cfg_j, bj, q_chunk=32, kv_chunk=32)
    got = dense.apply(pt, cfg_t, bt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the positions matter: arange ids give other logits
    plain = dense.apply(pt, cfg_t, {"embeds": bt["embeds"]})
    assert float((plain - got).abs().max()) > 1e-2


def test_prefill_on_embeds_then_decode_matches_reference(model):
    """Prefill on embeddings at distinct (t, h, w) ids into a cache of
    capacity 32, then three slot decode steps, each at the scalar cache
    length broadcast to all three axes (as the reference does)."""
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _embeds_batch(cfg_j, 2, 21, "image", 9)
    lj, cj = jdense.prefill(pj, cfg_j, bj, q_chunk=32, kv_chunk=32,
                            capacity=32)
    lt, ct = dense.prefill(pt, cfg_t, bt, capacity=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=ATOL)
    assert int(ct["length"]) == int(cj["length"]) == 21
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(3):
        lj, cj = jdense.decode_step(pj, cfg_j, cj, jnp.asarray(tok))
        lt, ct = dense.decode_step(pt, cfg_t, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    assert int(ct["length"]) == 24


def driver_runs(arch, mode, quant=False):
    """The reference driver's scenario (``tests/test_torch_serve.py``'s
    ``_reference_run``) and ``repro_torch.launch.serve.run`` on ``mode``
    engines, both on the same perturbed (``perturbed``), bridged weights
    per node, and for spec on the same draft weights.  Returns (the port's
    config, the reference's result, the port's)."""
    cfg_j = jax_get_config(arch).smoke().replace(dtype="float32",
                                                 kv_quant=quant)
    cfg_t = get_config(arch).smoke().replace(dtype="float32", kv_quant=quant)
    trees = [perturbed(jax.tree_util.tree_map(
        np.asarray, jregistry.init(jax.random.PRNGKey(i), cfg_j)), 100 + i)
        for i in range(ts.NODES)]
    draft = jax.tree_util.tree_map(np.asarray, jregistry.init(
        jax.random.PRNGKey(ts.DRAFT_SEED), cfg_j.draft()))
    port = serve.run(cfg_t, nodes=ts.NODES, requests=ts.REQUESTS,
                     max_new=ts.MAX_NEW, seed=ts.SEED, device="cpu",
                     mode=mode, spec_k=ts.SPEC_K, verbose=False,
                     params_fn=lambda i, c, d: bridge.params_from_jax(
                         trees[i], c, d),
                     draft_params_fn=lambda c, d: bridge.params_from_jax(
                         draft, c, d))
    orig = ts._jax_params
    ts._jax_params = lambda i, c: jax.tree_util.tree_map(
        jnp.asarray, trees[i] if i < ts.NODES else draft)
    try:
        ref = ts._reference_run(cfg_j, mode, False)
    finally:
        ts._jax_params = orig
    return cfg_t, ref, port


@pytest.fixture(scope="module", params=["slot", "paged", "spec",
                                        "paged-int8"])
def runs(request):
    torch.set_num_threads(2)
    mode, _, quant = request.param.partition("-")
    return (mode,) + driver_runs("qwen2-vl-7b", mode, bool(quant))


def test_driver_scenario_matches_reference(runs):
    mode, cfg, ref, port = runs
    assert cfg.family == "vlm" and cfg.mrope
    assert port["assigned"] == ref["assigned"]
    assert port["balances"] == ref["balances"]
    assert port["slo_attainment"] == ref["slo_attainment"]
    assert port["results"].keys() == ref["results"].keys()
    for rid, toks in ref["results"].items():
        np.testing.assert_array_equal(port["results"][rid], toks,
                                      err_msg=rid)
    for nid, st in ref["stats"].items():
        got = port["stats"][nid]
        for f in ("served", "batches", "prefill_tokens", "decode_steps",
                  "decode_tokens", "peak_resident", "spec_drafted",
                  "spec_accepted"):
            assert getattr(got, f) == getattr(st, f), (mode, nid, f)
