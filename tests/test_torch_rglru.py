"""Port hybrid family (recurrentgemma-9b: RG-LRU and local attention) vs
the JAX package (CPU), and the plain attention at its head width.

* The RG-LRU pieces (``_causal_conv``, ``rglru_scan`` with and without an
  incoming state, ``rglru_step``) against ``repro.models.rglru``'s; the
  associative scan and its plain version, the loop over time, against
  the reference's at T = 1, 2, 7, 64 and 100 within 1e-6 of max|h|.
* ``apply``, and ``prefill`` then lock-step ``decode_step``, on the same
  perturbed, bridged weights in fp32 (1e-4, ``tests/test_torch_dense.py``'s
  tolerance), at the smoke config with five layers (one (rec, rec, attn)
  group and the two-layer recurrent tail): the caches too, in both ring
  branches (a prompt shorter than the 64-position smoke window, zero
  padded, and one longer, rolled), decoding past the window so that the
  ring wraps; and prefill-then-decode against ``apply`` over the whole
  sequence, as the reference's own test does.
* The serving driver's scenario (``--arch recurrentgemma-9b``: the engines
  serve left-padded waves), ``Engine.logprob_of`` and ``apply_with_aux``,
  and the backends the reference refuses for the family (paged, spec,
  int8 pages, disagg) with its ``ValueError``.
* The plain prefill and decode attention (``flash_ref``, ``decode_ref``)
  at D=256, 16 query heads a kv head, with a window, against the Pallas
  kernels in interpret mode and the jnp oracles (fp32 2e-5, bf16 2e-2, as
  ``tests/test_kernels.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import rglru as jrglru
from repro.serving import Engine as JEngine
from repro_torch.kernels.ref import decode_ref, flash_ref
from repro_torch.launch import serve
from repro_torch.models import registry, rglru
from repro_torch.serving import Engine
from test_torch_dense_variants import both_params
from test_torch_vlm import driver_runs

# the reference's functions, compiled once per config and shape
_J_APPLY = jax.jit(functools.partial(jrglru.apply, q_chunk=32, kv_chunk=32),
                   static_argnums=1)
_J_PREFILL = jax.jit(functools.partial(jrglru.prefill, q_chunk=32,
                                       kv_chunk=32),
                     static_argnums=(1,), static_argnames=("capacity",))
_J_DECODE = jax.jit(jrglru.decode_step, static_argnums=1)

ATOL = 1e-4
KERNEL_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg_j, cfg_t, pj, pt = both_params("recurrentgemma-9b", 6, n_layers=5)
    assert rglru.group_structure(cfg_t) == (1, ("rec", "rec"))
    assert cfg_t.local_window == 64 and cfg_t.head_dim == 64
    return cfg_j, cfg_t, pj, pt


def _rec_params(seed, w):
    rng = np.random.default_rng(seed)
    rp = {"w_a": rng.standard_normal((w, w)) * 0.5 / w ** 0.5,
          "w_i": rng.standard_normal((w, w)) * 0.5 / w ** 0.5,
          "lam": rng.uniform(0.5, 2.0, (w,))}
    rp = {k: v.astype(np.float32) for k, v in rp.items()}
    return ({k: jnp.asarray(v) for k, v in rp.items()},
            {k: torch.from_numpy(v) for k, v in rp.items()})


def test_causal_conv_matches_reference():
    rng = np.random.default_rng(0)
    u = rng.standard_normal((2, 9, 16)).astype(np.float32)
    w = rng.standard_normal((4, 16)).astype(np.float32)
    b = rng.standard_normal((16,)).astype(np.float32)
    want = jrglru._causal_conv(*(jnp.asarray(x) for x in (u, w, b)))
    got = rglru._causal_conv(*(torch.from_numpy(x) for x in (u, w, b)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_matches_reference(with_h0):
    rpj, rpt = _rec_params(1, 32)
    rng = np.random.default_rng(2)
    u = rng.standard_normal((3, 40, 32)).astype(np.float32)
    h0 = rng.standard_normal((3, 32)).astype(np.float32) if with_h0 else None
    hj, lastj = jrglru.rglru_scan(rpj, jnp.asarray(u),
                                  None if h0 is None else jnp.asarray(h0))
    ht, lastt = rglru.rglru_scan(rpt, torch.from_numpy(u),
                                 None if h0 is None else torch.from_numpy(h0))
    assert lastt.dtype == torch.float32
    np.testing.assert_allclose(ht.numpy(), np.asarray(hj), atol=1e-5)
    np.testing.assert_allclose(lastt.numpy(), np.asarray(lastj), atol=1e-5)


@pytest.mark.parametrize("t", [1, 2, 7, 64, 100])
@pytest.mark.parametrize("with_h0", [False, True])
def test_associative_scan_matches_reference_and_the_loop(t, with_h0):
    """``rglru_scan``'s odd-even recursion, odd and even lengths alike,
    against the reference's ``jax.lax.associative_scan`` and against the
    port's sequential loop (``rglru_scan_sequential``), within 1e-6 of
    max|h|."""
    rpj, rpt = _rec_params(5, 32)
    rng = np.random.default_rng(t)
    u = rng.standard_normal((2, t, 32)).astype(np.float32)
    h0 = rng.standard_normal((2, 32)).astype(np.float32) if with_h0 else None
    hj, lastj = jrglru.rglru_scan(rpj, jnp.asarray(u),
                                  None if h0 is None else jnp.asarray(h0))
    scale = float(np.abs(np.asarray(hj)).max())
    ut = torch.from_numpy(u)
    h0t = None if h0 is None else torch.from_numpy(h0)
    for fn in (rglru.rglru_scan, rglru.rglru_scan_sequential):
        ht, lastt = fn(rpt, ut, h0t)
        assert ht.dtype == torch.float32 == lastt.dtype
        assert tuple(ht.shape) == (2, t, 32)
        assert float(np.abs(ht.numpy() - np.asarray(hj)).max()) <= \
            1e-6 * scale, fn.__name__
        assert float(np.abs(lastt.numpy() - np.asarray(lastj)).max()) <= \
            1e-6 * scale, fn.__name__


def test_rglru_step_matches_reference_and_the_scan():
    rpj, rpt = _rec_params(3, 32)
    rng = np.random.default_rng(4)
    u = rng.standard_normal((2, 1, 32)).astype(np.float32)
    h = rng.standard_normal((2, 32)).astype(np.float32)
    want = jrglru.rglru_step(rpj, jnp.asarray(u), jnp.asarray(h))
    got = rglru.rglru_step(rpt, torch.from_numpy(u), torch.from_numpy(h))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    _, last = rglru.rglru_scan(rpt, torch.from_numpy(u), torch.from_numpy(h))
    torch.testing.assert_close(got, last)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s)) \
        .astype(np.int32)


def test_apply_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(5, 2, 90, cfg_j.vocab_size)     # past the window
    want = _J_APPLY(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    got = registry.apply_logits(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _, aux = registry.apply_with_aux(pt, cfg_t,
                                     {"tokens": torch.from_numpy(toks)})
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def _caches_close(ct, cj):
    for blk, st in cj["groups"].items():
        for name, a in st.items():
            np.testing.assert_allclose(ct["groups"][blk][name].numpy(),
                                       np.asarray(a), atol=ATOL,
                                       err_msg=f"groups.{blk}.{name}")
    for i, st in enumerate(cj["tail"]):
        for name, a in st.items():
            np.testing.assert_allclose(ct["tail"][i][name].numpy(),
                                       np.asarray(a), atol=ATOL,
                                       err_msg=f"tail.{i}.{name}")
    assert int(ct["length"]) == int(cj["length"])


@pytest.mark.parametrize("plen,capacity", [(40, 96), (150, 192), (40, 48)],
                         ids=["short-padded", "long-rolled", "ring-of-cap"])
def test_prefill_and_decode_match_reference_in_both_ring_branches(
        model, plen, capacity):
    """The ring is ``min(window, capacity)`` positions: zero-padded past a
    short prompt, the last ``win`` positions rolled for a long one (and a
    capacity under the window makes the ring the capacity).  26 decode
    steps then wrap it."""
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(plen, 2, plen, cfg_j.vocab_size)
    lj, cj = _J_PREFILL(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                        capacity=capacity)
    lt, ct = rglru.prefill(pt, cfg_t, torch.from_numpy(toks),
                           capacity=capacity)
    win = min(cfg_t.local_window, capacity)
    assert ct["groups"]["blk2"]["k"].shape[2] == win
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    _caches_close(ct, cj)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(26):
        lj, cj = _J_DECODE(pj, cfg_j, cj, jnp.asarray(tok))
        lt, ct = rglru.decode_step(pt, cfg_t, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    _caches_close(ct, cj)


def test_prefill_then_decode_matches_apply(model):
    """As ``tests/test_models.py``'s prefill/decode check: one decode step
    after a prefill equals the full-sequence forward's last position."""
    _, cfg, _, pt = model
    toks = torch.from_numpy(_tokens(8, 2, 64, cfg.vocab_size)).long()
    lg, cache = rglru.prefill(pt, cfg, toks, capacity=96)
    nt = torch.argmax(lg, -1)
    lg2, _ = rglru.decode_step(pt, cfg, cache, nt)
    full = rglru.apply(pt, cfg, {"tokens": torch.cat([toks, nt], dim=1)})
    np.testing.assert_allclose(lg2.numpy(), full[:, -1:].numpy(), atol=2e-4,
                               rtol=2e-3)


def test_driver_scenario_matches_reference():
    cfg, ref, port = driver_runs("recurrentgemma-9b", "slot")
    assert cfg.family == "hybrid"
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
                  "decode_tokens", "peak_resident"):
            assert getattr(got, f) == getattr(st, f), (nid, f)
        assert got.peak_resident == 0 and got.batches >= 1   # waves


def test_logprob_of_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(9, 1, 100, cfg_j.vocab_size)[0]
    want = JEngine(cfg_j, pj, max_batch=2, bucket=32).logprob_of(toks)
    eng = Engine(cfg_t, pt, max_batch=2, bucket=32)
    assert not eng.slot_decode
    got = eng.logprob_of(toks)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_refused_backends_raise_as_the_reference_does(model):
    """Paged, speculative and int8-page engines need paged KV, which the
    family lacks: both packages raise the same ``ValueError``; the
    driver's ``--disagg`` builds paged engines and raises it too."""
    cfg_j, cfg_t, pj, pt = model
    for kw_j, kw_t, cj, ct in (
            (dict(paged=True), dict(paged=True), cfg_j, cfg_t),
            (dict(paged=True, spec_draft=(cfg_j.draft(), pj)),
             dict(paged=True, spec_draft=(cfg_t.draft(), pt)), cfg_j, cfg_t),
            (dict(paged=True), dict(paged=True),
             cfg_j.replace(kv_quant=True), cfg_t.replace(kv_quant=True))):
        with pytest.raises(ValueError) as ej:
            JEngine(cj, pj, **kw_j)
        with pytest.raises(ValueError) as et:
            Engine(ct, pt, **kw_t)
        assert str(et.value) == str(ej.value)
    with pytest.raises(ValueError) as ed:
        serve.run(cfg_t, nodes=1, requests=1, device="cpu", mode="disagg",
                  verbose=False, params_fn=lambda i, c, d: pt)
    assert str(ed.value) == str(ej.value)


def _attn_inputs(seed, shapes, dt):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    return ([jnp.asarray(a).astype(dt) for a in arrs],
            [torch.from_numpy(a).to(TORCH_DT[dt]) for a in arrs])


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_ref_at_d256_matches_jax_kernel_and_oracle(dt):
    from repro.kernels.flash_attention import flash_attention_tpu
    from repro.models.attention import reference_attention
    b, s, h, hkv, d, win = 1, 160, 16, 1, 256, 48
    (jq, jk, jv), (q, k, v) = _attn_inputs(
        11, [(b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)], dt)
    pallas = flash_attention_tpu(jq, jk, jv, causal=True, window=win,
                                 block_q=64, block_k=64, interpret=True)
    oracle = reference_attention(jq, jk, jv, causal=True, window=win)
    got = flash_ref(q, k, v, causal=True, window=win)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, s, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=KERNEL_ATOL[dt], rtol=1e-2)


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_ref_at_d256_matches_jax_kernel_and_oracle(dt):
    from repro.kernels.flash_decode import flash_decode_tpu
    from repro.kernels.ref import decode_ref as jax_decode_ref
    b, s, h, hkv, d, clen, win = 2, 192, 16, 1, 256, 150, 64
    (jq, jk, jv), (q, kc, vc) = _attn_inputs(
        12, [(b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d)], dt)
    cl = jnp.asarray(clen, jnp.int32)
    pallas = flash_decode_tpu(jq, jk, jv, cl, window=win, block_k=64,
                              interpret=True)
    oracle = jax_decode_ref(jq, jk, jv, cl, window=win)
    got = decode_ref(q, kc, vc, torch.full((b,), clen, dtype=torch.int32),
                     window=win)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, 1, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want.astype(jnp.float32)),
                                   atol=KERNEL_ATOL[dt], rtol=1e-2)
