"""Port int8 KV (``cfg.kv_quant``) vs the JAX package (CPU).

* The codec: ``kv_quantize`` / ``kv_dequantize`` give the reference's int8
  values and bf16 scales bit for bit on the same fp32 inputs.
* Rows 2q and 3q: the plain versions ``paged_decode_quant_ref`` /
  ``paged_verify_quant_ref`` against the Pallas kernels with
  ``k_scale``/``v_scale`` in interpret mode and the jnp oracles, on the
  sweeps of ``tests/test_kernels.py`` at its tolerances (fp32 2e-5, bf16
  2e-2 absolute).
* The dense model's int8 prefill, slot decode, paged decode and paged
  verify against ``repro.models.dense`` on bridged weights (fp32).

The int8 engines are held to the JAX engines in
``tests/test_torch_quant_engine.py``, and the serving driver's
``--kv-quant`` and ``--spec --kv-quant`` scenarios to the reference's in
``tests/test_torch_serve.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import dense as jdense
from repro.models import registry as jregistry
from repro.models.attention import kv_dequantize as jax_dequantize
from repro.models.attention import kv_quantize as jax_quantize
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (paged_decode_quant_ref,
                                     paged_verify_quant_ref)
from repro_torch.models import bridge, dense
from repro_torch.models.attention import kv_dequantize, kv_quantize

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# tests/test_kernels.py's PAGED_SWEEP (b, h, hkv, d, page, lengths) and
# VERIFY_SWEEP (b, kq, h, hkv, d, page, lengths)
PAGED_SWEEP = [
    (2, 4, 2, 64, 16, (40, 25)),
    (3, 8, 2, 64, 32, (64, 1, 90)),
    (1, 4, 1, 128, 16, (47,)),
    (2, 4, 4, 32, 8, (0, 30)),
]
VERIFY_SWEEP = [
    (2, 4, 4, 2, 64, 16, (40, 25)),
    (1, 3, 4, 1, 128, 16, (47,)),
    (3, 2, 8, 2, 64, 32, (64, 1, 90)),
    (2, 5, 4, 4, 32, 8, (0, 30)),
]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32",
                                                       kv_quant=True)
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32",
                                                   kv_quant=True)
    pj = jregistry.init(jax.random.PRNGKey(4), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _t(x, dt="float32"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(TORCH_DT[dt])


# ------------------------------------------------------------------ codec
@pytest.mark.parametrize("scale", [1e-12, 1e-3, 1.0, 300.0])
def test_kv_codec_is_bit_equal_to_the_reference(scale):
    """Same int8 values and bf16 scales, and the same dequantized values
    in fp32 and bf16; a zero vector takes the 1e-8 floor."""
    rng = np.random.default_rng(int(np.log10(scale) + 20))
    x = (rng.standard_normal((6, 37, 4, 128)) * scale).astype(np.float32)
    x[0, 0, 0] = 0.0
    x[1, 2, 3, :5] = scale * 127 / 2 * np.arange(5)   # ties at .5 steps
    qj, sj = jax_quantize(jnp.asarray(x))
    qt, st = kv_quantize(torch.from_numpy(x))
    assert qt.dtype == torch.int8 and st.dtype == torch.bfloat16
    assert tuple(st.shape) == x.shape[:-1] + (1,)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
    np.testing.assert_array_equal(st.float().numpy(),
                                  np.asarray(sj.astype(jnp.float32)))
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        np.testing.assert_array_equal(
            kv_dequantize(qt, st, tdt).float().numpy(),
            np.asarray(jax_dequantize(qj, sj, jdt).astype(jnp.float32)))


# ------------------------------------------------------- rows 2q and 3q
def _quant_pools(rng, n_pool, page, hkv, d):
    out = []
    for _ in range(2):
        p = rng.standard_normal((n_pool, page, hkv, d)).astype(np.float32)
        q, s = jax_quantize(jnp.asarray(p))
        out.append((np.array(q), np.array(s)))
    return out


def _tables(lengths, page, extra=0):
    alloc = [-(-(ln + extra) // page) for ln in lengths]
    maxp = max(2, max(alloc) + 1)
    bt = np.zeros((len(lengths), maxp), np.int32)
    free = list(range(1, 1 + sum(alloc)))
    for i, a in enumerate(alloc):
        for j in range(a):
            bt[i, j] = free.pop()
    return bt, 1 + sum(alloc)


def _run_quant(verify, case, dt, kq):
    """The int8 plain version (verify or decode) against the Pallas kernel
    with scales in interpret mode and the jnp oracle, on the same int8
    pools and bf16 scales."""
    from repro.kernels import ref as jref
    from repro.kernels.paged_decode import flash_paged_decode_tpu
    from repro.kernels.spec_verify import flash_paged_verify_tpu
    b, h, hkv, d, page, lengths = case
    rng = np.random.default_rng(sum(lengths) + b + kq + d)
    bt, n_pool = _tables(lengths, page, extra=kq if verify else 0)
    (kq_, ks_), (vq_, vs_) = _quant_pools(rng, n_pool, page, hkv, d)
    q = rng.standard_normal((b, kq, h, d)).astype(np.float32)
    ln = np.asarray(lengths, np.int32)
    jargs = (jnp.asarray(q).astype(dt), jnp.asarray(kq_), jnp.asarray(vq_))
    jtab = (jnp.asarray(bt), jnp.asarray(ln))
    jsc = (jnp.asarray(ks_), jnp.asarray(vs_))
    kernel = flash_paged_verify_tpu if verify else flash_paged_decode_tpu
    oracle = (jref.paged_verify_quant_ref if verify
              else jref.paged_decode_quant_ref)
    plain = paged_verify_quant_ref if verify else paged_decode_quant_ref
    wants = (kernel(*jargs, *jtab, k_scale=jsc[0], v_scale=jsc[1],
                    interpret=True),
             oracle(*jargs, *jsc, *jtab))
    got = plain(_t(q, dt), torch.from_numpy(kq_), torch.from_numpy(vq_),
                torch.from_numpy(ks_.astype(np.float32)).bfloat16(),
                torch.from_numpy(vs_.astype(np.float32)).bfloat16(),
                torch.from_numpy(bt), torch.from_numpy(ln))
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == q.shape
    for want in wants:
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   atol=ATOL[dt], rtol=1e-2)


@pytest.mark.parametrize("case", PAGED_SWEEP)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_decode_quant_ref_matches_jax_kernel(case, dt):
    _run_quant(False, case, dt, 1)


@pytest.mark.parametrize("case", VERIFY_SWEEP)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_verify_quant_ref_matches_jax_kernel(case, dt):
    b, kq, h, hkv, d, page, lengths = case
    _run_quant(True, (b, h, hkv, d, page, lengths), dt, kq)


def test_ops_quant_entry_points_take_the_plain_versions_on_cpu():
    """A CPU tensor goes to the plain version and launches nothing; K=1
    verify is decode at lengths + 1; the counters list both int8
    kernels."""
    ops.reset_launch_counts()
    rng = np.random.default_rng(3)
    bt, n_pool = _tables((9, 0, 30), 8, extra=1)
    (kq_, ks_), (vq_, vs_) = _quant_pools(rng, n_pool, 8, 2, 64)
    pools = (torch.from_numpy(kq_), torch.from_numpy(vq_),
             torch.from_numpy(ks_.astype(np.float32)).bfloat16(),
             torch.from_numpy(vs_.astype(np.float32)).bfloat16())
    q = _t(rng.standard_normal((3, 1, 4, 64)).astype(np.float32))
    ln = torch.tensor([9, 0, 30], dtype=torch.int32)
    dec = ops.paged_decode_quant(q, *pools, torch.from_numpy(bt), ln + 1)
    ver = ops.paged_verify_quant(q, *pools, torch.from_numpy(bt), ln)
    torch.testing.assert_close(ver, dec, atol=1e-6, rtol=0)
    counts = ops.launch_counts()
    assert {"paged_decode_int8", "paged_verify_int8"} <= set(counts)
    assert not any(counts.values())


# ----------------------------------------------------------- dense model
def _prompts(rng, lens, plen, vocab, eos):
    toks = np.full((len(lens), plen), eos, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, vocab, size=n)
    return toks, np.asarray([n - 1 for n in lens], np.int32)


def _prefill_both(model, seed, lens, plen, capacity):
    cfg_j, cfg_t, pj, pt = model
    toks, last = _prompts(np.random.default_rng(seed), lens, plen,
                          cfg_j.vocab_size, cfg_j.eos_id)
    lj, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                            capacity=capacity,
                            last_positions=jnp.asarray(last))
    lt, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                           capacity=capacity,
                           last_positions=torch.from_numpy(last))
    return lj, cj, lt, ct


def _deq(c, name):
    """A cache's dequantized fp32 values (numpy), JAX or torch."""
    if isinstance(c[name], torch.Tensor):
        return kv_dequantize(c[name], c[name + "_scale"],
                             torch.float32).numpy()
    return np.asarray(jax_dequantize(c[name], c[name + "_scale"],
                                     jnp.float32))


# The fp32 projections of the two packages differ by ~1e-6, so a value
# within that of a rounding boundary may quantize one int8 step apart: the
# caches are held to one quantization step (max|x| / 127 of the vector),
# and logits to 1e-3 absolute (one flipped step moves a logit by ~1e-4 at
# these widths).
LOGIT_ATOL = 1e-3


def _assert_caches_close(ct, cj, names=("k", "v")):
    for name in names:
        a, b = _deq(ct, name), _deq(cj, name)
        step = np.asarray(cj[name + "_scale"], np.float32)
        assert np.all(np.abs(a - b) <= step * 1.0001 + 1e-7), name
        agree = np.mean(ct[name].numpy() == np.asarray(cj[name]))
        assert agree > 0.999, (name, agree)


def test_int8_prefill_matches_reference(model):
    lj, cj, lt, ct = _prefill_both(model, 0, (20, 9, 32), 32, 48)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    for name in ("k", "v", "k_scale", "v_scale"):
        assert tuple(ct[name].shape) == tuple(cj[name].shape), name
        assert str(ct[name].dtype).split(".")[-1] == str(cj[name].dtype)
    _assert_caches_close(ct, cj)
    empty = dense.init_cache(model[1], 3, 48)
    assert {n: (tuple(a.shape), a.dtype) for n, a in empty.items()
            if n != "length"} == {n: (tuple(ct[n].shape), ct[n].dtype)
                                  for n in ("k", "v", "k_scale", "v_scale")}


def test_int8_slot_decode_steps_match(model):
    cfg_j, cfg_t, pj, pt = model
    _, cj, _, ct = _prefill_both(model, 2, (20, 9, 32), 32, 48)
    lens = np.asarray([20, 9, 0], np.int32)
    names = ("k", "v", "k_scale", "v_scale")
    cache_j = {**{n: cj[n] for n in names}, "length": jnp.asarray(lens)}
    cache_t = {**{n: ct[n].clone() for n in names},
               "length": torch.from_numpy(lens)}
    rng = np.random.default_rng(2)
    for step in range(4):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = jdense.decode_step(pj, cfg_j, cache_j, jnp.asarray(tok))
        lt, cache_t = dense.decode_step(pt, cfg_t, cache_t,
                                        torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj),
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_t["length"].numpy(),
                                      np.asarray(cache_j["length"]))
    _assert_caches_close(cache_t, cache_j)


def _paged_both(model, seed, phys, n_pages, page):
    cfg_j, cfg_t, _, _ = model
    _, cj, _, ct = _prefill_both(model, seed, (20, 9), 32, 32)
    names = ("k", "v", "k_scale", "v_scale")
    pools_j = jdense.prefill_to_pages(
        jdense.init_paged_pools(cfg_j, n_pages, page),
        {n: cj[n] for n in names}, jnp.asarray(phys))
    pools_t = dense.prefill_to_pages(
        dense.init_paged_pools(cfg_t, n_pages, page), ct,
        torch.from_numpy(phys))
    return pools_j, pools_t


def _assert_pools_close(pools_t, pools_j, pages):
    as_cache = {}
    for src, pools in (("t", pools_t), ("j", pools_j)):
        as_cache[src] = {
            name: pools[f"{name}_pool"][:, pages] for name in (
                "k", "v", "k_scale", "v_scale")}
    _assert_caches_close(as_cache["t"], as_cache["j"])


def test_int8_paged_decode_steps_match(model):
    """Int8 pools (scale pools beside them), a length-0 rider on the
    scratch page: the prefill cache is scattered as it is, the new tokens
    quantized on write, and the logits and pages agree."""
    cfg_j, cfg_t, pj, pt = model
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j, pools_t = _paged_both(model, 1, phys, 8, 16)
    assert pools_t["k_pool"].dtype == torch.int8
    assert tuple(pools_t["k_scale_pool"].shape) == tuple(
        pools_j["k_scale_pool"].shape)
    bt = np.asarray([[1, 2, 4, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
               "lengths": jnp.asarray(lens)}
    cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
               "lengths": torch.from_numpy(lens)}
    rng = np.random.default_rng(1)
    for step in range(4):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = jdense.paged_decode_step(pj, cfg_j, cache_j,
                                               jnp.asarray(tok))
        lt, cache_t = dense.paged_decode_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
    _assert_pools_close(cache_t, cache_j, [1, 2, 3, 4])


def test_int8_paged_verify_steps_match(model):
    """Two K=5 verify steps over int8 pools with a rider whose lengths + K
    pass its table."""
    cfg_j, cfg_t, pj, pt = model
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j, pools_t = _paged_both(model, 5, phys, 8, 16)
    bt = np.asarray([[1, 2, 4], [3, 5, 0], [0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 44], np.int32)
    rng = np.random.default_rng(5)
    for step in range(2):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 5)).astype(np.int32)
        cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
                   "lengths": jnp.asarray(lens)}
        cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
                   "lengths": torch.from_numpy(lens)}
        lj, cache_j = jdense.paged_verify_step(pj, cfg_j, cache_j,
                                               jnp.asarray(tok))
        lt, cache_t = dense.paged_verify_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        pools_j = {n: cache_j[n] for n in ("k_pool", "v_pool",
                                           "k_scale_pool", "v_scale_pool")}
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   atol=LOGIT_ATOL, err_msg=f"step {step}")
        lens = lens + np.asarray([2, 1, 0], np.int32)
    _assert_pools_close(pools_t, pools_j, [1, 2, 3, 4, 5])
