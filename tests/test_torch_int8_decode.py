"""Row 2q's split axis on the CPU: int8 paged decode as the bf16 kernel
cuts it.

``paged_decode_quant_split_ref`` repeats the bf16 int8 paged decode
kernel's split-then-merge in plain PyTorch: the same int8 pools and bf16
scales (numpy inputs, fixed seeds, quantized by the port's
``kv_quantize``) go through it at several split counts, through
``paged_decode_quant_ref`` and through the JAX package's
``flash_paged_decode_tpu`` with ``k_scale``/``v_scale`` in interpret mode,
at fp32 2e-5 against the plain version and 3e-5 against the Pallas kernel
(the tolerance ``tests/test_kernels.py`` holds that kernel to its oracle).
Cases: the serve shape, a few long rows, ragged rows with a dead one on
pages that split boundaries cut, and rows of length 0 only.

The int8 kernel's own split target (``TARGET_BLOCKS_INT8``, about two
waves of its three blocks on each SM) keeps one split at every serve shape
and cuts long rows into splits of ``MIN_CHUNKS`` chunks or more.

A plain emulation of the kernel's arithmetic -- int8 values as they are,
the K scale folded into the scores, P times the V scale rounded to bf16
for the PV product, l over the unscaled P, split then merge -- must stay
within half the bf16 tolerance (1e-2) and half of ``SPLIT_REL`` of the
plain version, so that the kernel's own rounding leaves room for the card
checks to catch a fault.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_split import (CHUNK, MIN_CHUNKS, SPLIT_REL,
                                              TARGET_BLOCKS_INT8,
                                              decode_splits, head_scaled_err,
                                              split_ranges)
from repro_torch.kernels.ref import (_gather_pages, paged_decode_quant_ref,
                                     paged_decode_quant_split_ref)
from repro_torch.models.attention import _NEG_INF, _expand_kv, kv_quantize

ATOL = 2e-5          # fp32, split-then-merge against the plain version
ATOL_PALLAS = 3e-5   # fp32, against the Pallas kernel (tests/test_kernels.py)
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _int8_inputs(seed, b, h, hkv, d, page, lengths):
    """q, int8 pools and bf16 scale pools holding distinct pages per row,
    tables (entries past a row's allocation on the scratch page 0) and
    lengths."""
    rng = np.random.default_rng(seed)
    maxp = max(2, max(-(-ln // page) for ln in lengths) + 1)
    n_pool = 1 + sum(-(-ln // page) for ln in lengths)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), np.float32))
    kq, ks = kv_quantize(torch.from_numpy(
        rng.standard_normal((n_pool, page, hkv, d), np.float32)))
    vq, vs = kv_quantize(torch.from_numpy(
        rng.standard_normal((n_pool, page, hkv, d), np.float32)))
    bt = np.zeros((b, maxp), np.int32)
    free = list(range(1, n_pool))
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // page)):
            bt[i, j] = free.pop()
    return (q, kq, vq, ks, vs, torch.from_numpy(bt),
            torch.tensor(lengths, dtype=torch.int32))


# (b, h, hkv, d, page, lengths): the serve shape (rep 4, ~28 positions);
# a few long rows; ragged rows with a dead one on 48-position pages, whose
# edges the 64-position split boundaries cut; rows of length 0 only
CASES = {
    "main": (4, 8, 2, 64, 16, (28, 27, 28, 30)),
    "few long": (2, 8, 2, 64, 16, (300, 300)),
    "ragged": (3, 8, 2, 64, 48, (400, 150, 0)),
    "length 0": (2, 16, 1, 32, 16, (0, 0)),
}
SPLITS = (1, 2, 3, 7)


# (B, Hkv, n): qwen3-8b's int8 paged decode at max batch 4 (maxp * page =
# 32, 48, 64) and one row
@pytest.mark.parametrize("shape", [(4, 8, 32), (4, 8, 48), (4, 8, 64),
                                   (1, 8, 32)])
def test_int8_schedule_is_one_split_at_the_serve_shapes(shape):
    assert decode_splits(*shape, TARGET_BLOCKS_INT8) == 1


# (B, Hkv, n, splits): 32 long rows take 3 (768 blocks); fewer rows split
# down to MIN_CHUNKS chunks each
@pytest.mark.parametrize("shape", [(32, 8, 4112, 3), (2, 8, 4112, 13),
                                   (3, 8, 4352, 17), (8, 8, 4096, 11),
                                   (32, 8, 2048, 3), (1, 8, 32768, 86)])
def test_int8_schedule_cuts_long_rows_toward_its_target(shape):
    b, hkv, n, want = shape
    splits = decode_splits(b, hkv, n, TARGET_BLOCKS_INT8)
    assert splits == want
    assert b * hkv * splits <= 1.25 * TARGET_BLOCKS_INT8
    sizes = [e - s for s, e in split_ranges(n, splits)]
    assert min(sizes[:-1]) >= MIN_CHUNKS * CHUNK and sizes[-1] > 0


@pytest.mark.parametrize("name", list(CASES))
def test_quant_split_ref_matches_quant_ref_and_jax_kernel(name):
    import jax.numpy as jnp
    from repro.kernels.paged_decode import flash_paged_decode_tpu
    b, h, hkv, d, page, lengths = CASES[name]
    q, kq, vq, ks, vs, bt, ln = _int8_inputs(sum(lengths) + b, *CASES[name])
    plain = paged_decode_quant_ref(q, kq, vq, ks, vs, bt, ln)
    pallas = np.asarray(flash_paged_decode_tpu(
        jnp.asarray(q.numpy()), jnp.asarray(kq.numpy()),
        jnp.asarray(vq.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray(ln.numpy()),
        k_scale=jnp.asarray(ks.float().numpy()).astype(jnp.bfloat16),
        v_scale=jnp.asarray(vs.float().numpy()).astype(jnp.bfloat16),
        interpret=True), np.float32)
    np.testing.assert_allclose(plain.numpy(), pallas, atol=ATOL_PALLAS,
                               rtol=0)
    for splits in SPLITS + (None,):
        got = paged_decode_quant_split_ref(q, kq, vq, ks, vs, bt, ln,
                                           splits=splits)
        assert got.dtype == torch.float32
        assert tuple(got.shape) == (b, 1, h, d)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=ATOL,
                                   rtol=0, err_msg=f"{splits} splits")
        np.testing.assert_allclose(got.numpy(), pallas, atol=ATOL_PALLAS,
                                   rtol=0, err_msg=f"{splits} splits")


def test_quant_split_ref_in_bf16_matches_quant_ref():
    b, h, hkv, d, page, lengths = CASES["ragged"]
    q, kq, vq, ks, vs, bt, ln = _int8_inputs(5, *CASES["ragged"])
    qb = q.bfloat16()
    plain = paged_decode_quant_ref(qb, kq, vq, ks, vs, bt, ln)
    for splits in SPLITS:
        got = paged_decode_quant_split_ref(qb, kq, vq, ks, vs, bt, ln,
                                           splits=splits)
        assert got.dtype == torch.bfloat16
        np.testing.assert_allclose(got.float().numpy(),
                                   plain.float().numpy(), atol=BF16_TOL,
                                   rtol=0)


def _kernel_emulation(q, kq, vq, ks, vs, bt, ln, splits):
    """The bf16 kernel's arithmetic in plain PyTorch: scores of q (bf16)
    against the int8 values times the K scale and the softmax scale; per
    split its max m, p = exp(s - m), l = sum p, and acc = bf16(p x V
    scale) . int8 V; the splits merged as the merge kernel does; bf16
    out.  A dead row walks every position at -1e30."""
    b, _, h, d = q.shape
    n = bt.shape[1] * kq.shape[1]
    kg = _expand_kv(_gather_pages(kq, bt).float(), h)         # (B, n, H, D)
    vg = _expand_kv(_gather_pages(vq, bt).float(), h)
    ksg = _expand_kv(_gather_pages(ks, bt).float(), h)[..., 0]  # (B, n, H)
    vsg = _expand_kv(_gather_pages(vs, bt).float(), h)[..., 0]
    s = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kg)
    s = s * ksg.transpose(1, 2) * d ** -0.5
    pos = torch.arange(n)[None, :]
    lens = ln.reshape(-1, 1)
    dead = lens <= 0
    walk = torch.where(dead, pos < n, pos < lens)
    s = torch.where(dead[:, :, None], torch.full_like(s, _NEG_INF), s)
    s = torch.where(walk[:, None, :], s, torch.full_like(s, -float("inf")))
    ms, ls, accs = [], [], []
    for s0, s1 in split_ranges(n, splits):
        xs = s[..., s0:s1]
        m = torch.full(xs.shape[:2], _NEG_INF)
        if s1 > s0:
            m = torch.maximum(m, xs.amax(dim=-1))
        p = torch.exp(xs - m[..., None])
        pv = (p * vsg.transpose(1, 2)[..., s0:s1]).bfloat16().float()
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", pv, vg[:, s0:s1]))
    m = torch.stack(ms)
    f = torch.exp(m - m.amax(dim=0))
    l_sum = (f * torch.stack(ls)).sum(dim=0).clamp(min=1e-30)
    out = (f[..., None] * torch.stack(accs)).sum(dim=0) / l_sum[..., None]
    return out[:, None].bfloat16()


# (b, h, hkv, d, page, lengths): the card's few long and ragged cases at
# the qwen3-8b heads, cut to CPU size, and the serve shape
EMULATED = [
    (2, 32, 8, 128, 16, (1024, 1024)),
    (3, 32, 8, 128, 256, (1024, 700, 0)),
    (4, 32, 8, 128, 16, (28, 1, 40, 0)),
]


@pytest.mark.parametrize("case", EMULATED)
def test_kernel_arithmetic_stays_within_half_the_limits(case):
    b, h, hkv, d, page, lengths = case
    q, kq, vq, ks, vs, bt, ln = _int8_inputs(sum(lengths) + 7, *case)
    qb = q.bfloat16()
    want = paged_decode_quant_ref(qb, kq, vq, ks, vs, bt, ln)
    n = bt.shape[1] * page
    for splits in sorted({1, 4, decode_splits(b, hkv, n, TARGET_BLOCKS_INT8)}):
        got = _kernel_emulation(qb, kq, vq, ks, vs, bt, ln, splits)
        err = (got.float() - want.float()).abs().max().item()
        assert err <= BF16_TOL / 2, (splits, err)
        assert head_scaled_err(got, want) <= SPLIT_REL / 2, splits
