"""Port kernels of the slot and speculative paths: contiguous decode and
paged multi-token verify (any K: the kernel tiles the query rows), the
int8-page forms of paged decode (split rows in bf16, and the trap on a bad
table entry) and verify, plus the prefill kernel at the draft's width.

CPU cases hand the same numpy inputs (fixed seeds) to the port's plain
versions (``decode_ref``, ``paged_verify_ref``) and to the JAX package's
Pallas kernels in interpret mode (``flash_decode_tpu``,
``flash_paged_verify_tpu``) and jnp oracles, at the tolerances of
``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2 absolute).

``gpu`` cases hold each CUDA kernel against its plain version on the card
(fp32 1e-4: the card sums in another order; bf16 2e-2; the int8 kernels
against ``paged_decode_quant_ref`` / ``paged_verify_quant_ref`` on the
same int8 pages) and skip without a card.  JAX is imported inside the CPU cases only:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_decode_kernels.py
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, flash_decode, ops, paged_decode
from repro_torch.kernels.decode_split import (SPLIT_REL, TARGET_BLOCKS_INT8,
                                              decode_splits, head_scaled_err,
                                              target_blocks)
from repro_torch.kernels.ref import (decode_ref, flash_ref, paged_decode_ref,
                                     paged_decode_quant_ref,
                                     paged_verify_quant_ref, paged_verify_ref,
                                     verify_ref)
from repro_torch.models.attention import kv_quantize

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
CUDA_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# test_kernels.py's DECODE_SWEEP: (b, s, h, hkv, d, cache_len, window, bk)
DECODE_SWEEP = [
    (1, 512, 4, 4, 64, 512, None, 128),
    (2, 1024, 8, 2, 64, 700, None, 256),
    (4, 256, 4, 1, 128, 256, None, 64),
    (1, 300, 4, 2, 64, 123, None, 128),
    (2, 512, 8, 2, 64, 400, 128, 128),
]

# (b, kq, h, hkv, d, page, lengths, table_pages): K in {1, 3, 5}, MQA and
# GQA, an empty-prefix row; table_pages=None gives each row pages for
# lengths + K, an int cuts the table there (a rider whose lengths + K
# passes it)
VERIFY_CASES = [
    (2, 1, 4, 2, 64, 16, (40, 25), None),
    (1, 3, 4, 1, 128, 16, (47,), None),
    (3, 5, 8, 2, 64, 32, (64, 1, 90), None),
    (2, 5, 4, 4, 32, 8, (0, 30), None),
    (2, 5, 8, 2, 64, 16, (29, 3), 2),
]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _t(x, dt, device="cpu"):
    return torch.from_numpy(np.ascontiguousarray(x)).to(
        device=device, dtype=TORCH_DT[dt])


def _np(x):
    return np.asarray(x.float().cpu().numpy())


def _decode_inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32))


def _verify_inputs(seed, b, kq, h, hkv, d, page, lengths, table_pages):
    """Random pools and block tables with distinct pages per row covering
    ``lengths + K`` positions (cut at ``table_pages`` if given); entries
    past a row's allocation point at the scratch page 0."""
    rng = np.random.default_rng(seed)
    alloc = [-(-(ln + kq) // page) for ln in lengths]
    if table_pages is not None:
        alloc = [min(a, table_pages) for a in alloc]
    maxp = (table_pages if table_pages is not None
            else max(2, max(alloc) + 1))
    n_pool = 1 + sum(alloc)
    q = rng.standard_normal((b, kq, h, d), np.float32)
    kp = rng.standard_normal((n_pool, page, hkv, d), np.float32)
    vp = rng.standard_normal((n_pool, page, hkv, d), np.float32)
    bt = np.zeros((b, maxp), np.int32)
    free = list(range(1, n_pool))
    for i, a in enumerate(alloc):
        for j in range(a):
            bt[i, j] = free.pop()
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


@pytest.mark.parametrize("case", DECODE_SWEEP)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_ref_matches_jax_kernel_and_oracle(case, dt):
    """Scalar cache_len (the TPU kernel's) broadcast to (B,) lengths."""
    import jax.numpy as jnp
    from repro.kernels.flash_decode import flash_decode_tpu
    from repro.kernels.ref import decode_ref as jax_decode_ref
    b, s, h, hkv, d, clen, win, bk = case
    q, kc, vc = _decode_inputs(sum(case[:5]), b, s, h, hkv, d)
    jq, jk, jv = (jnp.asarray(x).astype(dt) for x in (q, kc, vc))
    cl = jnp.asarray(clen, jnp.int32)
    pallas = flash_decode_tpu(jq, jk, jv, cl, window=win, block_k=bk,
                              interpret=True)
    oracle = jax_decode_ref(jq, jk, jv, cl, window=win)
    lens = torch.full((b,), clen, dtype=torch.int32)
    got = decode_ref(_t(q, dt), _t(kc, dt), _t(vc, dt), lens, window=win)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, 1, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dt], rtol=1e-2)


@pytest.mark.parametrize("window", [None, 16])
def test_decode_ref_per_row_lengths_match_jax_oracle(window):
    """(B,) lengths as the slot engine passes them, a length-0 row
    included (it averages V over the whole cache)."""
    import jax.numpy as jnp
    from repro.models.attention import decode_attention
    b, s, h, hkv, d = 4, 96, 8, 2, 64
    q, kc, vc = _decode_inputs(9, b, s, h, hkv, d)
    lens = np.asarray([0, 1, 50, 96], np.int32)
    want = decode_attention(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(lens), window=window)
    got = ops.decode(_t(q, "float32"), _t(kc, "float32"), _t(vc, "float32"),
                     torch.from_numpy(lens), window=window)
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=2e-5)


@pytest.mark.parametrize("case", VERIFY_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_verify_ref_matches_jax_kernel_and_oracle(case, dt):
    import jax.numpy as jnp
    from repro.kernels.ref import paged_verify_ref as jax_verify_ref
    from repro.kernels.spec_verify import flash_paged_verify_tpu
    b, kq, h, hkv, d, page, lengths, tp = case
    q, kp, vp, bt, ln = _verify_inputs(sum(lengths) + b + kq, *case[:7], tp)
    jq, jkp, jvp = (jnp.asarray(x).astype(dt) for x in (q, kp, vp))
    jbt, jln = jnp.asarray(bt), jnp.asarray(ln)
    pallas = flash_paged_verify_tpu(jq, jkp, jvp, jbt, jln, interpret=True)
    oracle = jax_verify_ref(jq, jkp, jvp, jbt, jln)
    got = paged_verify_ref(_t(q, dt), _t(kp, dt), _t(vp, dt),
                           torch.from_numpy(bt), torch.from_numpy(ln))
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, kq, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                                   atol=ATOL[dt], rtol=1e-2)


def test_verify_ref_reduces_to_decode_and_to_causal_prefill():
    """K == 1 is paged decode at lengths + 1; K tokens over a contiguous
    cache are causal attention with a query offset."""
    from repro_torch.models.attention import reference_attention
    q, kp, vp, bt, ln = _verify_inputs(3, 2, 1, 4, 2, 64, 16, (40, 25), None)
    a = paged_verify_ref(*(_t(x, "float32") for x in (q, kp, vp)),
                         torch.from_numpy(bt), torch.from_numpy(ln))
    b_ = paged_decode_ref(*(_t(x, "float32") for x in (q, kp, vp)),
                          torch.from_numpy(bt), torch.from_numpy(ln + 1))
    torch.testing.assert_close(a, b_, atol=1e-6, rtol=0)
    rng = np.random.default_rng(4)
    kq, base = 4, 37
    qv = torch.from_numpy(rng.standard_normal((2, kq, 4, 64), np.float32))
    kc, vc = (torch.from_numpy(rng.standard_normal((2, base + kq + 5, 2, 64),
                                                   np.float32))
              for _ in range(2))
    got = verify_ref(qv, kc, vc, torch.tensor([base, base]))
    want = reference_attention(qv, kc[:, :base + kq], vc[:, :base + kq],
                               causal=True, q_offset=base)
    torch.testing.assert_close(got, want, atol=2e-5, rtol=0)


def test_ops_cpu_tensors_take_the_plain_versions_of_both():
    ops.reset_launch_counts()
    q, kc, vc = _decode_inputs(1, 2, 40, 4, 2, 64)
    lens = torch.tensor([0, 33], dtype=torch.int32)
    out = ops.decode(_t(q, "float32"), _t(kc, "float32"), _t(vc, "float32"),
                     lens)
    torch.testing.assert_close(out, decode_ref(
        _t(q, "float32"), _t(kc, "float32"), _t(vc, "float32"), lens))
    q, kp, vp, bt, ln = _verify_inputs(2, 2, 3, 4, 2, 64, 8, (9, 0), None)
    outv = ops.paged_verify(_t(q, "float32"), _t(kp, "float32"),
                            _t(vp, "float32"), torch.from_numpy(bt),
                            torch.from_numpy(ln))
    assert torch.isfinite(outv).all() and tuple(outv.shape) == q.shape
    assert set(ops.launch_counts()) == {"flash_attention", "paged_decode",
                                        "flash_decode", "paged_verify",
                                        "paged_decode_int8",
                                        "paged_verify_int8"}
    assert not any(ops.launch_counts().values())
    assert ops.merge_launches() == 0


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# (b, s, h, hkv, d, lengths, window): the CPU sweep's shapes at the built
# widths, the slot engine's qwen3-8b and draft shapes, length-0 rows, a
# window below and one past the cache
GPU_DECODE = [(b, s, h, hkv, dd, (clen,) * b, win)
              for b, s, h, hkv, _, clen, win, _ in DECODE_SWEEP
              for dd in (64, 128)] + [
    (4, 64, 32, 8, 128, (25, 1, 33, 0), None),     # qwen3-8b slot decode
    (4, 72, 2, 1, 64, (25, 1, 33, 0), None),       # the draft's
    (3, 300, 32, 8, 128, (300, 0, 17), 64),
    (2, 100, 16, 1, 64, (200, 3), 50),             # window past the cache
    # the dense and moe configs' head ratios (the wave decode: one length)
    (4, 64, 36, 4, 128, (25, 1, 33, 0), None),     # starcoder2-7b, rep 9
    (4, 64, 64, 8, 128, (25, 1, 33, 0), None),     # qwen3-32b, rep 8
    (2, 300, 96, 8, 128, (300, 17), 64),           # rep 12, window
    (4, 64, 48, 8, 128, (40,) * 4, None),          # dbrx-132b wave, rep 6
    (4, 64, 16, 8, 64, (40,) * 4, None),           # granite-moe wave, rep 2
    (4, 64, 28, 4, 128, (25, 1, 33, 0), None),     # qwen2-vl-7b, rep 7
    # recurrentgemma-9b's ring decode: D = 256, rep 16, one length a wave
    (4, 64, 16, 1, 256, (40,) * 4, None),
    (4, 2048, 16, 1, 256, (2048,) * 4, None),      # a full ring
    (3, 300, 16, 1, 256, (300, 0, 17), 64),        # window, a dead row
    (2, 100, 16, 1, 256, (200, 3), 50),            # window past the cache
    # whisper-base, D = 64, rep 1: the self-attention ring of the wave
    (4, 48, 8, 8, 64, (40,) * 4, None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DECODE)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_kernel_matches_plain_on_card(cuda, case, dt):
    b, s, h, hkv, d, lengths, win = case
    q, kc, vc = (_t(x, dt, cuda) for x in _decode_inputs(
        s + d + b, b, s, h, hkv, d))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["flash_decode"]
    got = ops.decode(q, kc, vc, ln, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == before + 1
    want = decode_ref(q, kc, vc, ln, window=win)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


# rows too few to fill the card: in bf16 the kernel cuts each row's cache
# across blocks (flash-decoding).  (b, s, h, hkv, d, lengths, window): a
# few long rows; ragged rows with a dead one; a window whose edge crosses
# split boundaries; a window past the cache under splits; the draft's
# width with 16 query heads per kv head
GPU_DECODE_SPLIT = [
    (2, 4096, 32, 8, 128, (4096, 3900), None),
    (3, 2048, 32, 8, 128, (2048, 1000, 0), None),
    (2, 4096, 32, 8, 128, (4096, 3000), 1500),
    (2, 2048, 32, 8, 128, (2500, 100), 300),
    (1, 1000, 32, 8, 128, (999,), 100),
    (2, 4096, 16, 1, 64, (4096, 2500), None),
    (2, 4096, 28, 4, 128, (4096, 2500), None),      # rep 7
    # D = 256, rep 16: one block an SM, so its own split target
    (2, 2048, 16, 1, 256, (2048, 1500), None),
    (3, 2048, 16, 1, 256, (2048, 700, 0), None),    # ragged, a dead row
    (2, 4096, 16, 1, 256, (4096, 3000), 1500),
    # whisper-base's cross attention, D = 64, rep 1: every row over the
    # full 1500-frame cache (6 splits of 4 chunks at B = 4), and ragged
    (4, 1500, 8, 8, 64, (1500,) * 4, None),
    (2, 1500, 8, 8, 64, (1500, 700), None),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DECODE_SPLIT)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_decode_kernel_split_rows_match_plain_on_card(cuda, case, dt):
    b, s, h, hkv, d, lengths, win = case
    q, kc, vc = (_t(x, dt, cuda) for x in _decode_inputs(
        s + d + b, b, s, h, hkv, d))
    ln = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = ops.launch_counts()["flash_decode"]
    got = ops.decode(q, kc, vc, ln, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_decode"] == before + 1
    splits = decode_splits(b, hkv, s, target_blocks(d))
    assert splits > 1
    assert flash_decode.flash_decode_cuda.last_splits == (
        splits if dt == "bfloat16" else 1)
    want = decode_ref(q, kc, vc, ln, window=win)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)
    if dt == "bfloat16":      # split: held to each head's scale as well
        assert head_scaled_err(got, want) <= SPLIT_REL


GPU_VERIFY = [(b, kq, h, hkv, 128, page, lengths, tp)
              for b, kq, h, hkv, _, page, lengths, tp in VERIFY_CASES] + [
    (4, 5, 32, 8, 128, 16, (28, 1, 40, 0), None),  # qwen3-8b spec verify
    (4, 5, 32, 8, 128, 16, (30, 31, 9, 0), 2),     # riders past the table
    (2, 2, 32, 1, 128, 16, (700, 3), None),        # 64 rows per kv head
    # more than 64 query rows: several tiles (a ragged last one; bf16
    # tiles 32 rows, fp32 64), the prefix cache's warm prefill of a
    # page-rounded suffix
    (2, 17, 32, 8, 128, 16, (40, 3), None),        # 68 rows
    (3, 32, 32, 8, 128, 16, (48, 0, 16), None),    # 128 rows
    (2, 33, 32, 8, 128, 16, (20, 5), 2),           # 132 rows, past the table
    (1, 64, 32, 8, 128, 16, (100,), None),         # 256 rows, 4 tiles
    # K * rep = 4, 20, 64, 128 and 132 rows on the bf16 body's 32-row
    # tiles, with lengths that end inside a page (page 16) and whose last
    # query's bound crosses the 64-position chunk boundary
    (2, 1, 32, 8, 128, 16, (33, 63), None),        # 4 rows, 63 + 1 = 64
    (3, 5, 32, 8, 128, 16, (59, 60, 11), None),    # 20 rows, bounds 63 / 64
    (2, 16, 32, 8, 128, 16, (48, 17), None),       # 64 rows, 48 + 16 = 64
    (2, 32, 32, 8, 128, 16, (32, 7), None),        # 128 rows, 32 + 32 = 64
    (2, 33, 32, 8, 128, 16, (31, 64), None),       # 132 rows, 31 + 33 = 64
    # the dense configs' head ratios: K * rep = 45, 40 and 60 rows at K=5
    # (a tile's rows straddle query positions), 396 at K = 33, rep 12
    (4, 5, 36, 4, 128, 16, (28, 1, 40, 0), None),  # starcoder2-7b, rep 9
    (3, 5, 64, 8, 128, 16, (59, 60, 11), None),    # qwen3-32b, rep 8
    (4, 5, 96, 8, 128, 16, (30, 31, 9, 0), 2),     # command-r-plus, rep 12
    (2, 33, 96, 8, 128, 16, (20, 5), 2),           # 396 rows, past the table
    (4, 5, 28, 4, 128, 16, (28, 1, 40, 0), None),  # qwen2-vl-7b, rep 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_VERIFY)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_verify_kernel_matches_plain_on_card(cuda, case, dt):
    b, kq, h, hkv, d, page, lengths, tp = case
    q, kp, vp, bt, ln = _verify_inputs(sum(lengths) + kq, *case[:7], tp)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_verify"]
    got = ops.paged_verify(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_verify"] == before + 1
    want = paged_verify_ref(q, kp, vp, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_verify_kernel_with_one_token_is_paged_decode(cuda, dt):
    q, kp, vp, bt, ln = _verify_inputs(5, 4, 1, 32, 8, 128, 16,
                                       (28, 1, 40, 0), None)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    got = ops.paged_verify(q, kp, vp, bt, ln)
    want = ops.paged_decode(q, kp, vp, bt, ln + 1)
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


def _int8_pools(kp, vp, device):
    """Quantize fp pools (numpy) into int8 pools and bf16 scale pools."""
    out = []
    for p in (kp, vp):
        q, sc = kv_quantize(torch.from_numpy(p))
        out += [q.to(device), sc.to(device)]
    return out[0], out[2], out[1], out[3]


# (b, h, hkv, d, page, lengths): the paged cases of
# tests/test_torch_kernels.py at the built width, qwen3-8b's decode step
# with a length-0 rider, a long row
GPU_DECODE_INT8 = [
    (2, 4, 2, 128, 16, (40, 25)),
    (3, 8, 2, 128, 32, (64, 1, 90)),
    (1, 4, 1, 128, 16, (47,)),
    (2, 4, 4, 128, 8, (0, 30)),
    (4, 32, 8, 128, 16, (28, 1, 40, 0)),
    (2, 32, 8, 128, 16, (1000, 17)),
    (4, 36, 4, 128, 16, (28, 1, 40, 0)),           # starcoder2-7b, rep 9
    (4, 96, 8, 128, 16, (25, 1, 32, 29)),          # command-r-plus, rep 12
    (2, 64, 8, 128, 16, (1000, 17)),               # qwen3-32b, rep 8
    (4, 28, 4, 128, 16, (25, 1, 32, 0)),           # qwen2-vl-7b, rep 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DECODE_INT8)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_paged_decode_kernel_matches_plain_on_card(cuda, case, dt):
    b, h, hkv, d, page, lengths = case
    q, kp, vp, bt, ln = _verify_inputs(sum(lengths) + h, b, 1, h, hkv, d,
                                       page, lengths, None)
    pools = _int8_pools(kp, vp, cuda)
    q = _t(q, dt, cuda)
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_decode_int8"]
    got = ops.paged_decode_quant(q, *pools, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_int8"] == before + 1
    want = paged_decode_quant_ref(q, *pools, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


# rows too few to fill the card: in bf16 the int8 kernel cuts each row's
# table across blocks as the bf16-page one does, toward TARGET_BLOCKS_INT8
# blocks.  (b, h, hkv, d, page, lengths): 32 long rows (3 splits); a few
# long rows; ragged rows with a dead one on 256-position pages (split
# boundaries inside pages); a long row beside a dead one; one row; 16
# query heads a kv head
GPU_DECODE_INT8_SPLIT = [
    (32, 32, 8, 128, 16, (4096,) * 32),
    (2, 32, 8, 128, 16, (4096, 3900)),
    (3, 32, 8, 128, 256, (4096, 1500, 0)),
    (2, 32, 8, 128, 16, (2048, 0)),
    (1, 32, 8, 128, 16, (999,)),
    (2, 16, 1, 128, 16, (4096, 2500)),
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_DECODE_INT8_SPLIT)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_paged_decode_split_rows_match_plain_on_card(cuda, case, dt):
    b, h, hkv, d, page, lengths = case
    q, kp, vp, bt, ln = _verify_inputs(sum(lengths) + h, b, 1, h, hkv, d,
                                       page, lengths, None)
    pools = _int8_pools(kp, vp, cuda)
    q = _t(q, dt, cuda)
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_decode_int8"]
    merges = ops.merge_launches()
    got = ops.paged_decode_quant(q, *pools, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode_int8"] == before + 1
    assert ops.merge_launches() == merges + (dt == "bfloat16")
    splits = decode_splits(b, hkv, bt.shape[1] * page, TARGET_BLOCKS_INT8)
    assert splits > 1
    assert paged_decode.paged_decode_int8_cuda.last_splits == (
        splits if dt == "bfloat16" else 1)
    want = paged_decode_quant_ref(q, *pools, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)
    if dt == "bfloat16":      # split: held to each head's scale as well
        assert head_scaled_err(got, want) <= SPLIT_REL


# a table entry outside [0, P) inside a row's walk: the kernel traps (a
# device fault that ends the process's CUDA context, hence a child
# process per case) where the valid table ran.  (dtype, lengths, the bad
# entry: "P" one past the pool, or -1): one split, split rows, fp32
TRAP_CASES = [("bfloat16", (40, 25), "P"), ("bfloat16", (4096, 3000), -1),
              ("float32", (40, 25), "P")]
_TRAP_CHILD = """
import ast
import sys
import torch
from repro_torch.kernels import ops, paged_decode
from repro_torch.models.attention import kv_quantize
dt, lengths = getattr(torch, sys.argv[1]), ast.literal_eval(sys.argv[2])
bad = sys.argv[3]
page, b = 16, len(lengths)
g = torch.Generator("cuda").manual_seed(0)
alloc = [-(-n // page) for n in lengths]
n_pool = 1 + sum(alloc)
q = torch.randn((b, 1, 32, 128), generator=g, device="cuda").to(dt)
kq, ks = kv_quantize(torch.randn((n_pool, page, 8, 128), generator=g,
                                 device="cuda"))
vq, vs = kv_quantize(torch.randn((n_pool, page, 8, 128), generator=g,
                                 device="cuda"))
bt = torch.zeros((b, max(alloc) + 1), dtype=torch.int32)
nxt = 1
for i, a in enumerate(alloc):
    bt[i, :a] = torch.arange(nxt, nxt + a)
    nxt += a
bt, ln = bt.cuda(), torch.tensor(lengths, dtype=torch.int32, device="cuda")
ops.paged_decode_quant(q, kq, vq, ks, vs, bt, ln)
torch.cuda.synchronize()
print("VALID_RAN splits", paged_decode.paged_decode_int8_cuda.last_splits,
      flush=True)
bt[0, alloc[0] // 2] = n_pool if bad == "P" else int(bad)
try:
    ops.paged_decode_quant(q, kq, vq, ks, vs, bt, ln)
    torch.cuda.synchronize()
    print("NO_TRAP", flush=True)
except RuntimeError as err:
    print("TRAPPED:", str(err).splitlines()[0], flush=True)
"""


@pytest.mark.gpu
@pytest.mark.parametrize("case", TRAP_CASES)
def test_int8_paged_decode_traps_on_a_bad_table_entry_on_card(cuda, case):
    dt, lengths, bad = case
    src = pathlib.Path(__file__).resolve().parents[1] / "src"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(src)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    proc = subprocess.run([sys.executable, "-c", _TRAP_CHILD, dt,
                           repr(lengths), str(bad)], capture_output=True,
                          text=True, timeout=600, env=env)
    out = proc.stdout
    print(out.strip())
    assert "VALID_RAN" in out, proc.stderr[-3000:]
    want_splits = (decode_splits(len(lengths), 8, (max(
        -(-n // 16) for n in lengths) + 1) * 16, TARGET_BLOCKS_INT8)
                   if dt == "bfloat16" else 1)
    assert f"VALID_RAN splits {want_splits}" in out
    assert "TRAPPED:" in out and "NO_TRAP" not in out, out + proc.stderr[-3000:]


@pytest.mark.gpu
def test_int8_entry_point_takes_splits_only_in_bf16_with_a_workspace(cuda):
    q = torch.zeros((2, 1, 32, 128), device=cuda)
    pool = torch.zeros((260, 16, 8, 128), dtype=torch.int8, device=cuda)
    scale = torch.zeros((260, 16, 8, 1), dtype=torch.bfloat16, device=cuda)
    bt = torch.zeros((2, 257), dtype=torch.int32, device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    work = torch.empty(2 * 32 * 13 * 130, device=cuda)
    fn = _build.function("paged_decode", "paged_decode_int8_fwd",
                         paged_decode._INT8_ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    # fp32 with splits; bf16 without a workspace; a span short of the row
    for dtype, qq, ws, splits, span in (
            (0, q, work.data_ptr(), 13, 320), (1, q.bfloat16(), None, 13, 320),
            (1, q.bfloat16(), work.data_ptr(), 13, 256)):
        assert fn(qq.data_ptr(), pool.data_ptr(), pool.data_ptr(),
                  scale.data_ptr(), scale.data_ptr(), bt.data_ptr(),
                  ln.data_ptr(), qq.data_ptr(), ws, dtype, 2, 32, 8, 128, 16,
                  257, 260, splits, span, 128 ** -0.5, cuda.index or 0,
                  stream) != 0
    # and runs where the split covers the row
    out = torch.empty_like(q.bfloat16())
    assert fn(q.bfloat16().data_ptr(), pool.data_ptr(), pool.data_ptr(),
              scale.data_ptr(), scale.data_ptr(), bt.data_ptr(),
              ln.data_ptr(), out.data_ptr(), work.data_ptr(), 1, 2, 32, 8,
              128, 16, 257, 260, 13, 320, 128 ** -0.5, cuda.index or 0,
              stream) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_VERIFY)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_verify_kernel_matches_plain_on_card(cuda, case, dt):
    b, kq, h, hkv, d, page, lengths, tp = case
    q, kp, vp, bt, ln = _verify_inputs(sum(lengths) + kq + 1, *case[:7], tp)
    pools = _int8_pools(kp, vp, cuda)
    q = _t(q, dt, cuda)
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_verify_int8"]
    got = ops.paged_verify_quant(q, *pools, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_verify_int8"] == before + 1
    want = paged_verify_quant_ref(q, *pools, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_int8_verify_with_one_token_is_int8_paged_decode(cuda, dt):
    q, kp, vp, bt, ln = _verify_inputs(6, 4, 1, 32, 8, 128, 16,
                                       (28, 1, 40, 0), None)
    pools = _int8_pools(kp, vp, cuda)
    q = _t(q, dt, cuda)
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    got = ops.paged_verify_quant(q, *pools, bt, ln)
    want = ops.paged_decode_quant(q, *pools, bt, ln + 1)
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


# the draft's prefill: H=2, Hkv=1, D=64, and the CPU prefill cases' masks
GPU_PREFILL_64 = [(4, 32, 2, 1, None, True), (1, 1000, 2, 1, None, True),
                  (2, 100, 8, 2, 64, True), (2, 77, 4, 4, None, False),
                  (1, 4096, 2, 1, None, True),    # the draft's long prefill
                  (3, 70, 8, 1, 40, True),        # rep 8: 560 rows, window
                  (4, 32, 16, 8, None, True),     # granite-moe, rep 2
                  (1, 300, 16, 8, None, True)]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PREFILL_64)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_kernel_at_the_draft_width_on_card(cuda, case, dt):
    b, s, h, hkv, win, causal = case
    rng = np.random.default_rng(s + h)
    q, k, v = (_t(rng.standard_normal(shape, np.float32), dt, cuda)
               for shape in ((b, s, h, 64), (b, s, hkv, 64), (b, s, hkv, 64)))
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = flash_ref(q, k, v, causal=causal, window=win)
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


@pytest.mark.gpu
def test_new_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros((2, 1, 4, 32), device=cuda)
    kc = torch.zeros((2, 8, 2, 32), device=cuda)
    ln = torch.ones(2, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.decode(q, kc, kc, ln)
    q = torch.zeros((2, 1, 4, 64), device=cuda)
    kc = torch.zeros((2, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="int32"):
        ops.decode(q, kc, kc, ln.long())
    qv = torch.zeros((1, 5, 32, 64), device=cuda)
    pool = torch.zeros((2, 16, 8, 64), device=cuda)
    bt = torch.zeros((1, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.paged_verify(qv, pool, pool, bt, ln[:1])
    # any K: 17 tokens x 4 query heads per kv head is two tiles
    qv = torch.zeros((1, 17, 32, 128), device=cuda)
    pool = torch.zeros((2, 16, 8, 128), device=cuda)
    assert tuple(ops.paged_verify(qv, pool, pool, bt, ln[:1]).shape) == \
        tuple(qv.shape)
    # the int8 forms take int8 pools with bf16 (P, page, Hkv, 1) scales
    qpool = torch.zeros((2, 16, 8, 128), dtype=torch.int8, device=cuda)
    scale = torch.zeros((2, 16, 8, 1), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(TypeError, match="int8"):
        ops.paged_verify_quant(qv, pool, pool, scale, scale, bt, ln[:1])
    with pytest.raises(TypeError, match="scale"):
        ops.paged_verify_quant(qv, qpool, qpool, scale.float(), scale, bt,
                               ln[:1])
    with pytest.raises(TypeError, match="scale"):
        ops.paged_decode_quant(qv[:, :1], qpool, qpool, scale[..., 0],
                               scale, bt, ln[:1])
    # the bf16 decode paths (tensor cores, split rows) refuse more than 16
    # query heads a kv head and mixed dtypes, as the fp32 paths do
    qb = torch.zeros((2, 1, 34, 128), device=cuda, dtype=torch.bfloat16)
    kb = torch.zeros((2, 4096, 2, 128), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="heads"):
        ops.decode(qb, kb, kb, ln)
    with pytest.raises(TypeError, match="dtype"):
        ops.decode(qb[:, :, :32].contiguous(), kb.float(), kb.float(), ln)
    pb = torch.zeros((2, 16, 2, 128), device=cuda, dtype=torch.bfloat16)
    btb = torch.zeros((2, 1), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="heads"):
        ops.paged_decode(qb, pb, pb, btb, ln)
    with pytest.raises(TypeError, match="dtype"):
        ops.paged_decode(qb[:, :, :32].contiguous(), pb.float(), pb.float(),
                         btb, ln)
    # the C entry point takes splits only with q in bf16 and a workspace,
    # and only splits whose span covers the row
    q32 = torch.zeros((2, 1, 32, 128), device=cuda)
    k32 = torch.zeros((2, 4096, 8, 128), device=cuda)
    work = torch.empty(2 * 32 * 2 * 130, device=cuda)
    fn = _build.function("flash_decode", "flash_decode_fwd",
                         flash_decode._ARGTYPES)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    for dtype, (qq, kk), ws, span in (
            (0, (q32, k32), None, 2048),
            (1, (q32.bfloat16(), k32.bfloat16()), None, 2048),
            (1, (q32.bfloat16(), k32.bfloat16()), work.data_ptr(), 1984)):
        assert fn(qq.data_ptr(), kk.data_ptr(), kk.data_ptr(),
                  ln.data_ptr(), qq.data_ptr(), ws, dtype, 2, 4096, 32, 8,
                  128, -1, 2, span, 128 ** -0.5, cuda.index or 0,
                  stream) != 0
