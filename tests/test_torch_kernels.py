"""Port kernels: plain versions vs the JAX kernels, and CUDA vs plain.

CPU cases hand the same numpy inputs (fixed seeds) to the port's plain
versions (``repro_torch.kernels.ref``) and to the JAX package's Pallas
kernels in interpret mode and their jnp oracles, at the tolerances of
``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2 absolute).

``gpu`` cases hold each CUDA kernel against its plain version on the card
(fp32 1e-4: the card sums in another order; bf16 2e-2).  They skip without
a card.  JAX is imported inside the CPU cases only, so the ``gpu`` cases
also run where JAX is absent:

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.decode_split import (SPLIT_REL, decode_splits,
                                              head_scaled_err)
from repro_torch.kernels.paged_decode import paged_decode_cuda
from repro_torch.kernels.ref import flash_ref, paged_decode_ref

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
CUDA_ATOL = {"float32": 1e-4, "bfloat16": 2e-2}
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (b, s, h, hkv, d, window, causal, bq, bk): a subset of test_kernels.py's
# PREFILL_SWEEP -- causal GQA, MQA, window, non-multiple length, encoder
PREFILL_CASES = [
    (2, 256, 8, 2, 64, None, True, 128, 128),
    (1, 192, 6, 1, 128, None, True, 64, 64),
    (2, 128, 4, 2, 32, 64, True, 32, 64),
    (1, 100, 4, 4, 64, None, True, 32, 32),
    (2, 64, 8, 8, 64, None, False, 32, 32),
]

# (b, h, hkv, d, page, lengths): a length-0 row, exact pages, MQA
PAGED_CASES = [
    (2, 4, 2, 64, 16, (40, 25)),
    (3, 8, 2, 64, 32, (64, 1, 90)),
    (1, 4, 1, 128, 16, (47,)),
    (2, 4, 4, 32, 8, (0, 30)),
]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _qkv(seed, b, sq, skv, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, h, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32),
            rng.standard_normal((b, skv, hkv, d), np.float32))


def _paged(seed, b, h, hkv, d, page, lengths):
    """Random pools and block tables with distinct pages per row; entries
    past a row's allocation point at the scratch page 0."""
    rng = np.random.default_rng(seed)
    maxp = max(2, max(-(-ln // page) for ln in lengths) + 1)
    n_pool = 1 + sum(-(-ln // page) for ln in lengths)
    q = rng.standard_normal((b, 1, h, d), np.float32)
    kp = rng.standard_normal((n_pool, page, hkv, d), np.float32)
    vp = rng.standard_normal((n_pool, page, hkv, d), np.float32)
    bt = np.zeros((b, maxp), np.int32)
    free = list(range(1, n_pool))
    for i, ln in enumerate(lengths):
        for j in range(-(-ln // page)):
            bt[i, j] = free.pop()
    return q, kp, vp, bt, np.asarray(lengths, np.int32)


def _t(x, dt, device="cpu"):
    return torch.from_numpy(x).to(device=device, dtype=TORCH_DT[dt])


def _np(x):
    return np.asarray(x.float().cpu().numpy())


def _jnp_f32(x):
    return np.asarray(x.astype("float32"))


@pytest.mark.parametrize("case", PREFILL_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_ref_matches_jax_kernel_and_oracle(case, dt):
    import jax.numpy as jnp
    from repro.kernels.flash_attention import flash_attention_tpu
    from repro.models.attention import reference_attention
    b, s, h, hkv, d, win, causal, bq, bk = case
    q, k, v = _qkv(sum(case[:5]), b, s, s, h, hkv, d)
    jq, jk, jv = (jnp.asarray(x).astype(dt) for x in (q, k, v))
    pallas = flash_attention_tpu(jq, jk, jv, causal=causal, window=win,
                                 block_q=bq, block_k=bk, interpret=True)
    oracle = reference_attention(jq, jk, jv, causal=causal, window=win)
    got = flash_ref(_t(q, dt), _t(k, dt), _t(v, dt), causal=causal,
                    window=win)
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, s, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _jnp_f32(want),
                                   atol=ATOL[dt], rtol=1e-2)


@pytest.mark.parametrize("case", PAGED_CASES)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_ref_matches_jax_kernel_and_oracle(case, dt):
    import jax.numpy as jnp
    from repro.kernels.paged_decode import flash_paged_decode_tpu
    from repro.kernels.ref import paged_decode_ref as jax_paged_ref
    b, h, hkv, d, page, lengths = case
    q, kp, vp, bt, ln = _paged(sum(lengths) + b, b, h, hkv, d, page, lengths)
    jq, jkp, jvp = (jnp.asarray(x).astype(dt) for x in (q, kp, vp))
    jbt, jln = jnp.asarray(bt), jnp.asarray(ln)
    pallas = flash_paged_decode_tpu(jq, jkp, jvp, jbt, jln, interpret=True)
    oracle = jax_paged_ref(jq, jkp, jvp, jbt, jln)
    got = paged_decode_ref(_t(q, dt), _t(kp, dt), _t(vp, dt),
                           torch.from_numpy(bt), torch.from_numpy(ln))
    assert got.dtype == TORCH_DT[dt] and tuple(got.shape) == (b, 1, h, d)
    for want in (pallas, oracle):
        np.testing.assert_allclose(_np(got), _jnp_f32(want),
                                   atol=ATOL[dt], rtol=1e-2)


def test_ops_cpu_tensors_take_the_plain_versions():
    q, k, v = _qkv(1, 1, 20, 20, 4, 2, 32)
    ops.reset_launch_counts()
    out = ops.attention(_t(q, "float32"), _t(k, "float32"), _t(v, "float32"))
    torch.testing.assert_close(out, flash_ref(_t(q, "float32"),
                                              _t(k, "float32"),
                                              _t(v, "float32")))
    qp, kp, vp, bt, ln = _paged(2, 2, 4, 2, 32, 8, (9, 0))
    outp = ops.paged_decode(_t(qp, "float32"), _t(kp, "float32"),
                            _t(vp, "float32"), torch.from_numpy(bt),
                            torch.from_numpy(ln))
    assert torch.isfinite(outp).all()          # the length-0 row: mean of V
    assert ops.launch_counts() == {"flash_attention": 0, "paged_decode": 0,
                                   "flash_decode": 0, "paged_verify": 0,
                                   "paged_decode_int8": 0,
                                   "paged_verify_int8": 0}


def test_ops_reject_other_devices():
    q = torch.zeros((1, 2, 2, 32), device="meta")
    with pytest.raises(ValueError, match="no attention path"):
        ops.attention(q, q, q)


# ------------------------------------------------------------------ card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


# the card cases take the CPU cases' head ratios, lengths and masks at head
# width 128 (qwen3-8b's; the prefill kernel's width 64, the draft's, is
# held in tests/test_torch_decode_kernels.py); (b, sq, h, hkv, d, window,
# causal, skv), skv None meaning sq.  The bf16 kernel tiles 128 query rows
# (sq * h / hkv of them a kv head) and 64 keys: ragged row and key tails,
# sq != skv, and windows whose edge crosses tiles near the diagonal
GPU_PREFILL = [(b, s, h, hkv, 128, win, causal, None)
               for b, s, h, hkv, _, win, causal, _, _ in PREFILL_CASES] + [
    (4, 32, 32, 8, 128, None, True, None),     # qwen3-8b serve prefill
    (1, 1000, 32, 8, 128, None, True, None),
    (2, 100, 32, 8, 128, 64, True, None),
    (2, 77, 32, 8, 128, None, False, None),
    (1, 200, 32, 8, 128, None, True, None),    # 800 rows: 6 tiles + 32
    (2, 77, 32, 8, 128, None, True, 300),      # sq < skv
    (1, 300, 32, 8, 128, None, True, 130),     # sq > skv, no window
    (1, 333, 32, 8, 128, 100, True, None),     # window edge inside tiles
    (1, 150, 8, 8, 128, 40, False, None),      # bidirectional window, rep 1
    (2, 129, 16, 2, 128, 33, True, 200),       # rep 8, window, sq < skv
    # the dense and moe configs' head ratios: a tile's 128 rows straddle
    # query positions unevenly at rep 9 and 12
    (4, 32, 36, 4, 128, None, True, None),     # starcoder2-7b, rep 9
    (3, 50, 36, 4, 128, None, True, 70),       # rep 9, sq < skv
    (4, 32, 96, 8, 128, None, True, None),     # command-r-plus-104b, rep 12
    (1, 300, 96, 8, 128, None, True, None),
    (2, 77, 64, 8, 128, 64, True, None),       # qwen3-32b, rep 8, window
    (1, 129, 48, 8, 128, None, True, None),    # dbrx-132b, rep 6
    (4, 32, 28, 4, 128, None, True, None),     # qwen2-vl-7b, rep 7
    (1, 300, 28, 4, 128, None, True, None),
    (2, 77, 28, 4, 128, 64, True, 100),        # rep 7, window, sq < skv
    # recurrentgemma-9b's local attention: D = 256, rep 16 (one 64-row
    # warpgroup a CTA in bf16: 4 query positions), window 2048
    (4, 32, 16, 1, 256, 2048, True, None),     # serve prefill
    (1, 2100, 16, 1, 256, 2048, True, None),   # the window masks keys
    (1, 300, 16, 1, 256, 64, True, None),      # window edge inside tiles
    (2, 77, 16, 1, 256, None, False, None),
    (2, 129, 16, 2, 256, 33, True, 200),       # rep 8, sq < skv
    (1, 300, 16, 1, 256, None, True, 130),     # sq > skv
    # whisper-base: D = 64, rep 1 (8/8): its encoder (bidirectional over
    # 1500 frames), its decoder's causal prompt and its cross attention
    # (a 32-token prompt, no mask, over the 1500 encoder positions)
    (4, 1500, 8, 8, 64, None, False, None),
    (4, 32, 8, 8, 64, None, True, None),
    (4, 32, 8, 8, 64, None, False, 1500),       # non-causal, sq < skv
    (2, 77, 32, 8, 128, None, False, 300),      # the same at rep 4, D=128
    (1, 200, 8, 8, 64, None, False, 130),       # non-causal, sq > skv
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PREFILL)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_kernel_matches_plain_on_card(cuda, case, dt):
    b, s, h, hkv, d, win, causal, skv = case
    q, k, v = (_t(x, dt, cuda) for x in _qkv(sum(case[:5]), b, s, skv or s,
                                              h, hkv, d))
    before = ops.launch_counts()["flash_attention"]
    got = ops.attention(q, k, v, causal=causal, window=win)
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention"] == before + 1
    want = flash_ref(q, k, v, causal=causal, window=win)
    assert got.dtype == q.dtype and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_flash_kernel_rows_without_keys_average_v(cuda, dt):
    """Sq > Skv with a window leaves late rows no visible key: they average
    all of V, as the plain version does, instead of turning NaN."""
    q, _, _ = _qkv(5, 1, 200, 200, 8, 2, 128)
    _, k, v = _qkv(6, 1, 40, 40, 8, 2, 128)
    q, k, v = (_t(x, dt, cuda) for x in (q, k, v))
    got = ops.attention(q, k, v, causal=True, window=16)
    want = flash_ref(q, k, v, causal=True, window=16)
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


GPU_PAGED = [(b, h, hkv, 128, page, lengths)
             for b, h, hkv, _, page, lengths in PAGED_CASES] + [
    (4, 32, 8, 128, 16, (25, 1, 32, 29)),      # qwen3-8b serve decode
    (4, 32, 8, 128, 16, (0, 17, 40, 33)),
    (3, 32, 8, 128, 16, (4096, 1, 700)),
    (2, 32, 2, 128, 16, (100, 0)),            # 16 heads per kv head
    (4, 36, 4, 128, 16, (28, 1, 40, 0)),      # starcoder2-7b, rep 9
    (4, 96, 8, 128, 16, (25, 1, 32, 29)),     # command-r-plus-104b, rep 12
    (3, 64, 8, 128, 16, (700, 0, 33)),        # qwen3-32b, rep 8
    (4, 28, 4, 128, 16, (25, 1, 32, 0)),      # qwen2-vl-7b, rep 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PAGED)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_kernel_matches_plain_on_card(cuda, case, dt):
    b, h, hkv, d, page, lengths = case
    q, kp, vp, bt, ln = _paged(sum(lengths) + b, b, h, hkv, d, page, lengths)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_decode"]
    got = ops.paged_decode(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode"] == before + 1
    want = paged_decode_ref(q, kp, vp, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)


# rows too few to fill the card: in bf16 the kernel cuts each row's table
# across blocks (flash-decoding).  A few long rows; ragged rows with a dead
# one; page 48, so that split boundaries (whole 64-position chunks) fall
# inside pages; 16 query heads per kv head
GPU_PAGED_SPLIT = [
    (2, 32, 8, 128, 16, (4096, 3000)),
    (3, 32, 8, 128, 16, (4096, 1500, 0)),
    (3, 32, 8, 128, 48, (2000, 700, 0)),
    (2, 32, 2, 128, 16, (3000, 0)),
    (2, 28, 4, 128, 16, (4096, 1500)),        # rep 7
]


@pytest.mark.gpu
@pytest.mark.parametrize("case", GPU_PAGED_SPLIT)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_paged_kernel_split_rows_match_plain_on_card(cuda, case, dt):
    b, h, hkv, d, page, lengths = case
    q, kp, vp, bt, ln = _paged(sum(lengths) + b, b, h, hkv, d, page, lengths)
    q, kp, vp = (_t(x, dt, cuda) for x in (q, kp, vp))
    bt, ln = torch.from_numpy(bt).to(cuda), torch.from_numpy(ln).to(cuda)
    before = ops.launch_counts()["paged_decode"]
    got = ops.paged_decode(q, kp, vp, bt, ln)
    torch.cuda.synchronize()
    assert ops.launch_counts()["paged_decode"] == before + 1
    splits = decode_splits(b, hkv, bt.shape[1] * page)
    assert splits > 1
    assert paged_decode_cuda.last_splits == (splits if dt == "bfloat16"
                                             else 1)
    want = paged_decode_ref(q, kp, vp, bt, ln)
    assert torch.isfinite(got.float()).all()
    np.testing.assert_allclose(_np(got), _np(want), atol=CUDA_ATOL[dt],
                               rtol=1e-2)
    if dt == "bfloat16":      # split: held to each head's scale as well
        assert head_scaled_err(got, want) <= SPLIT_REL


@pytest.mark.gpu
def test_kernel_wrappers_reject_what_they_do_not_take(cuda):
    q = torch.zeros((1, 8, 4, 32), device=cuda)
    with pytest.raises(ValueError, match="head_dim"):
        ops.attention(q, q[:, :, :2], q[:, :, :2])
    q = torch.zeros((1, 8, 4, 128), device=cuda, dtype=torch.float16)
    with pytest.raises(TypeError):
        ops.attention(q, q, q)
    q = torch.zeros((1, 8, 4, 128), device=cuda).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.attention(q, q, q)
