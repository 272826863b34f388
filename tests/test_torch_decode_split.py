"""The split axis of the bf16 decode kernels (flash-decoding), on the CPU.

``repro_torch.kernels.decode_split`` chooses how many blocks a row's
positions are cut across; the card kernels take that choice, so these
cases pin it: one split at every serve shape, ranges that tile the row, and
about two blocks per SM for a few long rows.  ``decode_split_ref`` and
``paged_decode_split_ref`` repeat the kernels' split-then-merge in plain
PyTorch; the same numpy inputs (fixed seeds) go through them, through
``decode_ref`` / ``paged_decode_ref`` and through the JAX package's oracles,
at fp32 2e-5 (the tolerance of ``tests/test_kernels.py``): dead rows,
windows across split boundaries and empty splits included.  On the card,
faults planted in the kernels' merge of the splits must fail the
head-scaled check (``SPLIT_REL``) that the split cases are held to.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_split import (CHUNK, MIN_CHUNKS, SPLIT_REL,
                                              TARGET_BLOCKS, decode_splits,
                                              head_scaled_err, split_ranges,
                                              split_span)
from repro_torch.kernels.ref import (decode_ref, decode_split_ref,
                                     paged_decode_ref, paged_decode_split_ref)

ATOL = 2e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


# (B, Hkv, n): qwen3-8b's paged (maxp * page = 32) and slot (S = 64)
# decode at max batch 4, and the draft's slot decode (Hkv 1, S 64 and 72)
@pytest.mark.parametrize("shape", [(4, 8, 32), (4, 8, 64), (4, 1, 64),
                                   (4, 1, 72), (1, 8, 32)])
def test_schedule_is_one_split_at_the_serve_shapes(shape):
    assert decode_splits(*shape) == 1


# a few long rows: 32 x 4096 already fills the card (256 blocks); fewer
# rows are cut into splits of at least MIN_CHUNKS chunks
LONG = [(2, 8, 4096), (3, 8, 4112), (8, 8, 4096), (32, 8, 4096),
        (32, 1, 4096), (2, 8, 4112), (1, 8, 32768), (16, 8, 2048)]


@pytest.mark.parametrize("shape", LONG)
def test_long_rows_reach_about_two_blocks_per_sm(shape):
    b, hkv, n = shape
    splits = decode_splits(b, hkv, n)
    assert 0.75 * TARGET_BLOCKS <= b * hkv * splits <= 1.25 * TARGET_BLOCKS
    sizes = [e - s for s, e in split_ranges(n, splits)]
    assert min(sizes[:-1], default=n) >= MIN_CHUNKS * CHUNK
    assert sizes[-1] > 0                     # no split is empty


@pytest.mark.parametrize("n, splits", [
    (32, 1), (64, 1), (4096, 16), (4112, 11), (4112, 13), (4096, 4),
    (100, 3), (130, 7), (1, 1), (5000, 9)])
def test_split_ranges_tile_the_row_without_overlap(n, splits):
    ranges = split_ranges(n, splits)
    assert len(ranges) == splits
    assert ranges[0][0] == 0 and ranges[-1][1] == n
    for (s0, e0), (s1, e1) in zip(ranges, ranges[1:]):
        assert s0 <= e0 == s1 <= e1          # adjacent, in order
    for s, _ in ranges:
        assert s % CHUNK == 0 or s == n      # whole chunks
    span = split_span(n, splits)             # what the kernel is passed
    assert span % CHUNK == 0 and splits * span >= n
    assert all(e - s <= span for s, e in ranges)


def _decode_inputs(seed, b, s, h, hkv, d):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, 1, h, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32),
            rng.standard_normal((b, s, hkv, d), np.float32))


# (b, s, h, hkv, d, lengths, window, splits): splits None takes the
# schedule's choice
DECODE_CASES = [
    (3, 300, 8, 2, 64, (300, 0, 17), None, 5),   # dead row, empty splits
    (2, 256, 4, 1, 32, (256, 100), 64, 4),       # window across boundaries
    (2, 100, 4, 2, 32, (200, 3), 50, 2),         # window past the cache
    (4, 96, 8, 2, 64, (0, 1, 50, 96), None, 7),  # more splits than chunks
    (2, 512, 16, 1, 64, (500, 260), None, None),  # rep 16, the schedule's 2
    (1, 130, 4, 4, 16, (129,), 70, 3),           # a short last split
]


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_split_ref_matches_decode_ref_and_jax_oracle(case):
    import jax.numpy as jnp
    from repro.kernels.ref import decode_ref as jax_decode_ref
    b, s, h, hkv, d, lengths, window, splits = case
    q, kc, vc = _decode_inputs(s + b, b, s, h, hkv, d)
    lens = np.asarray(lengths, np.int32)
    got = decode_split_ref(torch.from_numpy(q), torch.from_numpy(kc),
                           torch.from_numpy(vc), torch.from_numpy(lens),
                           window=window, splits=splits)
    plain = decode_ref(torch.from_numpy(q), torch.from_numpy(kc),
                       torch.from_numpy(vc), torch.from_numpy(lens),
                       window=window)
    oracle = jax_decode_ref(jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
                            jnp.asarray(lens), window=window)
    assert got.dtype == torch.float32 and tuple(got.shape) == (b, 1, h, d)
    for want in (plain.numpy(), np.asarray(oracle)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def _paged_inputs(seed, b, h, hkv, d, page, lengths):
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


# (b, h, hkv, d, page, lengths, splits): a length-0 row walks its whole
# table, page-0 pads included; page 48 puts split boundaries inside pages
PAGED_CASES = [
    (3, 8, 2, 64, 16, (64, 0, 90), 3),
    (2, 4, 1, 32, 48, (200, 17), 4),
    (3, 8, 2, 64, 32, (300, 1, 0), None),
    (2, 16, 1, 32, 16, (0, 0), 2),
]


@pytest.mark.parametrize("case", PAGED_CASES)
def test_paged_decode_split_ref_matches_paged_ref_and_jax_oracle(case):
    import jax.numpy as jnp
    from repro.kernels.ref import paged_decode_ref as jax_paged_ref
    b, h, hkv, d, page, lengths, splits = case
    q, kp, vp, bt, ln = _paged_inputs(sum(lengths) + page, b, h, hkv, d,
                                      page, lengths)
    args = [torch.from_numpy(x) for x in (q, kp, vp, bt, ln)]
    got = paged_decode_split_ref(*args, splits=splits)
    plain = paged_decode_ref(*args)
    oracle = jax_paged_ref(*(jnp.asarray(x) for x in (q, kp, vp, bt, ln)))
    assert tuple(got.shape) == (b, 1, h, d)
    for want in (plain.numpy(), np.asarray(oracle)):
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", DECODE_CASES)
def test_bf16_rounding_stays_within_the_split_limit(case):
    # the head-scaled limit holds an exact result rounded to bf16 (what a
    # correct kernel writes) with room to spare: one ulp is 2^-7 of a value
    b, s, h, hkv, d, lengths, window, _ = case
    q, kc, vc = (torch.from_numpy(x)
                 for x in _decode_inputs(s + b, b, s, h, hkv, d))
    want = decode_ref(q, kc, vc, torch.tensor(lengths), window=window)
    assert head_scaled_err(want.bfloat16(), want) <= SPLIT_REL / 2


# ------------------------------------------------------------------ card
# faults planted in decode_combine_kernel, the merge of the splits: the
# exp of the log2-scaled maxima, no rescale by 2^(m_z - M), split 0 weighed
# twice.  (text of csrc/decode_mma.cuh, its replacement)
_MERGE = "const float f = exp2f(ml[(p0 + z) * 2] - mm);"
MERGE_FAULTS = {
    "exp for exp2": (_MERGE, "const float f = expf(ml[(p0 + z) * 2] - mm);"),
    "no rescale": (_MERGE, "const float f = 1.f;"),
    "split 0 twice": (_MERGE, "const float f = exp2f(ml[(p0 + z) * 2] - mm)"
                              " * (z == 0 ? 2.f : 1.f);"),
}
# (b, s, h, hkv, d, lengths, window): chip_smoke's few long, ragged and
# window cases and the draft's few long rows
SPLIT_CARD = [
    (2, 4096, 32, 8, 128, (4096, 4096), None),
    (3, 4096, 32, 8, 128, (4096, 1500, 0), None),
    (8, 4096, 32, 8, 128, (4096, 3000, 100, 0) * 2, 1024),
    (2, 4096, 2, 1, 64, (4096, 4096), None),
]


@pytest.mark.gpu
def test_planted_merge_faults_fail_the_split_check_on_card(tmp_path,
                                                           monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import _ARGTYPES, flash_decode_cuda
    procs = {}
    for name, (old, new) in MERGE_FAULTS.items():  # one nvcc each, together
        src = tmp_path / name.replace(" ", "_")
        shutil.copytree(_build._CSRC, src)
        body = (src / "decode_mma.cuh").read_text()
        assert body.count(old) == 1
        (src / "decode_mma.cuh").write_text(body.replace(old, new))
        lib = src / "libflash_decode.so"
        # -fno-gnu-unique: a static local of an inline template (the
        # launcher's "shared memory raised" flags) would otherwise be one
        # object across every loaded copy of the library
        procs[name] = (lib, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-Xcompiler", "-fno-gnu-unique",
             "-o", str(lib), str(src / "flash_decode.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    faulty = {}
    for name, (lib, proc) in procs.items():
        out, _ = proc.communicate()
        assert proc.returncode == 0, out
        fn = ctypes.CDLL(str(lib)).flash_decode_fwd
        fn.argtypes, fn.restype = _ARGTYPES, ctypes.c_int
        faulty[name] = fn
    built = _build.function
    for b, s, h, hkv, d, lengths, window in SPLIT_CARD:
        q, kc, vc = (torch.from_numpy(x).cuda().bfloat16()
                     for x in _decode_inputs(s + b, b, s, h, hkv, d))
        ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
        want = decode_ref(q, kc, vc, ln, window=window)
        for name, fn in [("intact", None), *faulty.items()]:
            monkeypatch.setattr(_build, "function",
                                built if fn is None else lambda *a, f=fn: f)
            got = flash_decode_cuda(q, kc, vc, ln, window=window)
            assert flash_decode_cuda.last_splits > 1
            abs_err = (got.float() - want.float()).abs().max().item()
            rel = head_scaled_err(got, want)
            print(f"B={b} S={s} H={h} Hkv={hkv} D={d} lengths={lengths[:4]} "
                  f"window={window} splits={flash_decode_cuda.last_splits} "
                  f"{name}: max_abs_err {abs_err:.3e} head_scaled_err "
                  f"{rel:.3e}")
            assert (rel <= SPLIT_REL) == (fn is None), name
