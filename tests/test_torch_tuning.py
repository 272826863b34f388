"""``repro_torch.kernels.tuning``: the paged decode kernels' split-target
registry and its autotune sweep.

* The registry round trip of the reference (``tests/test_kernels.py``'s
  ``test_tuning_registry_roundtrip``), with the int8 key beside it, and
  the reference's public names.
* ``autotune_paged_decode`` on CPU tensors (the plain split-then-merge
  versions, as the reference sweeps in interpret mode) records its
  winner under the shape's key, fp and int8 pages; the recorded target
  gives the winner's split count back at that shape, and the output of
  ``ops.paged_decode`` is unchanged (the plain version, held to the JAX
  package's at fp32 2e-5).
* With an empty registry the wrappers' split count is
  ``decode_splits(B, Hkv, n, TARGET_BLOCKS)`` (``TARGET_BLOCKS_INT8``
  for int8 pages) over a grid of shapes, and 1 in fp32.
* A forced split count the kernel cannot run (0, more than the row's
  chunks, more than 1 in fp32) raises.
* ``gpu`` cases: the sweep on the card at qwen3-8b's widths, after which
  the wrapper runs the winner's split count (``last_splits``) and its
  output is held to the plain version at 2e-2 and to
  ``decode_split.SPLIT_REL`` of each (row, head)'s largest |value|.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import tuning
from repro_torch.kernels.decode_split import (CHUNK, SPLIT_REL,
                                              TARGET_BLOCKS,
                                              TARGET_BLOCKS_INT8,
                                              decode_splits, head_scaled_err)
from repro_torch.kernels.paged_decode import _splits_and_workspace


@pytest.fixture(autouse=True)
def _clean_registry():
    torch.set_num_threads(2)
    tuning.clear_tunings()
    yield
    tuning.clear_tunings()


def test_public_names_are_the_references():
    from repro.kernels import tuning as jtuning
    assert sorted(tuning.__all__) == sorted(jtuning.__all__)
    assert tuning.DEFAULT_TUNING == tuning.KernelTuning()
    assert tuning.DEFAULT_TUNING.target_blocks is None


def test_tuning_registry_roundtrip():
    assert tuning.tuning_for(16, 64, 2) == tuning.DEFAULT_TUNING
    tuning.record_tuning(16, 64, 2, tuning.KernelTuning(target_blocks=96))
    assert tuning.tuning_for(16, 64, 2).target_blocks == 96
    assert tuning.tuning_for(32, 64, 2) == tuning.DEFAULT_TUNING
    # the int8 pages' key is another key
    assert tuning.tuning_for(16, 64, 2, int8=True) == tuning.DEFAULT_TUNING
    tuning.record_tuning(16, 64, 2, tuning.KernelTuning(target_blocks=8),
                         int8=True)
    assert tuning.tuning_for(16, 64, 2).target_blocks == 96
    assert tuning.tuning_key(16, 64, 2) == (16, 64, 2, False)
    tuning.clear_tunings()
    assert tuning.tuning_for(16, 64, 2, int8=True) == tuning.DEFAULT_TUNING


def _paged(seed, b, h, hkv, d, page, maxp, lengths, quant):
    """q (B, 1, H, D) and pools with distinct pages per row (int8 pages
    with bf16 scales when ``quant``), tables of ``maxp`` entries."""
    from repro_torch.models.attention import kv_quantize
    rng = np.random.default_rng(seed)
    n_pool = 1 + b * maxp
    q = torch.from_numpy(rng.standard_normal((b, 1, h, d), np.float32))
    kp, vp = (torch.from_numpy(rng.standard_normal((n_pool, page, hkv, d),
                                                   np.float32))
              for _ in range(2))
    bt = torch.arange(1, n_pool, dtype=torch.int32).reshape(b, maxp)
    pools = (kp, vp)
    if quant:
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        pools = (kq, vq, ks, vs)
    return q, pools, bt, torch.tensor(lengths, dtype=torch.int32)


# b, h, hkv, d, page, maxp, lengths: 32 pages of 16 are 8 chunks, so a
# target reaches 1 and 2 splits (``MIN_CHUNKS`` chunks a split at least)
SWEEP = (2, 4, 2, 64, 16, 32, (300, 450))


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_autotune_records_winner_and_kernel_output_is_unchanged(quant):
    import jax.numpy as jnp
    from repro.kernels.ref import paged_decode_ref as jax_paged_ref
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import (paged_decode_quant_ref,
                                         paged_decode_ref)
    b, h, hkv, d, page, maxp, lengths = SWEEP
    q, pools, bt, ln = _paged(7, b, h, hkv, d, page, maxp, lengths, quant)
    call = ops.paged_decode_quant if quant else ops.paged_decode
    before = call(q, *pools, bt, ln)
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    times = {}
    t = tuning.autotune_paged_decode(q, *pools[:2], bt, ln, candidates=(1, 2),
                                     iters=1, times=times, **scales)
    z = t.target_blocks // (b * hkv)
    assert z in (1, 2) and sorted(times) == [1, 2]
    assert min(times, key=times.get) == z
    assert tuning.tuning_for(page, d, hkv, int8=quant) == t
    assert tuning.tuning_for(page, d, hkv, int8=not quant) == \
        tuning.DEFAULT_TUNING
    # the recorded target gives the winner's split count back
    qb = q.to(torch.bfloat16)
    assert _splits_and_workspace(qb, page, hkv, maxp * page, quant)[0] == z
    after = call(q, *pools, bt, ln, splits=2)
    assert torch.equal(before, after) and torch.equal(
        after, call(q, *pools, bt, ln))
    if not quant:
        want = jax_paged_ref(*(jnp.asarray(x.numpy())
                               for x in (q, *pools, bt, ln)))
        np.testing.assert_allclose(after.numpy(), np.asarray(want),
                                   atol=2e-5, rtol=0)
    plain = (paged_decode_quant_ref if quant else paged_decode_ref)(
        q, *pools, bt, ln)
    assert torch.equal(after, plain)


def test_autotune_refuses_a_split_count_no_target_reaches():
    b, h, hkv, d, page, maxp, lengths = SWEEP
    q, pools, bt, ln = _paged(8, b, h, hkv, d, page, maxp, lengths, False)
    with pytest.raises(ValueError, match="no target"):
        tuning.autotune_paged_decode(q, *pools, bt, ln, candidates=(1, 3),
                                     iters=1)
    assert tuning.tuning_for(page, d, hkv) == tuning.DEFAULT_TUNING


@pytest.mark.parametrize("int8", [False, True], ids=["fp", "int8"])
def test_empty_registry_keeps_todays_split_counts(int8):
    target = TARGET_BLOCKS_INT8 if int8 else TARGET_BLOCKS
    seen = set()
    for b in (1, 2, 3, 4, 8, 32, 64, 128):
        for hkv in (1, 2, 4, 8):
            for n in (64, 256, 1000, 2048, 4096, 32768):
                want = decode_splits(b, hkv, n, target)
                q = torch.empty((b, 1, hkv, 16), dtype=torch.bfloat16)
                got, work = _splits_and_workspace(q, 16, hkv, n, int8)
                assert got == want, (b, hkv, n)
                assert (work is None) == (want == 1)
                assert _splits_and_workspace(q.float(), 16, hkv, n,
                                             int8)[0] == 1
                seen.add(want)
    assert max(seen) > 2       # the grid reaches split counts above 2


def test_a_forced_split_count_the_kernel_cannot_run_raises():
    n = 16 * 32                                  # 8 chunks
    q = torch.empty((2, 1, 4, 64), dtype=torch.bfloat16)
    for z in (1, 3, n // CHUNK):
        assert _splits_and_workspace(q, 16, 2, n, False, z)[0] == z
    for z in (0, -1, n // CHUNK + 1):
        with pytest.raises(ValueError, match="splits"):
            _splits_and_workspace(q, 16, 2, n, False, z)
    with pytest.raises(ValueError, match="splits"):
        _splits_and_workspace(q.float(), 16, 2, n, True, 2)
    assert _splits_and_workspace(q.float(), 16, 2, n, True, 1)[0] == 1


def _card_sweep(quant):
    """The sweep at qwen3-8b's widths on the card (32 rows x 1024
    positions in pages of 16), then the tuned wrapper."""
    from repro_torch.kernels import ops, paged_decode
    from repro_torch.kernels.ref import (paged_decode_quant_ref,
                                         paged_decode_ref)
    from repro_torch.models.attention import kv_quantize
    b, h, hkv, d, page, maxp = 32, 32, 8, 128, 16, 64
    g = torch.Generator("cuda").manual_seed(11)
    n_pool = 1 + b * maxp
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn((n_pool, page, hkv, d), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    pools = (kp, vp)
    if quant:
        (kq, ks), (vq, vs) = kv_quantize(kp), kv_quantize(vp)
        pools = (kq, vq, ks, vs)
    bt = torch.arange(1, n_pool, dtype=torch.int32,
                      device="cuda").reshape(b, maxp)
    ln = torch.full((b,), maxp * page, dtype=torch.int32, device="cuda")
    scales = dict(k_scale=pools[2], v_scale=pools[3]) if quant else {}
    times = {}
    t = tuning.autotune_paged_decode(q, *pools[:2], bt, ln, iters=5,
                                     times=times, **scales)
    z = t.target_blocks // (b * hkv)
    kernel = (paged_decode.paged_decode_int8_cuda if quant
              else paged_decode.paged_decode_cuda)
    got = (ops.paged_decode_quant if quant else ops.paged_decode)(
        q, *pools, bt, ln)
    torch.cuda.synchronize()
    want = (paged_decode_quant_ref if quant else paged_decode_ref)(
        q, *pools, bt, ln)
    return z, times, kernel.last_splits, got, want


@pytest.mark.gpu
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_autotune_on_card_tunes_the_wrapper(quant):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    z, times, last, got, want = _card_sweep(quant)
    assert sorted(times) == [1, 2, 3, 4] and min(times, key=times.get) == z
    assert last == z
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    if z > 1:
        assert head_scaled_err(got, want) <= SPLIT_REL


@pytest.mark.gpu
def test_forced_split_counts_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import ops, paged_decode
    from repro_torch.kernels.ref import paged_decode_ref
    b, h, hkv, d, page, maxp = 2, 32, 8, 128, 16, 32
    g = torch.Generator("cuda").manual_seed(12)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").bfloat16()
    kp, vp = (torch.randn((1 + b * maxp, page, hkv, d), generator=g,
                          device="cuda").bfloat16() for _ in range(2))
    bt = torch.arange(1, 1 + b * maxp, dtype=torch.int32,
                      device="cuda").reshape(b, maxp)
    ln = torch.tensor([maxp * page, 300], dtype=torch.int32, device="cuda")
    want = paged_decode_ref(q, kp, vp, bt, ln)
    chunks = maxp * page // CHUNK
    for z in (1, 5, chunks):
        got = ops.paged_decode(q, kp, vp, bt, ln, splits=z)
        torch.cuda.synchronize()
        assert paged_decode.paged_decode_cuda.last_splits == z
        assert (got.float() - want.float()).abs().max().item() <= 2e-2
    for z in (0, chunks + 1):
        with pytest.raises(ValueError, match="splits"):
            ops.paged_decode(q, kp, vp, bt, ln, splits=z)
