"""How the bf16 decode kernels cut a row across blocks (flash-decoding).

The tensor-core decode body (``csrc/decode_mma.cuh``) runs one block per
(kv head, batch row, split).  Split ``z`` of ``splits`` walks a fixed range
of whole 64-position chunks of the row's ``n`` positions (``split_ranges``;
the wrappers pass the kernel its length, ``split_span``), and a second
kernel merges the splits' partial softmax sums.  The host chooses
``splits`` from the batch, the kv heads and ``n`` alone: the lengths lie on
the card, and reading them would synchronise.  The decode wrappers call
``decode_splits`` (the int8-page one, and the contiguous one at head
width 256, with their own targets);
``kernels.ref.decode_split_ref``, ``paged_decode_split_ref`` and
``paged_decode_quant_split_ref`` repeat the split-then-merge in plain
PyTorch.
"""

from __future__ import annotations

from typing import List, Tuple

CHUNK = 64            # positions a block stages per step (kChunk)
TARGET_BLOCKS = 264   # two blocks of 4 warps on each of the H100's 132 SMs
# at head width 256 a block's ring and query slice take 200 KB of shared
# memory, so one block fits an SM: one wave of blocks
TARGET_BLOCKS_D256 = 132
# the int8-page body (70 KB of shared memory: three blocks share an SM) is
# bound by the latency of its walk on long rows and gains from more, shorter
# blocks: about two waves of three blocks on each SM (3 splits of 32 rows x
# 4096, where 1 and 2 are slower: chip_smoke.py's int8_split_sweep, PERF.md)
TARGET_BLOCKS_INT8 = 792
MIN_CHUNKS = 4        # chunks a split walks, at the least (but the last)
# a split output is held, besides the absolute bf16 tolerance, to this share
# of each (row, head)'s largest |plain| value: rounding to bf16 moves an
# element by at most one ulp, 2^-7 of its magnitude, where a fault in the
# merge of the splits (a weight or a rescale) moves it by tens of percent
SPLIT_REL = 2e-2


def decode_splits(b: int, hkv: int, n: int,
                  target: int = TARGET_BLOCKS) -> int:
    """Splits of a row's ``n`` positions for ``b`` rows of ``hkv`` kv
    heads: 1 when the ``b * hkv`` blocks already come near ``target``
    (``TARGET_BLOCKS``; the int8-page kernel's ``TARGET_BLOCKS_INT8``) or
    the row is only a few chunks long; else about ``target`` blocks in all,
    each split ``MIN_CHUNKS`` chunks or more, every split non-empty."""
    blocks = b * hkv
    chunks = -(-n // CHUNK)
    splits = min((target + blocks // 2) // blocks, chunks // MIN_CHUNKS)
    if splits <= 1:
        return 1
    per = -(-chunks // splits)
    return -(-chunks // per)


def target_blocks(d: int) -> int:
    """The bf16 contiguous decode kernel's target at head width ``d``."""
    return TARGET_BLOCKS_D256 if d == 256 else TARGET_BLOCKS


def split_span(n: int, splits: int) -> int:
    """Positions each of ``splits`` splits of ``[0, n)`` walks, the
    argument the kernel takes: ``ceil(ceil(n / CHUNK) / splits)`` whole
    chunks, so that ``splits`` of them cover ``n``."""
    return -(-(-(-n // CHUNK)) // splits) * CHUNK


def split_ranges(n: int, splits: int) -> List[Tuple[int, int]]:
    """Positions ``[start, end)`` of each split of ``[0, n)``, the ranges
    the kernel walks: ``split_span(n, splits)`` positions each, the last
    ones cut at ``n`` (empty when ``splits`` exceeds the chunks)."""
    span = split_span(n, splits)
    return [(min(z * span, n), min((z + 1) * span, n))
            for z in range(splits)]


def head_scaled_err(got, want) -> float:
    """The largest ``|got - want|`` of each (row, head) of two (B, 1, H,
    D) outputs over that head's largest ``|want|``, at most over all
    heads: what ``SPLIT_REL`` bounds."""
    g, w = got.float(), want.float()
    return ((g - w).abs().amax(-1) / w.abs().amax(-1)).max().item()
