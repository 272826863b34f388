"""Plain PyTorch versions of the kernels: the CPU path and the oracles the
CUDA kernels are compared with on the card.

Port of ``repro.kernels.ref`` (``flash_ref``, ``paged_decode_ref``).  They
repeat the kernels' arithmetic in float32 with whole-tensor operations;
they are no yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import decode_attention, reference_attention


def flash_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Plain version of the prefill attention kernel.  q: (B, Sq, H, D),
    k/v: (B, Skv, Hkv, D) -> (B, Sq, H, D); the masked softmax of
    ``reference_attention`` (the reference's chunked ``flash_attention``
    computes the same function)."""
    return reference_attention(q, k, v, causal=causal, window=window)


def _gather_pages(pool: torch.Tensor,
                  block_tables: torch.Tensor) -> torch.Tensor:
    """(P, page, ...) pool + (B, maxp) table -> (B, maxp*page, ...)."""
    b, maxp = block_tables.shape
    page = pool.shape[1]
    return pool[block_tables.long()].reshape((b, maxp * page)
                                             + tuple(pool.shape[2:]))


def paged_decode_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the paged decode kernel: gather each row's pages
    into a contiguous (B, maxp*page, Hkv, D) view, then decode attention
    with per-row lengths.  q: (B, 1, H, D); pools: (P, page, Hkv, D);
    block_tables: (B, maxp) int32 (entries past a row's allocation point at
    the scratch page 0); lengths: (B,) int32.  Returns (B, 1, H, D)."""
    k = _gather_pages(k_pool, block_tables)
    v = _gather_pages(v_pool, block_tables)
    return decode_attention(q, k, v, lengths)
