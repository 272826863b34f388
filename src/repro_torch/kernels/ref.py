"""Plain PyTorch versions of the kernels: the CPU path and the oracles the
CUDA kernels are compared with on the card.

Port of ``repro.kernels.ref`` (``flash_ref``, ``decode_ref``,
``paged_decode_ref``, ``paged_decode_quant_ref``, ``verify_ref``,
``paged_verify_ref``, ``paged_verify_quant_ref``).  They repeat
the kernels' arithmetic in float32 with whole-tensor operations; they are
no yardstick of speed.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.attention import (decode_attention, kv_dequantize,
                                          reference_attention,
                                          verify_attention)

# plain version of the contiguous decode kernel: q (B, 1, H, D), caches
# (B, S, Hkv, D), cache_len () or (B,), optional window
decode_ref = decode_attention
# plain version of multi-token verify over a contiguous cache: q (B, K, H, D)
verify_ref = verify_attention


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


def paged_verify_ref(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the paged verify kernel: gather each row's pages,
    then ``verify_attention``.  q: (B, K, H, D), the K new tokens' KV
    already in the pool at positions ``lengths[b] .. lengths[b]+K-1``;
    pools and tables as in ``paged_decode_ref``; lengths: (B,) int32 valid
    tokens per row before the K new ones.  Query j attends positions
    ``<= lengths[b] + j`` of the table's ``maxp * page``.  Returns
    (B, K, H, D)."""
    k = _gather_pages(k_pool, block_tables)
    v = _gather_pages(v_pool, block_tables)
    return verify_attention(q, k, v, lengths)


def _gather_dequantized(pool: torch.Tensor, scale_pool: torch.Tensor,
                        block_tables: torch.Tensor,
                        dtype: torch.dtype) -> torch.Tensor:
    """Gather an int8 pool's pages and their (P, page, Hkv, 1) scales
    through the block table, then dequantize to ``dtype``."""
    return kv_dequantize(_gather_pages(pool, block_tables),
                         _gather_pages(scale_pool, block_tables), dtype)


def paged_decode_quant_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 paged decode kernel: int8 pools
    (P, page, Hkv, D) with bf16 scale pools (P, page, Hkv, 1) riding the
    same block table; gather pages and scales, dequantize to q's dtype,
    then ``paged_decode_ref``'s attention.  Returns (B, 1, H, D)."""
    k = _gather_dequantized(k_pool, k_scale, block_tables, q.dtype)
    v = _gather_dequantized(v_pool, v_scale, block_tables, q.dtype)
    return decode_attention(q, k, v, lengths)


def paged_verify_quant_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Plain version of the int8 paged verify kernel: as
    ``paged_decode_quant_ref``, then ``paged_verify_ref``'s attention (query
    j sees positions ``<= lengths[b] + j``).  Returns (B, K, H, D)."""
    k = _gather_dequantized(k_pool, k_scale, block_tables, q.dtype)
    v = _gather_dequantized(v_pool, v_scale, block_tables, q.dtype)
    return verify_attention(q, k, v, lengths)
