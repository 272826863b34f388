"""Plain PyTorch versions of the kernels: the CPU path and the oracles the
CUDA kernels are compared with on the card.

Port of ``repro.kernels.ref`` (``flash_ref``, ``decode_ref``,
``paged_decode_ref``, ``paged_decode_quant_ref``, ``verify_ref``,
``paged_verify_ref``, ``paged_verify_quant_ref``).  They repeat
the kernels' arithmetic in float32 with whole-tensor operations; they are
no yardstick of speed.  ``decode_split_ref``, ``paged_decode_split_ref``
and ``paged_decode_quant_split_ref`` repeat the bf16 decode kernels'
split-then-merge (flash-decoding) and compute the same function as
``decode_ref``, ``paged_decode_ref`` and ``paged_decode_quant_ref``; the
tests hold them to it, and no path calls them.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_split import (TARGET_BLOCKS_INT8,
                                              decode_splits, split_ranges,
                                              target_blocks)
from repro_torch.models.attention import (_NEG_INF, _expand_kv,
                                          decode_attention, kv_dequantize,
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


def decode_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, lengths: torch.Tensor, *,
                     window: Optional[int] = None,
                     splits: Optional[int] = None) -> torch.Tensor:
    """``decode_ref`` as the bf16 decode kernel splits it: each split of
    ``split_ranges(S, splits)`` (default ``decode_splits(B, Hkv, S,
    target_blocks(D))``) takes its partial max ``m``, sum ``l`` and
    unnormalised ``acc`` over its positions of the row's walk, in float32,
    and the partials merge as
    ``sum exp(m - M) acc / max(sum exp(m - M) l, 1e-30)``, ``M`` their
    max.  The walk is ``[max(0, len - window), min(len, S))``; a row whose
    walk is empty (a dead row) walks all S positions at -1e30 and averages
    V.  Outside the walk a position scores -inf; ``m`` starts at -1e30, so
    a split with no position of the walk adds nothing.  q: (B, 1, H, D);
    caches (B, S, Hkv, D); lengths (B,) -> (B, 1, H, D)."""
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if splits is None:
        splits = decode_splits(b, hkv, s, target_blocks(d))
    kf = _expand_kv(k_cache, h).float()
    vf = _expand_kv(v_cache, h).float()
    scores = torch.einsum("bhd,bkhd->bhk", q[:, 0].float(), kf) / (d ** 0.5)
    pos = torch.arange(s, device=q.device)[None, :]
    lens = torch.as_tensor(lengths, device=q.device).reshape(-1, 1)
    lo = (lens - window).clamp(min=0) if window is not None else 0 * lens
    hi = lens.clamp(max=s)
    dead = hi <= lo                                             # (B, 1)
    walk = torch.where(dead, pos < s, (pos >= lo) & (pos < hi))
    x = torch.where(dead[:, :, None], torch.full_like(scores, _NEG_INF),
                    scores)
    x = torch.where(walk[:, None, :], x, torch.full_like(x, -float("inf")))
    ms, ls, accs = [], [], []
    for s0, s1 in split_ranges(s, splits):
        xs = x[..., s0:s1]                                      # (B, H, n)
        m = torch.full(xs.shape[:2], _NEG_INF, device=q.device)
        if s1 > s0:
            m = torch.maximum(m, xs.amax(dim=-1))
        p = torch.exp(xs - m[..., None])
        ms.append(m)
        ls.append(p.sum(dim=-1))
        accs.append(torch.einsum("bhk,bkhd->bhd", p, vf[:, s0:s1]))
    m = torch.stack(ms)                                         # (Z, B, H)
    f = torch.exp(m - m.amax(dim=0))
    l_sum = (f * torch.stack(ls)).sum(dim=0).clamp(min=1e-30)
    out = (f[..., None] * torch.stack(accs)).sum(dim=0) / l_sum[..., None]
    return out[:, None].to(q.dtype)


def paged_decode_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor, *,
                           splits: Optional[int] = None) -> torch.Tensor:
    """``paged_decode_ref`` as the bf16 paged decode kernel splits it: the
    row's pages gathered, then ``decode_split_ref`` over its
    ``maxp * page`` positions (default splits ``decode_splits(B, Hkv,
    maxp * page)``)."""
    k = _gather_pages(k_pool, block_tables)
    v = _gather_pages(v_pool, block_tables)
    return decode_split_ref(q, k, v, lengths, splits=splits)


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


def paged_decode_quant_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                 v_pool: torch.Tensor, k_scale: torch.Tensor,
                                 v_scale: torch.Tensor,
                                 block_tables: torch.Tensor,
                                 lengths: torch.Tensor, *,
                                 splits: Optional[int] = None) -> torch.Tensor:
    """``paged_decode_quant_ref`` as the bf16 int8 paged decode kernel
    splits it: pages and scales gathered and dequantized to q's dtype, then
    ``decode_split_ref`` over the row's ``maxp * page`` positions (default
    splits ``decode_splits(B, Hkv, maxp * page, TARGET_BLOCKS_INT8)``)."""
    k = _gather_dequantized(k_pool, k_scale, block_tables, q.dtype)
    v = _gather_dequantized(v_pool, v_scale, block_tables, q.dtype)
    if splits is None:
        splits = decode_splits(q.shape[0], k_pool.shape[2], k.shape[1],
                               TARGET_BLOCKS_INT8)
    return decode_split_ref(q, k, v, lengths, splits=splits)


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
