"""Plain attention on tensors: the oracles the CUDA kernels are held to.

Port of ``repro.models.attention``: the masking constant,
``reference_attention`` (naive masked softmax over the whole sequence),
``decode_attention`` with per-row cache lengths, the multi-token
``verify_attention`` of speculative decoding, and the int8 KV codec
``kv_quantize`` / ``kv_dequantize``.  Masked scores take the
finite constant below, never ``-inf``: ``exp`` then underflows cleanly, a
fully masked row averages V uniformly instead of producing NaN, and the
kernels use the same constant so the two cannot disagree on what "masked"
means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

_NEG_INF = -1e30


def _expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B, S, Hkv, D) -> (B, S, H, D) by repeating kv heads (GQA)."""
    hkv = k.shape[2]
    if hkv == n_heads:
        return k
    return torch.repeat_interleave(k, n_heads // hkv, dim=2)


def attention_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
                   window: Optional[int]) -> torch.Tensor:
    """(Sq, Skv) boolean 'attend' mask from absolute positions."""
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def reference_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0) -> torch.Tensor:
    """Naive O(S^2) attention.  q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D);
    ``q_offset`` is the absolute position of q[0]."""
    _, sq, h, d = q.shape
    skv = k.shape[1]
    kf = _expand_kv(k, h).float()
    vf = _expand_kv(v, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (d ** 0.5)
    q_pos = torch.arange(sq, device=q.device) + q_offset
    k_pos = torch.arange(skv, device=q.device)
    mask = attention_mask(q_pos, k_pos, causal, window)
    scores = torch.where(mask[None, None], scores,
                         torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def verify_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor,
                     base_len: torch.Tensor) -> torch.Tensor:
    """Multi-token verify attention: K query tokens appended to a cache of
    ``base_len`` valid positions, causal among themselves.

    q: (B, K, H, D); k_cache/v_cache: (B, S, Hkv, D) with the K new tokens'
    KV already at positions ``base_len .. base_len+K-1``; base_len: () or
    (B,) integer.  Query j attends positions ``<= base_len + j``; with K == 1
    this is ``decode_attention(q, k, v, base_len + 1)``.
    """
    _, kq, h, d = q.shape
    s = k_cache.shape[1]
    kf = _expand_kv(k_cache, h).float()
    vf = _expand_kv(v_cache, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (d ** 0.5)
    pos = torch.arange(s, device=q.device)
    limit = (torch.as_tensor(base_len, device=q.device).reshape(-1, 1)
             + torch.arange(kq, device=q.device)[None, :])          # (B|1, K)
    valid = pos[None, None, :] <= limit[..., None]                # (B|1, K, S)
    scores = torch.where(valid[:, None], scores,
                         torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, cache_len: torch.Tensor, *,
                     window: Optional[int] = None) -> torch.Tensor:
    """Single-token decode attention over a partially filled cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, Hkv, D); cache_len: () or (B,)
    integer -- the query attends to positions < cache_len.
    """
    _, _, h, d = q.shape
    s = k_cache.shape[1]
    kf = _expand_kv(k_cache, h).float()
    vf = _expand_kv(v_cache, h).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) / (d ** 0.5)
    pos = torch.arange(s, device=q.device)
    lens = torch.as_tensor(cache_len, device=q.device).reshape(-1, 1)
    valid = pos[None, :] < lens                                  # (B|1, S)
    if window is not None:
        valid &= pos[None, :] >= lens - window
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.full((), _NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, vf)
    return out.to(q.dtype)


def kv_quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 per-(token, head) quantization of K/V.

    x: (..., D) -> (int8 values (..., D), bf16 scales (..., 1)).  In fp32:
    the scale is max|x| / 127 floored at 1e-8; values are divided by it,
    rounded half to even and clipped to +-127.  The scale is stored as
    bf16, so dequantization multiplies by the rounded scale.  XLA on the
    CPU lowers the reference's division as a true division, as here; the
    tests pin the two bit-equal."""
    xf = x.float()
    scale = torch.clamp(xf.abs().amax(dim=-1, keepdim=True) / 127.0,
                        min=1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def kv_dequantize(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """int8 values times their scales, in fp32, cast to ``dtype``."""
    return (q.float() * scale.float()).to(dtype)
