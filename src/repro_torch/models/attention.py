"""Plain attention on tensors: the oracles the CUDA kernels are held to.

Port of ``repro.models.attention``: the masking constant,
``reference_attention`` (naive masked softmax over the whole sequence),
``decode_attention`` with per-row cache lengths, the multi-token
``verify_attention`` of speculative decoding, the int8 KV codec
``kv_quantize`` / ``kv_dequantize``, and the mesh layer's
``decode_attention_seqsharded``.  Masked scores take the
finite constant below, never ``-inf``: ``exp`` then underflows cleanly, a
fully masked row averages V uniformly instead of producing NaN, and the
kernels use the same constant so the two cannot disagree on what "masked"
means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.compat import meshenv

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
    """Naive O(S^2) attention in float32 (float64 for float64 inputs).
    q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D); ``q_offset`` is the
    absolute position of q[0]."""
    _, sq, h, d = q.shape
    skv = k.shape[1]
    acc = torch.promote_types(q.dtype, torch.float32)   # float64 stays
    kf = _expand_kv(k, h).to(acc)
    vf = _expand_kv(v, h).to(acc)
    scores = torch.einsum("bqhd,bkhd->bhqk", q.to(acc), kf) / (d ** 0.5)
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


def _write_local(cache: torch.Tensor, new: torch.Tensor, slot: torch.Tensor,
                 in_range: torch.Tensor) -> None:
    """cache[:, slot] = new[:, 0] where ``in_range``, in place; slot: a 0-d
    index already clamped into the cache."""
    idx = slot.reshape(1)
    old = cache.index_select(1, idx)
    cache.index_copy_(1, idx, torch.where(in_range, new.to(cache.dtype), old))


def _full(x) -> torch.Tensor:
    """A replicated DTensor's value, or a plain tensor, as a plain one."""
    return x.to_local() if isinstance(x, DTensor) else torch.as_tensor(x)


def decode_attention_seqsharded(q: torch.Tensor, k_cache: torch.Tensor,
                                v_cache: torch.Tensor, k_new: torch.Tensor,
                                v_new: torch.Tensor, slot, cache_len, *,
                                scales: Optional[tuple] = None):
    """Sequence-sharded decode: each ``model`` rank writes and attends
    only its own chunk of the cache.

    q: (B, 1, H, D); k_cache/v_cache: (B, S, Hkv, D) DTensors, the batch
    over the data axes and the sequence over ``model``: rank ``r`` of
    ``model`` holds positions ``[r * S/m, (r + 1) * S/m)``; k_new/v_new:
    (B, 1, Hkv, D); slot, cache_len: 0-d, every row's write slot and valid
    length.  Each rank (a) writes the new K/V into its chunk, in place,
    only if ``slot`` falls there -- no communication -- and (b) takes the
    float32 partial max ``m``, sum ``l`` and output ``o`` over its chunk;
    an all-reduce MAX of ``m`` and SUM of ``l`` and ``o`` on the model
    group combines them, as the reference's ``pmax``/``psum`` do.  The
    partial is plain torch, as the reference's is plain ``jnp`` outside
    any kernel.  With ``scales`` = (k_scale cache, v_scale cache, new k
    scales, new v scales) the caches are int8, written and dequantized in
    the chunk.

    With no mesh, or no ``model`` axis, every row's K/V go to ``slot`` in
    place and the step attends through ``kernels.ops.decode``, the port's
    counterpart of the reference's fallback ``decode_attention``.

    Returns (out (B, 1, H, D), k_cache, v_cache[, k_scale, v_scale]), the
    caches being the given ones, updated in place.
    """
    quant = scales is not None
    caches = [k_cache, v_cache] + (list(scales[:2]) if quant else [])
    news = [k_new, v_new] + (list(scales[2:]) if quant else [])
    mesh = meshenv.current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        from repro_torch.kernels import ops
        idx = torch.as_tensor(slot, device=q.device).long().reshape(1)
        for c, n in zip(caches, news):
            c.index_copy_(1, idx, n.to(c.dtype))
        kf, vf = caches[:2]
        if quant:
            kf = kv_dequantize(kf, caches[2], q.dtype)
            vf = kv_dequantize(vf, caches[3], q.dtype)
        lens = torch.as_tensor(cache_len, device=q.device).to(
            torch.int32).reshape(-1).expand(q.shape[0])
        return (ops.decode(q, kf, vf, lens), *caches)
    names = tuple(mesh.mesh_dim_names)
    bx = [a for a in ("pod", "data") if a in names]
    b_dims = ({a: 0 for a in bx} if bx and q.shape[0] % meshenv.mesh_size(
        mesh, tuple(bx)) == 0 else {})
    rep = meshenv.placed(mesh, b_dims)
    seq = meshenv.placed(mesh, {**b_dims, "model": 1})
    for c in caches:
        if not isinstance(c, DTensor) or list(c.placements) != seq:
            raise ValueError(f"the cache must be a DTensor placed {seq}")

    def local(t):
        if not isinstance(t, DTensor):
            t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
        return t.redistribute(mesh, rep).to_local()

    q_l = local(q)
    new_l = [local(n) for n in news]
    cache_l = [c.to_local() for c in caches]
    s_loc = cache_l[0].shape[1]
    shard = mesh.get_local_rank("model")
    local_slot = _full(slot).long() - shard * s_loc
    in_range = (local_slot >= 0) & (local_slot < s_loc)
    safe = torch.clamp(local_slot, 0, s_loc - 1)
    for c, n in zip(cache_l, new_l):
        _write_local(c, n, safe, in_range)
    if quant:
        kf = kv_dequantize(cache_l[0], cache_l[2], torch.float32)
        vf = kv_dequantize(cache_l[1], cache_l[3], torch.float32)
    else:
        kf, vf = cache_l[0].float(), cache_l[1].float()
    bl, _, h, d = q_l.shape
    hkv = kf.shape[2]
    qg = q_l.reshape(bl, hkv, h // hkv, d).float()
    sc = torch.einsum("bgrd,bkgd->bgrk", qg, kf) / (d ** 0.5)
    pos = shard * s_loc + torch.arange(s_loc, device=sc.device)
    valid = pos[None, :] < _full(cache_len).reshape(-1, 1)
    sc = torch.where(valid[:, None, None, :], sc,
                     torch.full((), _NEG_INF, device=sc.device))
    group = mesh.get_group("model")
    m = funcol.all_reduce(sc.amax(-1), "max", group)
    p = torch.exp(sc - m[..., None])
    l_sum = funcol.all_reduce(p.sum(-1), "sum", group)
    o = funcol.all_reduce(torch.einsum("bgrk,bkgd->bgrd", p, vf), "sum",
                          group)
    out = (o / torch.clamp(l_sum, min=1e-30)[..., None]).reshape(bl, 1, h, d)
    out = DTensor.from_local(out.to(q_l.dtype).contiguous(), mesh, rep,
                             run_check=False)
    return (out, *caches)
