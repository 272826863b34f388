"""Dense decoder-only transformer (the qwen3 family) on tensors.

Port of the serving paths of ``repro.models.dense``: ``init``,
right-padded ``prefill`` with ``last_positions``, the slot cache
(``init_cache``, ``decode_step`` with (B,) lengths), the KV page pools
(``init_paged_pools``, ``prefill_to_pages``, ``_scatter_pool_writes``),
``paged_decode_step`` and the speculative ``paged_verify_step``.  Public
functions keep the reference's layouts: weights ``(d_in, d_out)`` stacked
on a leading layer axis, slot caches ``(L, B, C, Hkv, dh)``, pools
``(L, P, page, Hkv, dh)``.

Attention goes through ``kernels.ops``: the prefill through the prefill
kernel (where the reference calls its jnp ``flash_attention``), a slot
decode step through the contiguous decode kernel (the reference's jnp
``decode_attention``), a paged decode or verify step through the paged
decode or verify kernel (where the reference gathers pages and calls its
jnp ``decode_attention`` or ``verify_attention``).  The projections and
the MLP stay ``torch.matmul``, as the reference leaves them to XLA.

Unlike the reference, whose arrays are immutable, slot caches and pools
are updated in place (``index_put_``) so decode never copies them; a
caller must not keep a view of a cache across steps and expect it
unchanged.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.config import ModelConfig

_POOLS = ("k_pool", "v_pool")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------- init
def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """Random weights with the reference's distributions (normal
    ``1/sqrt(d_in)`` projections, normal 0.02 embeddings, unit norms),
    drawn from ``generator`` on ``device`` in ``dtype`` (default
    ``cfg.dtype``).  Only the qwen3 layout (RMSNorm, SwiGLU, qk-norm, no
    bias, sequential block, untied head) is ported."""
    if (cfg.norm_type != "rmsnorm" or cfg.act != "swiglu" or cfg.use_bias
            or cfg.parallel_block or cfg.tie_embeddings or cfg.mrope):
        raise NotImplementedError(
            f"{cfg.name}: only the qwen3 dense layout is ported; the other "
            f"dense variants are ROADMAP Queue A item 2")
    dt = dtype or _dt(cfg)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def w(*shape):
        return cm.dense_init(generator, (L,) + shape, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    lyr: Dict = {
        "ln1": {"scale": ones(L, d)},
        "wq": w(d, cfg.q_dim), "wk": w(d, cfg.kv_dim), "wv": w(d, cfg.kv_dim),
        "wo": w(cfg.q_dim, d),
        "ln2": {"scale": ones(L, d)},
        "w_gate": w(d, f), "w_up": w(d, f), "w_down": w(f, d),
    }
    if cfg.qk_norm:
        lyr["q_norm"] = ones(L, cfg.head_dim)
        lyr["k_norm"] = ones(L, cfg.head_dim)
    return {
        "embed": cm.embed_init(generator, cfg.padded_vocab, d, dt, device),
        "final_norm": {"scale": ones(d)},
        "lm_head": cm.dense_init(generator, (d, cfg.padded_vocab), dt, device),
        "layers": lyr,
    }


def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of the stacked weights (views, no copies)."""
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in params["layers"].items()}


# ---------------------------------------------------------------- sub-blocks
def _project_qkv(lp: Dict, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (B, S, d) -> roped q (B, S, H, dh), k/v (B, S, Hkv, dh)."""
    b, s, _ = h.shape
    q = (h @ lp["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ lp["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ lp["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = cm.rms_norm(q, lp["q_norm"])
        k = cm.rms_norm(k, lp["k_norm"])
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _mlp(lp: Dict, h: torch.Tensor) -> torch.Tensor:
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _finish_block(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                  attn: torch.Tensor) -> torch.Tensor:
    """Output projection, residual, then the MLP sub-block."""
    b, s = x.shape[:2]
    x = x + attn.reshape(b, s, cfg.q_dim) @ lp["wo"]
    return x + _mlp(lp, cm.apply_norm(x, lp["ln2"], cfg.norm_type))


def logits_of(params: Dict, x: torch.Tensor) -> torch.Tensor:
    return x @ params["lm_head"]


# ------------------------------------------------------------------ prefill
def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            capacity: Optional[int] = None,
            last_positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, build the KV cache, return last-position logits.

    tokens: (B, S) right-padded prompts (pads are causally inert).  The
    cache holds ``capacity`` positions (default S; zero-padded past S), or
    for a sliding-window config a ring of ``sliding_window`` positions
    where position p sits at slot p % window.  ``last_positions`` ((B,))
    takes each row's logits at its own final real token.  Returns
    (logits (B, 1, padded_vocab), {"k", "v": (L, B, cap, Hkv, dh),
    "length": S}).
    """
    b, s = tokens.shape
    x = params["embed"][tokens]
    positions = torch.arange(s, device=tokens.device).expand(b, s)
    if cfg.sliding_window is None:
        cap = max(s, capacity or s)
    else:
        cap = min(cfg.sliding_window, capacity or cfg.sliding_window)
    ks, vs = [], []
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, positions)
        attn = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = _finish_block(lp, cfg, x, attn)
        ks.append(k)
        vs.append(v)

    def ring(a: torch.Tensor) -> torch.Tensor:
        # (L, B, S, Hkv, dh) -> (L, B, cap, Hkv, dh)
        if cap <= s:
            return torch.roll(a[:, :, -cap:], shifts=s % cap, dims=2)
        return F.pad(a, (0, 0, 0, 0, 0, cap - s))

    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    if last_positions is None:
        x_last = x[:, -1:]
    else:
        x_last = x[torch.arange(b, device=x.device),
                   last_positions.long()][:, None]
    cache = {"k": ring(torch.stack(ks)), "v": ring(torch.stack(vs)),
             "length": s}
    return logits_of(params, x_last), cache


# ---------------------------------------------------------------- slot decode
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: Optional[torch.dtype] = None,
               device: torch.device | str = "cpu") -> Dict:
    """A zero slot cache {"k", "v": (L, batch, cap, Hkv, dh), "length": ()}
    (cap = ``capacity``, or the window of a sliding-window config)."""
    cap = (capacity if cfg.sliding_window is None
           else min(capacity, cfg.sliding_window))
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype or _dt(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "length": torch.zeros((), dtype=torch.int32, device=device)}


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step against a slot cache, each row at its own depth.

    cache: {"k"/"v": (L, B, C, Hkv, dh), "length": (B,) int32}; token:
    (B, 1).  Row b's new KV goes to slot ``length[b] % C`` of its cache row,
    in place, then it attends its ``min(length[b] + 1, C)`` valid
    positions.  Returns (logits (B, 1, padded_vocab), cache with length +
    1).  The reference's scalar-length lock-step branch (wave batching and
    the sequence-sharded decode) is ROADMAP Queue A items 7 and 10; int8
    caches are item 5."""
    length = cache["length"]
    if length.ndim != 1:
        raise NotImplementedError(
            "scalar cache length (lock-step wave decode): ROADMAP Queue A "
            "items 7 and 10; the slot engine passes (B,) lengths")
    if cfg.kv_quant:
        raise NotImplementedError("int8 slot caches: ROADMAP Queue A item 5")
    x = params["embed"][token]
    cap = cache["k"].shape[2]
    lens = length.long()
    rows = torch.arange(lens.shape[0], device=lens.device)
    slot = lens % cap
    n_valid = torch.clamp(lens + 1, max=cap).to(torch.int32)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, lens[:, None])
        kc.index_put_((rows, slot), k[:, 0])
        vc.index_put_((rows, slot), v[:, 0])
        attn = ops.decode(q, kc, vc, n_valid)
        x = _finish_block(lp, cfg, x, attn)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, x), {"k": cache["k"], "v": cache["v"],
                                  "length": (length + 1).to(length.dtype)}


# --------------------------------------------------------------- paged pools
def init_paged_pools(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: torch.device | str = "cpu") -> Dict:
    """The shared KV page pools {"k_pool", "v_pool"}, each
    (L, P, page, Hkv, dh) zeros.  Page 0 is the engine's scratch page:
    writes of rows without an allocated page land there and are never
    attended.  int8 pools (``cfg.kv_quant``) are ROADMAP Queue B row 2q."""
    if cfg.kv_quant:
        raise NotImplementedError("int8 KV pages: ROADMAP Queue B row 2q")
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    dt = dtype or _dt(cfg)
    return {n: torch.zeros(shape, dtype=dt, device=device) for n in _POOLS}


def prefill_to_pages(pools: Dict, kv: Dict,
                     phys_pages: torch.Tensor) -> Dict:
    """Scatter a contiguous prefill cache into pool pages, in place.

    kv: {"k", "v"} (L, n, plen, Hkv, dh) with plen a multiple of the page
    size; phys_pages: (n, plen // page) physical page per (row, logical
    page) -- entries past a row's real prompt point at the scratch page 0
    (several rows may alias it).  Returns ``pools``."""
    page = pools["k_pool"].shape[2]
    idx = phys_pages.long()
    for pname in _POOLS:
        src = kv[pname[:-5]]
        L, n, plen = src.shape[:3]
        src = src.reshape((L, n, plen // page, page) + tuple(src.shape[3:]))
        pools[pname][:, idx] = src.to(pools[pname].dtype)
    return pools


def _scatter_pool_writes(pools: Dict, l: int, phys_page: torch.Tensor,
                         page_slot: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, squeeze: bool) -> None:
    """Write new tokens' KV into layer ``l``'s pages, in place.  k/v:
    (B, K, Hkv, dh); phys_page/page_slot: (B,) when ``squeeze`` (one token)
    else (B, K)."""
    for pname, w in (("k_pool", k), ("v_pool", v)):
        pools[pname][l].index_put_((phys_page, page_slot),
                                   w[:, 0] if squeeze else w)


def paged_decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                      token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step against paged KV.

    cache: {"k_pool"/"v_pool": (L, P, page, Hkv, dh),
    "block_tables": (B, maxp) int32, "lengths": (B,) int32}; token: (B, 1).
    Each row decodes at its own depth: its new KV goes to physical page
    ``bt[b, lengths[b] // page]`` at slot ``lengths[b] % page`` (the page
    index clamped to the table, as the reference clamps), then it attends
    its ``lengths[b] + 1`` valid positions.  Rows riding along resolve to
    the scratch page 0.  The pools are updated in place.  Returns
    (logits (B, 1, padded_vocab), cache with lengths + 1).
    """
    x = params["embed"][token]
    bt = cache["block_tables"]
    lengths = cache["lengths"]
    page = cache["k_pool"].shape[2]
    maxp = bt.shape[1]
    rows = torch.arange(bt.shape[0], device=bt.device)
    lens = lengths.long()
    phys_page = bt[rows, torch.clamp(lens // page, max=maxp - 1)].long()
    page_slot = lens % page
    attend = (lengths + 1).to(torch.int32)
    pools = {n: cache[n] for n in _POOLS}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, lens[:, None])
        _scatter_pool_writes(pools, l, phys_page, page_slot, k, v,
                             squeeze=True)
        attn = ops.paged_decode(q, pools["k_pool"][l], pools["v_pool"][l],
                                bt, attend)
        x = _finish_block(lp, cfg, x, attn)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, x), {**pools, "block_tables": bt,
                                  "lengths": attend}


def paged_verify_step(params: Dict, cfg: ModelConfig, cache: Dict,
                      tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One speculative verify step against paged KV.

    cache as in ``paged_decode_step``; tokens: (B, K), the pending token
    followed by the drafts.  Token j's KV goes to physical page
    ``bt[b, (lengths[b]+j) // page]`` (the page index clamped to the table,
    as the reference clamps) at slot ``(lengths[b]+j) % page``, then every
    position attends through the paged verify kernel, query j seeing
    positions ``<= lengths[b] + j``.  Rows riding along resolve to the
    scratch page 0.  The pools are updated in place.  Returns (logits
    (B, K, padded_vocab), cache) with ``lengths`` NOT advanced: the engine
    advances each row by what it accepted.
    """
    x = params["embed"][tokens]
    bt = cache["block_tables"]
    lengths = cache["lengths"]
    page = cache["k_pool"].shape[2]
    maxp = bt.shape[1]
    b, kq = tokens.shape
    rows = torch.arange(b, device=bt.device)
    pos_abs = lengths.long()[:, None] + torch.arange(kq, device=bt.device)
    page_idx = torch.clamp(pos_abs // page, max=maxp - 1)
    phys_page = bt[rows[:, None], page_idx].long()
    page_slot = pos_abs % page
    pools = {n: cache[n] for n in _POOLS}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, pos_abs)
        _scatter_pool_writes(pools, l, phys_page, page_slot, k, v,
                             squeeze=False)
        attn = ops.paged_verify(q, pools["k_pool"][l], pools["v_pool"][l],
                                bt, lengths)
        x = _finish_block(lp, cfg, x, attn)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, x), {**pools, "block_tables": bt,
                                  "lengths": lengths}
