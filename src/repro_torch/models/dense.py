"""Dense decoder-only transformer family on tensors.

Port of the serving paths of ``repro.models.dense`` for every dense
layout of ``repro.configs``: qwen3 (RMSNorm, SwiGLU, qk-norm),
starcoder2 (LayerNorm, GeLU, biases), command-r-plus (LayerNorm, parallel
attention/MLP block, tied embeddings), the vlm family's qwen2-vl (M-RoPE
over (t, h, w) position ids, and embedding inputs: ``embed_inputs``) and
their sliding-window variants:
``init``, the full-sequence ``apply``, right-padded ``prefill`` with
``last_positions``, the slot cache (``init_cache``, ``decode_step`` with
(B,) lengths, or one scalar length for the lock-step wave), the KV page
pools (``init_paged_pools``, ``prefill_to_pages``,
``_scatter_pool_writes``), ``paged_decode_step`` and the speculative
``paged_verify_step``, each with its int8 form (``cfg.kv_quant``: int8
K/V plus bf16 per-(token, head) scales, quantized on write).  Public
functions keep the reference's layouts: weights ``(d_in, d_out)`` stacked
on a leading layer axis, slot caches ``(L, B, C, Hkv, dh)``, pools
``(L, P, page, Hkv, dh)``, scales ``(..., 1)``.  Under M-RoPE a decode or
verify step broadcasts its position to all three axes, as the reference
does, even after a prefill on embeddings with distinct (t, h, w) ids.

Attention goes through ``kernels.ops``: the prefill through the prefill
kernel (where the reference calls its jnp ``flash_attention``), a slot
decode step through the contiguous decode kernel (the reference's jnp
``decode_attention``; an int8 slot cache is dequantized first, as the
reference does), a paged decode or verify step through the paged decode
or verify kernel, or their int8 forms on int8 pools (where the reference
gathers and dequantizes pages and calls its jnp ``decode_attention`` or
``verify_attention``).  The projections and
the MLP stay ``torch.matmul``, as the reference leaves them to XLA.

Unlike the reference, whose arrays are immutable, slot caches and pools
are updated in place (``index_put_``) so decode never copies them; a
caller must not keep a view of a cache across steps and expect it
unchanged.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models.attention import kv_dequantize, kv_quantize
from repro_torch.models.config import ModelConfig

_POOLS = ("k_pool", "v_pool")
_SCALE_POOLS = ("k_scale_pool", "v_scale_pool")


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------- init
def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """Random weights with the reference's distributions (normal
    ``1/sqrt(d_in)`` projections, normal 0.02 embeddings, unit norm scales,
    zero biases and LayerNorm biases), drawn from ``generator`` on
    ``device`` in ``dtype`` (default ``cfg.dtype``), for every dense layout
    the reference's switches make: RMSNorm or LayerNorm, SwiGLU or GeLU
    (with ``b_up``/``b_down`` under ``use_bias``), the q/k/v/o biases,
    qk-norm, the parallel block (no ``ln2``) and tied embeddings (no
    ``lm_head``); the vlm family's layout is qwen3's without qk-norm."""
    dt = dtype or _dt(cfg)
    L, d, f = cfg.n_layers, cfg.d_model, cfg.d_ff

    def w(*shape):
        return cm.dense_init(generator, (L,) + shape, dt, device)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=device)

    lyr: Dict = {
        "ln1": cm.norm_params((L, d), cfg.norm_type, dt, device),
        "wq": w(d, cfg.q_dim), "wk": w(d, cfg.kv_dim), "wv": w(d, cfg.kv_dim),
        "wo": w(cfg.q_dim, d),
    }
    if not cfg.parallel_block:
        lyr["ln2"] = cm.norm_params((L, d), cfg.norm_type, dt, device)
    if cfg.act == "swiglu":
        lyr.update(w_gate=w(d, f), w_up=w(d, f), w_down=w(f, d))
    else:
        lyr.update(w_up=w(d, f), w_down=w(f, d))
        if cfg.use_bias:
            lyr.update(b_up=zeros(L, f), b_down=zeros(L, d))
    if cfg.qk_norm:
        lyr["q_norm"] = ones(L, cfg.head_dim)
        lyr["k_norm"] = ones(L, cfg.head_dim)
    if cfg.use_bias:
        lyr.update(bq=zeros(L, cfg.q_dim), bk=zeros(L, cfg.kv_dim),
                   bv=zeros(L, cfg.kv_dim), bo=zeros(L, d))
    p = {"embed": cm.embed_init(generator, cfg.padded_vocab, d, dt, device),
         "final_norm": cm.norm_params((d,), cfg.norm_type, dt, device),
         "layers": lyr}
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_init(generator, (d, cfg.padded_vocab), dt,
                                     device)
    return p


def _layer(params: Dict, l: int) -> Dict:
    """Layer ``l``'s slice of the stacked weights (views, no copies)."""
    return {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                else v[l]) for k, v in params["layers"].items()}


# ---------------------------------------------------------------- sub-blocks
def _project_qkv(lp: Dict, cfg: ModelConfig, h: torch.Tensor,
                 positions: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (B, S, d) -> roped q (B, S, H, dh), k/v (B, S, Hkv, dh);
    positions (B, S), or (B, S, 3) (t, h, w) ids under M-RoPE."""
    b, s, _ = h.shape
    q, k, v = h @ lp["wq"], h @ lp["wk"], h @ lp["wv"]
    if cfg.use_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = cm.rms_norm(q, lp["q_norm"])
        k = cm.rms_norm(k, lp["k_norm"])
    if cfg.mrope:
        q = cm.apply_mrope(q, positions, cfg.rope_theta, cfg.mrope_sections)
        k = cm.apply_mrope(k, positions, cfg.rope_theta, cfg.mrope_sections)
    else:
        q = cm.apply_rope(q, positions, cfg.rope_theta)
        k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _step_positions(cfg: ModelConfig, pos: torch.Tensor) -> torch.Tensor:
    """A decode or verify step's positions (B, K) as ``_project_qkv``
    takes them: under M-RoPE the same id on all three axes, as the
    reference broadcasts it."""
    return pos[..., None].expand(*pos.shape, 3) if cfg.mrope else pos


def _mlp(lp: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    if cfg.act == "swiglu":
        return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]
    u = h @ lp["w_up"]
    if cfg.use_bias:
        u = u + lp["b_up"]
    out = cm.gelu(u) @ lp["w_down"]
    return out + lp["b_down"] if cfg.use_bias else out


def _finish_block(lp: Dict, cfg: ModelConfig, x: torch.Tensor,
                  h: torch.Tensor, attn: torch.Tensor,
                  mlp: Callable = _mlp) -> torch.Tensor:
    """Output projection (plus ``bo``) and residual, then the MLP (``mlp``:
    this family's, or the moe family's): over ``ln2`` of the new residual
    stream, or for a parallel block over the block's input norm ``h``
    beside the attention (``x + attn + mlp(h)``)."""
    b, s = x.shape[:2]
    attn = attn.reshape(b, s, cfg.q_dim) @ lp["wo"]
    if cfg.use_bias:
        attn = attn + lp["bo"]
    if cfg.parallel_block:
        return x + attn + mlp(lp, cfg, h)
    x = x + attn
    return x + mlp(lp, cfg, cm.apply_norm(x, lp["ln2"], cfg.norm_type))


def logits_of(params: Dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """The head: ``embed.T`` when the embeddings are tied, else
    ``lm_head``."""
    return x @ (params["embed"].T if cfg.tie_embeddings
                else params["lm_head"])


# ------------------------------------------------------------------ forward
def embed_inputs(params: Dict, cfg: ModelConfig, batch: Dict
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block input and its positions: ``batch["embeds"]`` (B, S, d)
    cast to ``cfg.dtype`` when the config takes embeddings and the batch
    has them, else the embedding rows of ``batch["tokens"]`` (B, S);
    ``batch["positions"]`` when given, else ``arange(S)`` broadcast to
    (B, S), or to (B, S, 3) under M-RoPE."""
    if cfg.embeds_input and "embeds" in batch:
        x = batch["embeds"].to(_dt(cfg))
        b, s = x.shape[:2]
    else:
        tokens = batch["tokens"]
        b, s = tokens.shape
        x = params["embed"][tokens]
    positions = batch.get("positions")
    if positions is None:
        base = torch.arange(s, device=x.device)
        positions = (base[None, :, None].expand(b, s, 3) if cfg.mrope
                     else base.expand(b, s))
    return x, positions


def _as_batch(inputs) -> Dict:
    """A prompt given as tokens (B, S) or as a batch dict, as a dict."""
    return inputs if isinstance(inputs, dict) else {"tokens": inputs}


def _forward_blocks(params: Dict, cfg: ModelConfig, inputs,
                    kvs: Optional[Dict[str, list]] = None,
                    mlp: Callable = _mlp) -> torch.Tensor:
    """Embed ``inputs`` (tokens (B, S), or a batch dict as
    ``embed_inputs`` takes it) and run every block over the whole
    sequence, attention through the prefill kernel (causal, the config's
    window); returns the hidden states (B, S, d) before the final norm.
    With ``kvs`` each layer's K/V (quantized with ``cfg.kv_quant``) are
    appended to it by name.  ``prefill`` and ``apply`` share this loop,
    and the moe family runs it with its own ``mlp``."""
    x, positions = embed_inputs(params, cfg, _as_batch(inputs))
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, positions)
        attn = ops.attention(q, k, v, causal=True, window=cfg.sliding_window)
        x = _finish_block(lp, cfg, x, h, attn, mlp)
        if kvs is None:
            continue
        out = {"k": k, "v": v}
        if cfg.kv_quant:
            out["k"], out["k_scale"] = kv_quantize(k)
            out["v"], out["v_scale"] = kv_quantize(v)
        for name, a in out.items():
            kvs.setdefault(name, []).append(a)
    return x


def apply(params: Dict, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, padded_vocab) at every position
    of ``batch["tokens"]`` (B, S) or, for a config that takes them, of
    ``batch["embeds"]`` (B, S, d), at ``batch["positions"]`` when given
    (``embed_inputs``), as the reference's ``apply`` returns them.  The KV
    is not kept."""
    x = _forward_blocks(params, cfg, batch)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, cfg, x)


# ------------------------------------------------------------------ prefill
def prefill(params: Dict, cfg: ModelConfig, tokens, *,
            capacity: Optional[int] = None,
            last_positions: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt, build the KV cache, return last-position logits.

    tokens: (B, S) prompts, right-padded (pads are causally inert) or, on
    the wave path, left-padded; or a batch dict as ``apply`` takes it
    (embeddings and explicit positions, the vlm family).  The cache holds
    ``capacity`` positions (default S; zero-padded past S), or for a
    sliding-window config a ring of ``sliding_window`` positions where
    position p sits at slot p % window.  ``last_positions`` ((B,)) takes
    each row's logits at its own final real token.  Returns (logits
    (B, 1, padded_vocab), {"k", "v": (L, B, cap, Hkv, dh), "length": S, a
    () int32 tensor});
    with ``cfg.kv_quant`` the returned K/V are int8 plus
    "k_scale"/"v_scale" (L, B, cap, Hkv, 1) bf16 (attention itself ran on
    the fp k/v).
    """
    kvs: Dict[str, list] = {}
    x = _forward_blocks(params, cfg, tokens, kvs)
    b, s = x.shape[:2]
    cap = _capacity(cfg, s, capacity)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    if last_positions is None:
        x_last = x[:, -1:]
    else:
        x_last = x[torch.arange(b, device=x.device),
                   last_positions.long()][:, None]
    cache = _cache_of(kvs, cap, s, x.device)
    return logits_of(params, cfg, x_last), cache


def _capacity(cfg: ModelConfig, s: int, capacity: Optional[int]) -> int:
    """A prefill cache's positions: ``capacity`` (at least the prompt's
    ``s``), or a window config's ring of at most ``sliding_window``."""
    if cfg.sliding_window is None:
        return max(s, capacity or s)
    return min(cfg.sliding_window, capacity or cfg.sliding_window)


def _cache_of(kvs: Dict[str, list], cap: int, s: int,
              device: torch.device) -> Dict:
    """The per-layer K/V lists of an ``s``-token prefill stacked into a
    cache of ``cap`` positions: zero-padded past ``s``, or, when ``cap <=
    s``, the last ``cap`` positions ring-rotated so that position p sits
    at slot p % cap; plus "length": s."""
    def ring(a: torch.Tensor) -> torch.Tensor:
        # (L, B, S, Hkv, dh) -> (L, B, cap, Hkv, dh)
        if cap <= s:
            return torch.roll(a[:, :, -cap:], shifts=s % cap, dims=2)
        return F.pad(a, (0, 0, 0, 0, 0, cap - s))

    cache = {name: ring(torch.stack(a)) for name, a in kvs.items()}
    cache["length"] = torch.tensor(s, dtype=torch.int32, device=device)
    return cache


# ---------------------------------------------------------------- slot decode
def init_cache(cfg: ModelConfig, batch: int, capacity: int,
               dtype: Optional[torch.dtype] = None,
               device: torch.device | str = "cpu") -> Dict:
    """A zero slot cache {"k", "v": (L, batch, cap, Hkv, dh), "length": ()}
    (cap = ``capacity``, or the window of a sliding-window config).  With
    ``cfg.kv_quant`` "k"/"v" are int8 and "k_scale"/"v_scale"
    (L, batch, cap, Hkv, 1) bf16 ride beside them, as ``prefill`` returns
    them (the reference's ``init_cache`` allocates fp caches only; its
    engine takes the quantized layout from prefill, as the port's does)."""
    cap = (capacity if cfg.sliding_window is None
           else min(capacity, cfg.sliding_window))
    shape = (cfg.n_layers, batch, cap, cfg.n_kv_heads, cfg.head_dim)
    dt = torch.int8 if cfg.kv_quant else (dtype or _dt(cfg))
    cache = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device),
             "length": torch.zeros((), dtype=torch.int32, device=device)}
    if cfg.kv_quant:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                      device=device)
    return cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor, mlp: Callable = _mlp
                ) -> Tuple[torch.Tensor, Dict]:
    """One decode step against a slot cache (``mlp``: as in
    ``_forward_blocks``).

    cache: {"k"/"v": (L, B, C, Hkv, dh), "length": (B,) or () int32};
    token: (B, 1).  With (B,) lengths (slot batching) each row decodes at
    its own depth; a scalar length (the lock-step wave) is broadcast to
    every row, so both go through the same contiguous decode kernel.  Row
    b's new KV goes to slot ``length[b] % C`` of its cache row, in place
    (a window config's ring), then it attends its ``min(length[b] + 1, C)``
    valid positions.  With ``cfg.kv_quant`` the cache is int8 plus
    "k_scale"/"v_scale": the new KV is quantized on write and the layer's
    cache dequantized to ``cfg.dtype`` before the decode kernel, as the
    reference does.  Returns (logits (B, 1, padded_vocab), cache with
    length + 1, of the length's own shape).  The reference's
    sequence-sharded decode is ROADMAP Queue A item 10."""
    length = cache["length"]
    x = params["embed"][token]
    cap = cache["k"].shape[2]
    lens = length.long().reshape(-1).expand(token.shape[0])
    rows = torch.arange(lens.shape[0], device=lens.device)
    slot = lens % cap
    n_valid = torch.clamp(lens + 1, max=cap).to(torch.int32)
    pos = _step_positions(cfg, lens[:, None])
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, pos)
        writes = {"k": k, "v": v}
        if cfg.kv_quant:
            writes["k"], writes["k_scale"] = kv_quantize(k)
            writes["v"], writes["v_scale"] = kv_quantize(v)
        for name, w in writes.items():
            cache[name][l].index_put_((rows, slot), w[:, 0])
        if cfg.kv_quant:
            kc = kv_dequantize(kc, cache["k_scale"][l], _dt(cfg))
            vc = kv_dequantize(vc, cache["v_scale"][l], _dt(cfg))
        attn = ops.decode(q, kc, vc, n_valid)
        x = _finish_block(lp, cfg, x, h, attn, mlp)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, cfg, x), {
        **cache, "length": (length + 1).to(length.dtype)}


# --------------------------------------------------------------- paged pools
def init_paged_pools(cfg: ModelConfig, num_pages: int, page_size: int,
                     dtype: Optional[torch.dtype] = None,
                     device: torch.device | str = "cpu") -> Dict:
    """The shared KV page pools {"k_pool", "v_pool"}, each
    (L, P, page, Hkv, dh) zeros.  Page 0 is the engine's scratch page:
    writes of rows without an allocated page land there and are never
    attended.  With ``cfg.kv_quant`` the pools are int8 (``dtype`` is not
    read) and two bf16 scale pools {"k_scale_pool", "v_scale_pool"}
    (L, P, page, Hkv, 1) ride the same block table, one scale per
    (token, head) entry; a never-written entry dequantizes to 0."""
    shape = (cfg.n_layers, num_pages, page_size, cfg.n_kv_heads,
             cfg.head_dim)
    if cfg.kv_quant:
        pools = {n: torch.zeros(shape, dtype=torch.int8, device=device)
                 for n in _POOLS}
        for n in _SCALE_POOLS:
            pools[n] = torch.zeros(shape[:-1] + (1,), dtype=torch.bfloat16,
                                   device=device)
        return pools
    dt = dtype or _dt(cfg)
    return {n: torch.zeros(shape, dtype=dt, device=device) for n in _POOLS}


def _pool_names(pools: Dict) -> Tuple[str, ...]:
    """The pool names ``pools`` holds: K/V, plus the scale pools when the
    pools are int8."""
    return _POOLS + (_SCALE_POOLS if _SCALE_POOLS[0] in pools else ())


def prefill_to_pages(pools: Dict, kv: Dict,
                     phys_pages: torch.Tensor) -> Dict:
    """Scatter a contiguous prefill cache into pool pages, in place.

    kv: {"k", "v"[, "k_scale", "v_scale"]} (L, n, plen, Hkv, dh|1) with
    plen a multiple of the page size -- a quantized prefill cache is
    scattered as it is, not re-quantized, so pages hold the slot cache's
    values bit for bit; phys_pages: (n, plen // page) physical page per
    (row, logical page) -- entries past a row's real prompt point at the
    scratch page 0 (several rows may alias it).  Returns ``pools``."""
    page = pools["k_pool"].shape[2]
    idx = phys_pages.long()
    for pname in _pool_names(pools):
        src = kv[pname[:-5]]
        L, n, plen = src.shape[:3]
        src = src.reshape((L, n, plen // page, page) + tuple(src.shape[3:]))
        pools[pname][:, idx] = src.to(pools[pname].dtype)
    return pools


def _scatter_pool_writes(pools: Dict, l: int, phys_page: torch.Tensor,
                         page_slot: torch.Tensor, k: torch.Tensor,
                         v: torch.Tensor, squeeze: bool) -> None:
    """Write new tokens' KV into layer ``l``'s pages, in place, quantizing
    on write for int8 pools.  k/v: (B, K, Hkv, dh); phys_page/page_slot:
    (B,) when ``squeeze`` (one token) else (B, K)."""
    writes = {"k_pool": k, "v_pool": v}
    if _SCALE_POOLS[0] in pools:
        writes["k_pool"], writes["k_scale_pool"] = kv_quantize(k)
        writes["v_pool"], writes["v_scale_pool"] = kv_quantize(v)
    for pname, w in writes.items():
        pools[pname][l].index_put_((phys_page, page_slot),
                                   w[:, 0] if squeeze else w)


def _paged_attention(pools: Dict, l: int, q: torch.Tensor,
                     block_tables: torch.Tensor, lengths: torch.Tensor,
                     verify: bool) -> torch.Tensor:
    """Layer ``l``'s paged decode (``verify`` False) or verify attention,
    through the int8 kernels when the pools carry scales."""
    kp, vp = pools["k_pool"][l], pools["v_pool"][l]
    if _SCALE_POOLS[0] in pools:
        op = ops.paged_verify_quant if verify else ops.paged_decode_quant
        return op(q, kp, vp, pools["k_scale_pool"][l],
                  pools["v_scale_pool"][l], block_tables, lengths)
    op = ops.paged_verify if verify else ops.paged_decode
    return op(q, kp, vp, block_tables, lengths)


def paged_decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                      token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One decode step against paged KV.

    cache: {"k_pool"/"v_pool": (L, P, page, Hkv, dh)[, "k_scale_pool"/
    "v_scale_pool": (L, P, page, Hkv, 1)], "block_tables": (B, maxp)
    int32, "lengths": (B,) int32}; token: (B, 1).
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
    pos = _step_positions(cfg, lens[:, None])
    pools = {n: cache[n] for n in _pool_names(cache)}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, pos)
        _scatter_pool_writes(pools, l, phys_page, page_slot, k, v,
                             squeeze=True)
        attn = _paged_attention(pools, l, q, bt, attend, verify=False)
        x = _finish_block(lp, cfg, x, h, attn)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, cfg, x), {**pools, "block_tables": bt,
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
    pos = _step_positions(cfg, pos_abs)
    pools = {n: cache[n] for n in _pool_names(cache)}
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, pos)
        _scatter_pool_writes(pools, l, phys_page, page_slot, k, v,
                             squeeze=False)
        attn = _paged_attention(pools, l, q, bt, lengths, verify=True)
        x = _finish_block(lp, cfg, x, h, attn)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return logits_of(params, cfg, x), {**pools, "block_tables": bt,
                                  "lengths": lengths}
