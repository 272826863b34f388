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
``_scatter_pool_writes``), ``paged_decode_step`` (its staged inputs
``paged_decode_inputs`` and its pieces ``paged_decode_piece``, which
``PagedDecodeGraphs`` captures as CUDA graphs on the card) and the
speculative ``paged_verify_step``, each with its int8 form
(``cfg.kv_quant``: int8 K/V plus bf16 per-(token, head) scales,
quantized on write).  Public
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

Under a mesh (``compat.meshenv.mesh_context``) ``init``'s weights may be
DTensors sharded by ``launch.sharding``; the reference's ``cm.shard``
annotations sit at the same places (the q/k/v projections unless
``runtime.attn_batch_only``, the MLP's hidden activations, the embedded
input, each block's output and the logits), with one more after the
attention's output projection; the weights are FSDP-gathered on use
(``common.gathered``), the embeddings looked up on each rank's rows
(``common.embed_rows``), the kernels run on local shards
(``kernels.ops``), and the slot decode writes a sharded cache shard by
shard.  The paged and verify steps serve engines and run
unsharded.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.compat import meshenv
from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import runtime
from repro_torch.models.attention import (decode_attention_seqsharded,
                                          kv_dequantize, kv_quantize)
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
    """Layer ``l``'s slice of the stacked weights (views, no copies; under
    a mesh, FSDP-gathered: ``common.gathered``)."""
    g = cm.gathered
    return {k: ({kk: g(vv[l]) for kk, vv in v.items()} if isinstance(v, dict)
                else g(v[l])) for k, v in params["layers"].items()}


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
    if not runtime.attn_batch_only():
        q = cm.shard(q, "batch", None, "model")
        k = cm.shard(k, "batch", None, "model")
        v = cm.shard(v, "batch", None, "model")
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
        g = cm.shard(h @ lp["w_gate"], "batch", None, "model")
        u = cm.shard(h @ lp["w_up"], "batch", None, "model")
        return (F.silu(g) * u) @ lp["w_down"]
    u = h @ lp["w_up"]
    if cfg.use_bias:
        u = u + lp["b_up"]
    u = cm.shard(u, "batch", None, "model")
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
    # under a mesh the output projection's partial sums over "model" are
    # summed here, where the reference's GSPMD sums them: left partial,
    # DTensor would carry them into the norm and run the MLP unsharded
    attn = cm.shard(attn.reshape(b, s, cfg.q_dim) @ lp["wo"], "batch",
                    "seq", None)
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
    head = cm.gathered(params["embed"].T if cfg.tie_embeddings
                       else params["lm_head"])
    return cm.shard(x @ head, "batch", None, "model")


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
        x = cm.embed_rows(params["embed"], tokens)
    x = cm.shard(x, "batch", "seq", None)
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
        x = cm.shard(_finish_block(lp, cfg, x, h, attn, mlp), "batch", "seq",
                     None)
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
    def layout(a: torch.Tensor) -> torch.Tensor:
        # (L, B, S, Hkv, dh) -> (L, B, cap, Hkv, dh)
        if cap <= s:
            return ring(a, cap, s, 2)
        return F.pad(a, (0, 0, 0, 0, 0, cap - s))

    cache = {name: layout(torch.stack(a)) for name, a in kvs.items()}
    cache["length"] = torch.tensor(s, dtype=torch.int32, device=device)
    return cache


def ring(a: torch.Tensor, cap: int, s: int, dim: int) -> torch.Tensor:
    """The last ``cap`` of the ``s`` positions of ``a`` along ``dim``,
    rotated so that position p sits at slot ``p % cap``: two slices and
    one ``cat``, the ``roll`` of the reference (a DTensor has no roll
    rule in some torch releases)."""
    tail = a.narrow(dim, s - cap, cap)
    r = s % cap
    if not r:
        return tail.contiguous()
    return torch.cat([tail.narrow(dim, cap - r, r),
                      tail.narrow(dim, 0, cap - r)], dim=dim)


# ---------------------------------------------------------------- slot decode
def _write_slots(c: torch.Tensor, slot: torch.Tensor,
                 w: torch.Tensor) -> None:
    """c[b, slot[b]] = w[b, 0] for every row, in place.  c: one layer's
    cache (B, C, ...); slot: (B,); w: (B, 1, ...).  A DTensor cache is
    written shard by shard: each rank writes its own rows where the slot
    falls in its chunk of positions, with no communication but the
    gather of ``w`` to whole rows."""
    if not isinstance(c, DTensor):
        rows = torch.arange(c.shape[0], device=c.device)
        c.index_put_((rows, slot), w[:, 0])
        return
    mesh = c.device_mesh
    keep = [p if p == Shard(0) else Replicate() for p in c.placements]
    if not isinstance(w, DTensor):
        w = DTensor.from_local(w, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    w_l = w.redistribute(mesh, keep).to_local()
    c_l = c.to_local()
    b0, s0 = meshenv.shard_offset(c, 0), meshenv.shard_offset(c, 1)
    sl = slot.to_local() if isinstance(slot, DTensor) else slot
    sl = sl[b0:b0 + c_l.shape[0]] - s0
    in_range = (sl >= 0) & (sl < c_l.shape[1])
    safe = torch.clamp(sl, 0, c_l.shape[1] - 1)
    rows = torch.arange(c_l.shape[0], device=c_l.device)
    mask = in_range.reshape((-1,) + (1,) * (c_l.ndim - 2))
    c_l[rows, safe] = torch.where(mask, w_l[:, 0].to(c_l.dtype),
                                  c_l[rows, safe])


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
    length + 1, of the length's own shape).

    Under a mesh the cache may be DTensors (``launch.sharding``'s cache
    specs: the sequence over ``model``): each rank writes the rows and
    positions of its own shard.  With ``runtime.decode_seq_shard`` and a
    scalar length, each layer attends through
    ``attention.decode_attention_seqsharded``, as the reference's
    lock-step branch does."""
    length = cache["length"]
    x = cm.embed_rows(params["embed"], token)
    cap = cache["k"].shape[2]
    lens = length.long().reshape(-1).expand(token.shape[0])
    slot = lens % cap
    n_valid = torch.clamp(lens + 1, max=cap).to(torch.int32)
    pos = _step_positions(cfg, lens[:, None])
    seq_shard = runtime.decode_seq_shard() and length.dim() == 0
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        kc, vc = cache["k"][l], cache["v"][l]
        h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
        q, k, v = _project_qkv(lp, cfg, h, pos)
        writes = {"k": k, "v": v}
        if cfg.kv_quant:
            writes["k"], writes["k_scale"] = kv_quantize(k)
            writes["v"], writes["v_scale"] = kv_quantize(v)
        if seq_shard:
            scales = ((cache["k_scale"][l], cache["v_scale"][l],
                       writes["k_scale"], writes["v_scale"])
                      if cfg.kv_quant else None)
            attn = decode_attention_seqsharded(
                q, kc, vc, writes["k"], writes["v"], length % cap,
                torch.clamp(length + 1, max=cap), scales=scales)[0]
        else:
            for name, w in writes.items():
                _write_slots(cache[name][l], slot, w)
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


def paged_decode_inputs(cfg: ModelConfig, block_tables: torch.Tensor,
                        lengths: torch.Tensor, page: int
                        ) -> Dict[str, torch.Tensor]:
    """A paged decode step's inputs staged from its table (B, maxp) and
    lengths (B,): each row's positions ``pos`` (as ``_project_qkv`` takes
    them), its write page ``phys_page`` = ``bt[b, lengths[b] // page]``
    (the page index clamped to the table, as the reference clamps) and
    slot ``page_slot`` = ``lengths[b] % page``, and the ``attend`` (B,)
    int32 positions it attends after its write."""
    maxp = block_tables.shape[1]
    rows = torch.arange(block_tables.shape[0], device=block_tables.device)
    lens = lengths.long()
    return {"pos": _step_positions(cfg, lens[:, None]),
            "phys_page": block_tables[
                rows, torch.clamp(lens // page, max=maxp - 1)].long(),
            "page_slot": lens % page,
            "attend": (lengths + 1).to(torch.int32)}


def paged_decode_piece(params: Dict, cfg: ModelConfig, pools: Dict, l: int,
                       inputs: Dict[str, torch.Tensor],
                       carry: Optional[Tuple] = None) -> Tuple:
    """Piece ``l`` of the paged decode step, the dense work between two
    paged attentions: the embedding of ``inputs["token"]`` (l = 0), else
    layer l-1's finish over ``carry`` = (x, h, attn); then layer l's norm,
    q/k/v projections, RoPE and KV page write at ``inputs``' staged
    ``pos``, ``phys_page`` and ``page_slot``.  Returns (x, h, roped q) for
    l < n_layers, and for l = n_layers (x, None, logits) after the final
    norm and the head."""
    if l == 0:
        x = params["embed"][inputs["token"]]
    else:
        x, h, attn = carry
        x = _finish_block(_layer(params, l - 1), cfg, x, h, attn)
    if l == cfg.n_layers:
        x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
        return x, None, logits_of(params, cfg, x)
    lp = _layer(params, l)
    h = cm.apply_norm(x, lp["ln1"], cfg.norm_type)
    q, k, v = _project_qkv(lp, cfg, h, inputs["pos"])
    _scatter_pool_writes(pools, l, inputs["phys_page"], inputs["page_slot"],
                         k, v, squeeze=True)
    return x, h, q


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

    The step is ``PagedDecodeGraphs``' composition run eagerly: its
    ``n_layers + 1`` pieces (``paged_decode_piece``) with each layer's
    paged attention between them, the body its graphs replay on the card.
    """
    bt = cache["block_tables"]
    pools = {n: cache[n] for n in _pool_names(cache)}
    steps = PagedDecodeGraphs(params, cfg, pools, token.shape[0])
    staged = steps.stage(token, bt, cache["lengths"])
    return steps.launch(bt, staged["attend"]), {
        **pools, "block_tables": bt, "lengths": staged["attend"]}


class PagedDecodeGraphs:
    """The paged decode step of one engine's pools as CUDA graphs: one
    graph a piece (``paged_decode_piece``), all in one private memory
    pool, with each layer's paged attention launched eagerly between
    them, since its launch (the table's width, its split count and
    workspace) changes from step to step.

    The static inputs are the token (B, 1), the staged positions, write
    pages and slots (``stage`` copies a step's into them) and one
    attention buffer that each layer's attention output is copied into
    before the next piece replays.  Until ``capture`` the pieces run
    eagerly on the same buffers, which is how the CPU tests hold this
    composition to the reference.  The pools must stay the ones given:
    the graphs write into them."""

    def __init__(self, params: Dict, cfg: ModelConfig, pools: Dict,
                 batch: int) -> None:
        dev = pools["k_pool"].device
        self.params, self.cfg, self.pools = params, cfg, pools
        long = dict(dtype=torch.long, device=dev)
        self.inputs = {"token": torch.zeros((batch, 1), **long),
                       "pos": _step_positions(
                           cfg, torch.zeros((batch, 1), **long)).clone(),
                       "phys_page": torch.zeros((batch,), **long),
                       "page_slot": torch.zeros((batch,), **long)}
        self.attn = torch.zeros((batch, 1, cfg.n_heads, cfg.head_dim),
                                dtype=params["embed"].dtype, device=dev)
        self.graphs: list = []
        # each piece's (x, h, q or logits): the next piece's inputs
        self.outs: list = [None] * (cfg.n_layers + 1)

    def _piece(self, l: int) -> Tuple:
        carry = None if l == 0 else self.outs[l - 1][:2] + (self.attn,)
        return paged_decode_piece(self.params, self.cfg, self.pools, l,
                                  self.inputs, carry)

    def capture(self) -> None:
        """Capture every piece, on a side stream, after one eager warm-up
        pass there whose page writes land on the scratch page 0 (the
        static write pages are zero until ``stage``)."""
        dev = self.pools["k_pool"].device
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        pool = torch.cuda.graph_pool_handle()
        with torch.cuda.stream(side):
            for l in range(self.cfg.n_layers + 1):
                self.outs[l] = self._piece(l)
            for l in range(self.cfg.n_layers + 1):
                g = torch.cuda.CUDAGraph()
                g.capture_begin(pool=pool)
                self.outs[l] = self._piece(l)
                g.capture_end()
                self.graphs.append(g)
        torch.cuda.current_stream(dev).wait_stream(side)

    def stage(self, token: torch.Tensor, block_tables: torch.Tensor,
              lengths: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Stage a step: its inputs from its table and lengths
        (``paged_decode_inputs``) and its token (B, 1), copied into the
        static inputs.  Returns the staged inputs, whose ``attend``
        lengths the launch takes."""
        staged = paged_decode_inputs(self.cfg, block_tables, lengths,
                                     self.pools["k_pool"].shape[2])
        self.inputs["token"].copy_(token)
        for name in ("pos", "phys_page", "page_slot"):
            self.inputs[name].copy_(staged[name])
        return staged

    def launch(self, block_tables: torch.Tensor,
               attend: torch.Tensor) -> torch.Tensor:
        """The staged step: each piece replayed (run, before ``capture``)
        and each layer's paged attention between them, over the step's
        own ``block_tables`` and ``attend`` lengths.  Returns the logits
        (B, 1, padded_vocab), a static output the next launch
        overwrites."""
        for l in range(self.cfg.n_layers + 1):
            if l:
                self.attn.copy_(_paged_attention(
                    self.pools, l - 1, self.outs[l - 1][2], block_tables,
                    attend, verify=False))
            if self.graphs:
                self.graphs[l].replay()
            else:
                self.outs[l] = self._piece(l)
        return self.outs[-1][2]


def paged_decode_graphs(params: Dict, cfg: ModelConfig, pools: Dict,
                        batch: int) -> Optional[PagedDecodeGraphs]:
    """``batch``-row paged decode steps over ``pools`` as captured CUDA
    graphs where the weights are on the card; None, so that the step
    stays eager, elsewhere and under M-RoPE (``common.apply_mrope``
    builds its section index from a host list, which capture refuses)."""
    if params["embed"].device.type != "cuda" or cfg.mrope:
        return None
    graphs = PagedDecodeGraphs(params, cfg, pools, batch)
    graphs.capture()
    return graphs


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
