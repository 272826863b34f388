"""RecurrentGemma / Griffin hybrid on tensors: RG-LRU recurrent blocks and
local attention.

Port of ``repro.models.rglru``.  Layer pattern (arXiv:2402.19427):
repeating (recurrent, recurrent, local-attention) groups, every temporal
block followed by a gated-GeLU MLP; 38 layers are 12 full groups and a
two-layer recurrent tail.  The RG-LRU is a gated linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t),
    a_t = exp(-c * softplus(lam) * r_t),  r_t, i_t input-dependent sigmoids,

with its gates and state in float32 whatever ``cfg.dtype`` is.  No TPU
kernel computes it: over a sequence ``rglru_scan`` takes the reference's
form, a port of ``jax.lax.associative_scan``'s odd-even recursion with
the reference's combine (log depth in T; ``rglru_scan_sequential``, the
loop over time, is its plain version), and at decode ``rglru_step`` is a
single-step update.

The local-attention blocks run the prefill kernel (causal, window
``cfg.local_window``) and, at decode, the contiguous decode kernel over a
ring cache of ``min(local_window, capacity)`` positions: position p sits
at slot ``p % cap`` and a step attends ``min(length + 1, cap)`` of them
with no window (the ring holds exactly the window).  A decode step takes
one scalar cache length for every row, so the family has no slot, paged
or verify capability and the engine serves it on left-padded waves.

Layouts are the reference's: weights ``(d_in, d_out)``; the groups'
params stacked on a leading ``n_groups`` axis under ``groups.blk{i}`` /
``groups.mlp{i}``, the tail's unstacked under ``tail.blk{i}`` /
``tail.mlp{i}``; the decode cache ``{"groups": {blk{i}: {"h", "conv"} or
{"k", "v"}} stacked on groups, "tail": [per tail layer], "length": ()}``
with ``h`` (B, W) float32, ``conv`` the last ``conv_width - 1`` recurrent
inputs (B, cw - 1, W) and the ring K/V (B, cap, Hkv, dh).  Unlike the
reference, ``decode_step`` updates the cache's tensors in place.

Under a mesh the params, batch and cache may be DTensors sharded by
``launch.sharding``: the reference's ``cm.shard`` sites sit at the same
places (the attention's q, the MLP's gate and up projections), each
output projection's partial sums over ``model`` are summed before the
residual (as ``dense`` does), the weights are FSDP-gathered on use, the
decode's embeddings are looked up on each rank's rows, the ring is built
without ``roll`` and written shard by shard (``dense._write_slots``), and
the recurrent states are copied back in their own placements
(``common.copy_into``).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.kernels import ops
from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.config import ModelConfig

_C_RGLRU = 8.0


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kinds of one group."""
    return cfg.block_pattern or ("rec", "rec", "attn")


def group_structure(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(full groups, the tail's block kinds) of ``cfg.n_layers``."""
    pat = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers - n_groups * len(pat)]
    return n_groups, tail


# ------------------------------------------------------------------ params
def _rec_params(gen: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                device, lead: Tuple[int, ...]) -> Dict:
    d = cfg.d_model
    w = cfg.rglru_width or d

    def proj(d_in, d_out, scale=1.0):
        return cm.dense_init(gen, lead + (d_in, d_out), dt, device, scale)

    return {
        "ln": cm.norm_params(lead + (d,), cfg.norm_type, dt, device),
        "w_y": proj(d, w),                      # gelu branch
        "w_x": proj(d, w),                      # recurrent branch
        "conv_w": torch.empty(lead + (cfg.conv_width, w), dtype=dt,
                              device=device).normal_(0.0, 0.1,
                                                     generator=gen),
        "conv_b": torch.zeros(lead + (w,), dtype=dt, device=device),
        "w_a": proj(w, w, 0.5),
        "w_i": proj(w, w, 0.5),
        "lam": torch.empty(lead + (w,), dtype=torch.float32,
                           device=device).uniform_(0.5, 2.0, generator=gen),
        "w_o": proj(w, d),
    }


def _attn_params(gen: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                 device, lead: Tuple[int, ...]) -> Dict:
    d = cfg.d_model

    def proj(d_in, d_out):
        return cm.dense_init(gen, lead + (d_in, d_out), dt, device)

    return {"ln": cm.norm_params(lead + (d,), cfg.norm_type, dt, device),
            "wq": proj(d, cfg.q_dim), "wk": proj(d, cfg.kv_dim),
            "wv": proj(d, cfg.kv_dim), "wo": proj(cfg.q_dim, d)}


def _mlp_params(gen: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                device, lead: Tuple[int, ...]) -> Dict:
    d, f = cfg.d_model, cfg.d_ff

    def proj(d_in, d_out):
        return cm.dense_init(gen, lead + (d_in, d_out), dt, device)

    return {"ln": cm.norm_params(lead + (d,), cfg.norm_type, dt, device),
            "w_gate": proj(d, f), "w_up": proj(d, f), "w_down": proj(f, d)}


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """Random weights with the reference's distributions (normal
    ``1/sqrt(d_in)`` projections, ``0.5/sqrt(w)`` for the gates ``w_a`` and
    ``w_i``, normal 0.1 conv kernels, zero conv biases, ``lam`` uniform in
    [0.5, 2) in float32, normal 0.02 embeddings, unit norm scales), drawn
    from ``generator`` on ``device`` in ``dtype`` (default ``cfg.dtype``):
    ``embed``, ``final_norm``, ``lm_head`` unless the embeddings are tied,
    ``groups`` (each block's and MLP's params stacked on ``n_groups``) and
    ``tail``."""
    dt = dtype or _dt(cfg)
    n_groups, tail = group_structure(cfg)
    pat = block_pattern(cfg)
    mk = {"rec": _rec_params, "attn": _attn_params}
    p: Dict = {
        "embed": cm.embed_init(generator, cfg.padded_vocab, cfg.d_model, dt,
                               device),
        "final_norm": cm.norm_params((cfg.d_model,), cfg.norm_type, dt,
                                     device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_init(generator, (cfg.d_model,
                                                 cfg.padded_vocab), dt,
                                     device)
    lead = (n_groups,)
    p["groups"] = {}
    for i, kind in enumerate(pat):
        p["groups"][f"blk{i}"] = mk[kind](generator, cfg, dt, device, lead)
        p["groups"][f"mlp{i}"] = _mlp_params(generator, cfg, dt, device,
                                             lead)
    p["tail"] = {}
    for i, kind in enumerate(tail):
        p["tail"][f"blk{i}"] = mk[kind](generator, cfg, dt, device, ())
        p["tail"][f"mlp{i}"] = _mlp_params(generator, cfg, dt, device, ())
    return p


def _index(tree: Dict, g: int) -> Dict:
    """Group ``g``'s slice of stacked params or states (views)."""
    return {k: (_index(v, g) if isinstance(v, dict) else v[g])
            for k, v in tree.items()}


# ------------------------------------------------------------------ RG-LRU
def _causal_conv(u: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv: ``out_t = sum_j w[j] * u_{t-j} + b``.
    u: (B, T, W); w: (cw, W); b: (W,).  u shifted j steps is a ``cat`` of
    j zero rows and u's first T - j (``F.pad`` of a DTensor at the start
    of a dim, then a slice, keeps the padded length in torch 2.11)."""
    t = u.shape[1]
    out = torch.zeros_like(u)
    for j in range(min(w.shape[0], t)):
        shifted = (u if j == 0 else
                   torch.cat([torch.zeros_like(u[:, :j]), u[:, :t - j]], 1))
        out = out + shifted * w[j]
    return out + b


def _rglru_gates(rp: Dict, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(a, beta * i * u): the linear recurrence's coefficients, float32
    (the gate weights cast to float32, as the reference does)."""
    uf = u.float()
    r = torch.sigmoid(uf @ rp["w_a"].float())
    i = torch.sigmoid(uf @ rp["w_i"].float())
    log_a = -_C_RGLRU * F.softplus(rp["lam"].float()) * r
    a = torch.exp(log_a)
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, beta * i * uf


def _combine(lhs: Tuple[torch.Tensor, torch.Tensor],
             rhs: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's combine of two spans of ``h -> a h + b``: the
    earlier ``lhs`` then ``rhs``."""
    a1, b1 = lhs
    a2, b2 = rhs
    return a1 * a2, a2 * b1 + b2


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """Slots 0, 2, 4, ... from ``even`` and 1, 3, ... from ``odd`` along
    dim 1 (``even`` as long as ``odd`` or one longer): a stack and a
    reshape, no strided write."""
    n = odd.shape[1]
    pairs = torch.stack([even[:, :n], odd], dim=2)
    out = pairs.reshape(pairs.shape[0], 2 * n, *pairs.shape[3:])
    return out if even.shape[1] == n else torch.cat([out, even[:, n:]], 1)


def _associative_scan(a: torch.Tensor, b: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The inclusive scan of ``_combine`` over dim 1, by the odd-even
    recursion of ``jax.lax.associative_scan``: combine adjacent pairs,
    scan the pairs, then fill in the even positions."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                                      (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    even = tuple(torch.cat([x[:, :1], e], dim=1)
                 for x, e in zip((a, b), even))
    return _interleave(even[0], odd[0]), _interleave(even[1], odd[1])


def _scan_inputs(rp: Dict, u: torch.Tensor,
                 h0: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence's (a, b) over time, float32, with ``h0`` folded into
    the first step as ``b_0 + a_0 h0`` (reference ``rglru_scan``).  Under
    a mesh the time axis is replicated (under ``seq_parallel`` it was
    sharded) and the width lies over ``model``: the scan is elementwise
    in the width and needs no collective."""
    a, b = _rglru_gates(rp, u)
    a = cm.shard(a, "batch", None, "model")
    b = cm.shard(b, "batch", None, "model")
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0.float()[:, None], b[:, 1:]],
                      dim=1)
    return a, b


def rglru_scan(rp: Dict, u: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over time, from ``h0`` (B, W) or zeros.  u: (B, T, W)
    -> (h (B, T, W) in u's dtype, h_T (B, W) float32): ``h_t = a_t *
    h_{t-1} + b_t`` in float32 by the reference's associative scan, in
    log2(T) levels of elementwise ops."""
    a, b = _scan_inputs(rp, u, h0)
    if isinstance(b, DTensor):
        # elementwise in the rows and the width: each rank scans its own
        # shard, the time axis whole
        mesh, pl = b.device_mesh, b.placements
        h = DTensor.from_local(_associative_scan(
            a.redistribute(mesh, pl).to_local(), b.to_local())[1], mesh, pl,
            run_check=False)
    else:
        h = _associative_scan(a, b)[1]
    return h.to(u.dtype), h[:, -1]


def rglru_scan_sequential(rp: Dict, u: torch.Tensor,
                          h0: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan``'s plain version: the same recurrence, a loop over
    time in float32."""
    a, b = _scan_inputs(rp, u, h0)
    h = torch.empty_like(b)
    prev = torch.zeros_like(b[:, 0])
    for t in range(b.shape[1]):
        prev = torch.addcmul(b[:, t], a[:, t], prev)
        h[:, t] = prev
    return h.to(u.dtype), h[:, -1]


def rglru_step(rp: Dict, u: torch.Tensor,
               h_prev: torch.Tensor) -> torch.Tensor:
    """One decode step.  u: (B, 1, W), h_prev: (B, W) -> h (B, W) float32."""
    a, b = _rglru_gates(rp, u)
    return a[:, 0] * h_prev.float() + b[:, 0]


# ------------------------------------------------------------------ blocks
def _rec_block(rp: Dict, cfg: ModelConfig, x: torch.Tensor,
               h0: Optional[torch.Tensor] = None,
               conv_state: Optional[torch.Tensor] = None,
               decode: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Griffin recurrent temporal block.  Returns (x + out, h_T, the conv
    state: the last ``conv_width - 1`` recurrent inputs)."""
    h = cm.apply_norm(x, rp["ln"], cfg.norm_type)
    y = cm.gelu(h @ rp["w_y"])
    u = h @ rp["w_x"]
    if decode:
        # the conv over the last cw inputs: the state holds the previous
        # cw - 1; hist[:, -1] is u_t and out_t = sum_j w[j] u_{t-j}, so the
        # kernel applies reversed over the history window
        hist = torch.cat([conv_state, u], dim=1)              # (B, cw, W)
        conv = ((hist * cm.flip0(rp["conv_w"])).sum(dim=1, keepdim=True)
                + rp["conv_b"])
        h_new = rglru_step(rp, conv, h0)
        out = cm.project_out(y * h_new[:, None].to(y.dtype), rp["w_o"])
        return x + out, h_new, hist[:, 1:]
    conv = _causal_conv(u, rp["conv_w"], rp["conv_b"])
    rec, h_last = rglru_scan(rp, conv, h0)
    return (x + cm.project_out(y * rec, rp["w_o"]), h_last,
            u[:, -(cfg.conv_width - 1):])


def _qkv(ap: Dict, cfg: ModelConfig, h: torch.Tensor,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (B, S, d) -> roped q (B, S, H, dh), k/v (B, S, Hkv, dh)."""
    b, s, _ = h.shape
    q = cm.shard(h @ ap["wq"], "batch", None, "model").reshape(
        b, s, cfg.n_heads, cfg.head_dim)
    k = (h @ ap["wk"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = (h @ ap["wv"]).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    q = cm.apply_rope(q, positions, cfg.rope_theta)
    k = cm.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v.contiguous()


def _attn_block_train(ap: Dict, cfg: ModelConfig, x: torch.Tensor,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Local attention over the whole sequence through the prefill kernel
    (causal, window ``cfg.local_window``).  Returns (x + out, k, v)."""
    b, s, _ = x.shape
    h = cm.apply_norm(x, ap["ln"], cfg.norm_type)
    q, k, v = _qkv(ap, cfg, h, positions)
    attn = ops.attention(q, k, v, causal=True, window=cfg.local_window)
    return x + cm.project_out(attn.reshape(b, s, cfg.q_dim), ap["wo"]), k, v


def _attn_block_decode(ap: Dict, cfg: ModelConfig, x: torch.Tensor,
                       kc: torch.Tensor, vc: torch.Tensor,
                       step: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One token of local attention against the ring cache kc/vc
    (B, cap, Hkv, dh), written in place at slot ``length % cap``
    (``dense._write_slots``: a sharded ring shard by shard), then
    attending ``min(length + 1, cap)`` positions through the contiguous
    decode kernel.  step: ``_ring_step``'s (positions, slots, valid
    counts)."""
    b = x.shape[0]
    pos, slot, n_valid = step
    h = cm.apply_norm(x, ap["ln"], cfg.norm_type)
    q, k, v = _qkv(ap, cfg, h, pos)
    dense._write_slots(kc, slot, k)
    dense._write_slots(vc, slot, v)
    attn = ops.decode(q, kc, vc, n_valid)
    return x + cm.project_out(attn.reshape(b, 1, cfg.q_dim), ap["wo"])


def _ring_step(length: torch.Tensor, b: int, cap: int
               ) -> Tuple[torch.Tensor, ...]:
    """What every attention block of one decode step shares: the scalar
    ``length`` broadcast to (B, 1) positions, each row's ring slot
    ``length % cap`` and its (B,) int32 count of valid positions
    ``min(length + 1, cap)``."""
    lens = length.long().reshape(-1).expand(b)
    return (lens[:, None], lens % cap,
            torch.clamp(lens + 1, max=cap).to(torch.int32))


def _mlp_block(mp: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated tanh-GeLU MLP with its residual."""
    h = cm.apply_norm(x, mp["ln"], cfg.norm_type)
    g = cm.shard(h @ mp["w_gate"], "batch", None, "model")
    u = cm.shard(h @ mp["w_up"], "batch", None, "model")
    return x + cm.project_out(cm.gelu(g) * u, mp["w_down"])


def _blocks(params: Dict, cfg: ModelConfig):
    """Every block in order: (where, group index or None, i, kind, block
    params, MLP params), the params as they are used (``common.used``)."""
    n_groups, tail = group_structure(cfg)
    pat = block_pattern(cfg)
    for g in range(n_groups):
        gp = cm.used(_index(params["groups"], g))
        for i, kind in enumerate(pat):
            yield "groups", g, i, kind, gp[f"blk{i}"], gp[f"mlp{i}"]
    tp = cm.used(params["tail"])
    for i, kind in enumerate(tail):
        yield "tail", None, i, kind, tp[f"blk{i}"], tp[f"mlp{i}"]


# ------------------------------------------------------------------ forward
def apply(params: Dict, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, padded_vocab) at every position
    of ``batch["tokens"]`` (B, S)."""
    return _forward(params, cfg, batch, want_cache=False)[0]


def _forward(params: Dict, cfg: ModelConfig, inputs, want_cache: bool,
             capacity: Optional[int] = None
             ) -> Tuple[torch.Tensor, Optional[Dict]]:
    x, positions = dense.embed_inputs(params, cfg, dense._as_batch(inputs))
    s = x.shape[1]
    win = min(cfg.local_window, capacity or cfg.local_window)
    groups: Dict[str, Dict[str, List[torch.Tensor]]] = {}
    tail: List[Dict] = []
    for where, _, i, kind, bp, mp in _blocks(params, cfg):
        if kind == "rec":
            x, h_last, conv_st = _rec_block(bp, cfg, x)
            st = {"h": h_last, "conv": conv_st}
        else:
            x, k, v = _attn_block_train(bp, cfg, x, positions)
            if win <= s:    # the ring: position p at slot p % win
                k, v = dense.ring(k, win, s, 1), dense.ring(v, win, s, 1)
            else:
                k = F.pad(k, (0, 0, 0, 0, 0, win - s))
                v = F.pad(v, (0, 0, 0, 0, 0, win - s))
            st = {"k": k, "v": v}
        x = _mlp_block(mp, cfg, x)
        if where == "tail":     # copies: not views into the whole sequence
            tail.append({name: a.clone() for name, a in st.items()})
        else:
            for name, a in st.items():
                groups.setdefault(f"blk{i}", {}).setdefault(name, []).append(a)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    if not want_cache:
        return dense.logits_of(params, cfg, x), None
    cache = {"groups": {blk: {n: torch.stack(a) for n, a in st.items()}
                        for blk, st in groups.items()},
             "tail": tail,
             "length": torch.tensor(s, dtype=torch.int32, device=x.device)}
    return dense.logits_of(params, cfg, x[:, -1:]), cache


def prefill(params: Dict, cfg: ModelConfig, tokens, *,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (tokens (B, S), left-padded on the wave path, or a
    batch dict) and return the last position's logits (B, 1,
    padded_vocab) and the decode cache: each recurrent block's final state
    and conv inputs, each attention block's ring of ``win = min(
    local_window, capacity)`` positions -- the last ``win`` K/V rolled so
    that position p sits at slot ``p % win`` when ``win <= S``, else the S
    positions zero-padded to ``win`` -- and "length": S."""
    return _forward(params, cfg, tokens, want_cache=True, capacity=capacity)


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One lock-step decode step: token (B, 1) at the cache's scalar
    length, every block's state updated in place.  Returns (logits (B, 1,
    padded_vocab), the cache with length + 1)."""
    length = cache["length"]
    x = cm.embed_rows(params["embed"], token)
    step = None
    for where, g, i, kind, bp, mp in _blocks(params, cfg):
        st = (cache["tail"][i] if where == "tail"
              else _index(cache["groups"][f"blk{i}"], g))
        if kind == "rec":
            x, h_new, conv_new = _rec_block(bp, cfg, x, h0=st["h"],
                                            conv_state=st["conv"],
                                            decode=True)
            cm.copy_into(st["h"], h_new)
            cm.copy_into(st["conv"], conv_new)
        else:
            if step is None:
                step = _ring_step(length, token.shape[0], st["k"].shape[1])
            x = _attn_block_decode(bp, cfg, x, st["k"], st["v"], step)
        x = _mlp_block(mp, cfg, x)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return dense.logits_of(params, cfg, x), {**cache,
                                            "length": length + 1}
