"""RecurrentGemma / Griffin hybrid on tensors: RG-LRU recurrent blocks and
local attention.

Port of ``repro.models.rglru``.  Layer pattern (arXiv:2402.19427):
repeating (recurrent, recurrent, local-attention) groups, every temporal
block followed by a gated-GeLU MLP; 38 layers are 12 full groups and a
two-layer recurrent tail.  The RG-LRU is a gated linear recurrence

    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * u_t),
    a_t = exp(-c * softplus(lam) * r_t),  r_t, i_t input-dependent sigmoids,

with its gates and state in float32 whatever ``cfg.dtype`` is.  The
reference scans it with ``jax.lax.associative_scan``; no TPU kernel
computes it, and here it is a sequential loop over time in PyTorch
(``rglru_scan``) and a single-step update at decode (``rglru_step``).

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
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

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
    u: (B, T, W); w: (cw, W); b: (W,)."""
    t = u.shape[1]
    out = torch.zeros_like(u)
    for j in range(w.shape[0]):
        shifted = F.pad(u, (0, 0, j, 0))[:, :t]
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


def rglru_scan(rp: Dict, u: torch.Tensor, h0: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The recurrence over time, from ``h0`` (B, W) or zeros.  u: (B, T, W)
    -> (h (B, T, W) in u's dtype, h_T (B, W) float32).  A sequential loop:
    ``h_t = a_t * h_{t-1} + b_t`` in float32, the function the reference's
    associative scan computes (it folds ``h0`` into ``b_0`` as
    ``a_0 * h0``)."""
    a, b = _rglru_gates(rp, u)
    h = torch.empty_like(b)
    prev = (torch.zeros_like(b[:, 0]) if h0 is None else h0.float())
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
        conv = ((hist * rp["conv_w"].flip(0)).sum(dim=1, keepdim=True)
                + rp["conv_b"])
        h_new = rglru_step(rp, conv, h0)
        out = (y * h_new[:, None].to(y.dtype)) @ rp["w_o"]
        return x + out, h_new, hist[:, 1:]
    conv = _causal_conv(u, rp["conv_w"], rp["conv_b"])
    rec, h_last = rglru_scan(rp, conv, h0)
    out = (y * rec) @ rp["w_o"]
    return x + out, h_last, u[:, -(cfg.conv_width - 1):]


def _qkv(ap: Dict, cfg: ModelConfig, h: torch.Tensor,
         positions: torch.Tensor
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """h: (B, S, d) -> roped q (B, S, H, dh), k/v (B, S, Hkv, dh)."""
    b, s, _ = h.shape
    q = (h @ ap["wq"]).reshape(b, s, cfg.n_heads, cfg.head_dim)
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
    return x + attn.reshape(b, s, cfg.q_dim) @ ap["wo"], k, v


def _attn_block_decode(ap: Dict, cfg: ModelConfig, x: torch.Tensor,
                       kc: torch.Tensor, vc: torch.Tensor,
                       step: Tuple[torch.Tensor, ...]) -> torch.Tensor:
    """One token of local attention against the ring cache kc/vc
    (B, cap, Hkv, dh), written in place at slot ``length % cap``, then
    attending ``min(length + 1, cap)`` positions through the contiguous
    decode kernel.  step: ``_ring_step``'s (positions, rows, slots, valid
    counts)."""
    b = x.shape[0]
    pos, rows, slot, n_valid = step
    h = cm.apply_norm(x, ap["ln"], cfg.norm_type)
    q, k, v = _qkv(ap, cfg, h, pos)
    kc.index_put_((rows, slot), k[:, 0])
    vc.index_put_((rows, slot), v[:, 0])
    attn = ops.decode(q, kc, vc, n_valid)
    return x + attn.reshape(b, 1, cfg.q_dim) @ ap["wo"]


def _ring_step(length: torch.Tensor, b: int, cap: int
               ) -> Tuple[torch.Tensor, ...]:
    """What every attention block of one decode step shares: the scalar
    ``length`` broadcast to (B, 1) positions, the rows, each row's ring
    slot ``length % cap`` and its (B,) int32 count of valid positions
    ``min(length + 1, cap)``."""
    lens = length.long().reshape(-1).expand(b)
    return (lens[:, None], torch.arange(b, device=length.device), lens % cap,
            torch.clamp(lens + 1, max=cap).to(torch.int32))


def _mlp_block(mp: Dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Gated tanh-GeLU MLP with its residual."""
    h = cm.apply_norm(x, mp["ln"], cfg.norm_type)
    return x + (cm.gelu(h @ mp["w_gate"]) * (h @ mp["w_up"])) @ mp["w_down"]


def _blocks(params: Dict, cfg: ModelConfig):
    """Every block in order: (where, group index or None, i, kind, block
    params, MLP params)."""
    n_groups, tail = group_structure(cfg)
    pat = block_pattern(cfg)
    for g in range(n_groups):
        gp = _index(params["groups"], g)
        for i, kind in enumerate(pat):
            yield "groups", g, i, kind, gp[f"blk{i}"], gp[f"mlp{i}"]
    for i, kind in enumerate(tail):
        yield ("tail", None, i, kind, params["tail"][f"blk{i}"],
               params["tail"][f"mlp{i}"])


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
                k = torch.roll(k[:, -win:], shifts=s % win, dims=1)
                v = torch.roll(v[:, -win:], shifts=s % win, dims=1)
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
    x = params["embed"][token]
    step = None
    for where, g, i, kind, bp, mp in _blocks(params, cfg):
        st = (cache["tail"][i] if where == "tail"
              else _index(cache["groups"][f"blk{i}"], g))
        if kind == "rec":
            x, h_new, conv_new = _rec_block(bp, cfg, x, h0=st["h"],
                                            conv_state=st["conv"],
                                            decode=True)
            st["h"].copy_(h_new)
            st["conv"].copy_(conv_new)
        else:
            if step is None:
                step = _ring_step(length, token.shape[0], st["k"].shape[1])
            x = _attn_block_decode(bp, cfg, x, st["k"], st["v"], step)
        x = _mlp_block(mp, cfg, x)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return dense.logits_of(params, cfg, x), {**cache,
                                            "length": length + 1}
