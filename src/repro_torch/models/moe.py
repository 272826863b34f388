"""Mixture-of-Experts transformer (granite-3.0-MoE, DBRX) on tensors.

Port of ``repro.models.moe``.  The blocks are the dense family's
(``dense._forward_blocks`` and ``dense.decode_step``, given this module's
MLP: the same projections, RoPE and norms, attention through the prefill
and contiguous decode kernels; the MoE configs have no biases and no
parallel block, so these are the reference's MoE blocks); the MLP is a
top-k token-choice router with capacity-based, sort-free dispatch, as in
the reference:

* per batch row, the S*k assignments are stably sorted by expert; an
  entry's rank within its expert is its sorted index minus the expert's
  first index (``searchsorted``, left side), so no (T, E) one-hot is made;
* entries ranked at or past the per-expert capacity
  ``C = max(k, min(int(S k / E cf), S))`` are dropped (Switch/GShard);
  they go to a sentinel column ``E*C``, which is written and then sliced
  off, and their slots hold the pad row ``S``;
* the combine scatter-adds the gated expert outputs into ``S + 1`` rows
  and drops the last (the pad row), where the reference's scatter drops
  index ``S`` as out of range.

The router weights and logits are float32 whatever ``cfg.dtype`` is.  The
three expert products are batched over the expert axis with
``torch.einsum``, as the reference leaves them to XLA; no TPU kernel
computes them.  Pad tokens take expert capacity as real ones do: a
left-padded wave routes them like the reference.

The decode path is the reference's lock-step one: one scalar cache
length for every row (``decode_step``), so the family has no slot,
paged or verify capability and the engine serves it on left-padded
waves.  The reference's expert-parallel all-to-all variant
(``_moe_mlp_a2a``) is mesh work, ROADMAP Queue A item 10.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.config import ModelConfig


def expert_capacity(cfg: ModelConfig, tokens_per_row: int) -> int:
    c = int(tokens_per_row * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(cfg.top_k, min(c, tokens_per_row))


# --------------------------------------------------------------------- init
def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """The dense family's attention, norms and embeddings
    (``dense.init``, its MLP weights dropped, as the reference drops
    them), plus per layer a router (d, E) in float32, normal
    ``0.1/sqrt(d)``, and per expert SwiGLU weights ``we_gate``/``we_up``
    (E, d, f) and ``we_down`` (E, f, d) in ``dtype`` (default
    ``cfg.dtype``), normal ``1/sqrt(d_in)``, as the reference draws them."""
    p = dense.init(cfg, generator, device, dtype)
    dt = dtype or getattr(torch, cfg.dtype)
    L, d, f, E = cfg.n_layers, cfg.d_model, cfg.d_ff, cfg.n_experts
    lyr = p["layers"]
    for name in ("w_gate", "w_up", "w_down", "b_up", "b_down"):
        lyr.pop(name, None)
    lyr["router"] = cm.dense_init(generator, (L, d, E), torch.float32,
                                  device, scale=0.1)
    lyr["we_gate"] = cm.dense_init(generator, (L, E, d, f), dt, device)
    lyr["we_up"] = cm.dense_init(generator, (L, E, d, f), dt, device)
    lyr["we_down"] = cm.dense_init(generator, (L, E, f, d), dt, device)
    return p


# ---------------------------------------------------------------- MoE layer
def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (gates (B, S, k) float32, experts (B, S, k), the
    Switch load-balance loss ``E * sum_e f_e P_e`` ())."""
    logits = x.float() @ router_w.float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = F.one_hot(experts[..., 0], cfg.n_experts).float().mean(dim=(0, 1))
    aux = cfg.n_experts * torch.sum(me * ce)
    return gates, experts, aux


def _dispatch(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """Sort-free capacity dispatch.  x: (B, S, d) -> (xin (B, E, C, d),
    disp (B, E*C) token index per slot (S: the pad row), gsel (B, E*C)
    float32 gate per slot, aux loss)."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, s)
    gates, experts, aux = route(cfg, router_w, x)
    ef = experts.reshape(b, s * k)
    gf = gates.reshape(b, s * k)
    order = torch.argsort(ef, dim=1, stable=True)           # (B, S*k)
    e_sorted = torch.gather(ef, 1, order)
    g_sorted = torch.gather(gf, 1, order)
    tok_sorted = order // k                                 # token index
    # rank of each entry within its expert: its sorted index minus the
    # expert's first sorted index
    firsts = torch.arange(E, device=x.device).expand(b, E).contiguous()
    starts = torch.searchsorted(e_sorted, firsts)           # (B, E), left
    rank = (torch.arange(s * k, device=x.device)[None, :]
            - torch.gather(starts, 1, e_sorted))
    keep = rank < C
    slot = e_sorted * C + torch.clamp(rank, max=C - 1)
    slot = torch.where(keep, slot, torch.full_like(slot, E * C))  # sentinel
    # each (expert, capacity) slot's token; the sentinel column takes the
    # dropped entries and is sliced off
    disp = torch.full((b, E * C + 1), s, dtype=torch.long, device=x.device)
    disp.scatter_(1, slot, tok_sorted)
    disp = disp[:, :E * C]
    gsel = torch.zeros((b, E * C + 1), dtype=torch.float32, device=x.device)
    gsel.scatter_(1, slot, g_sorted)
    gsel = gsel[:, :E * C]
    xp = torch.cat([x, x.new_zeros((b, 1, d))], dim=1)      # + the pad row
    xin = torch.gather(xp, 1, disp[:, :, None].expand(b, E * C, d))
    return xin.reshape(b, E, C, d), disp, gsel, aux


def _combine(x: torch.Tensor, eout: torch.Tensor, disp: torch.Tensor,
             gsel: torch.Tensor) -> torch.Tensor:
    """Scatter-add the gated expert outputs eout (B, E, C, d) back to token
    order, in float32; slots holding the pad row ``S`` add into an extra
    row that is dropped."""
    b, s, d = x.shape
    ec = disp.shape[1]
    eout = eout.reshape(b, ec, d).float() * gsel[:, :, None]
    out = torch.zeros((b, s + 1, d), dtype=torch.float32, device=x.device)
    out.scatter_add_(1, disp[:, :, None].expand(b, ec, d), eout)
    return out[:, :s].to(x.dtype)


def moe_mlp(cfg: ModelConfig, lp: Dict, x: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based top-k expert SwiGLU.  x: (B, S, d) -> (B, S, d), aux
    loss."""
    xin, disp, gsel, aux = _dispatch(cfg, lp["router"], x)
    h = torch.einsum("becd,edf->becf", xin, lp["we_gate"])
    u = torch.einsum("becd,edf->becf", xin, lp["we_up"])
    eout = torch.einsum("becf,efd->becd", F.silu(h) * u, lp["we_down"])
    return _combine(x, eout, disp, gsel), aux


def _mlp(lp: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
    """``moe_mlp`` without its aux loss, as the dense blocks take an MLP."""
    return moe_mlp(cfg, lp, h)[0]


# ------------------------------------------------------------------ forward
def _forward(params: Dict, cfg: ModelConfig, tokens: torch.Tensor,
             kvs: Optional[Dict[str, list]] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every block over ``tokens`` (B, S): the dense family's blocks
    (``dense._forward_blocks``: attention through the prefill kernel, then
    the MLP over ``ln2``) with the MoE MLP, whose aux losses are kept; the
    final-normed hidden states (B, S, d) and the layers' mean aux loss."""
    auxes = []

    def mlp(lp: Dict, cfg: ModelConfig, h: torch.Tensor) -> torch.Tensor:
        out, aux = moe_mlp(cfg, lp, h)
        auxes.append(aux)
        return out

    x = dense._forward_blocks(params, cfg, tokens, kvs, mlp)
    x = cm.apply_norm(x, params["final_norm"], cfg.norm_type)
    return x, torch.stack(auxes).mean()


def apply(params: Dict, cfg: ModelConfig, batch: Dict
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward: (logits (B, S, padded_vocab), the layers'
    mean aux loss)."""
    x, aux = _forward(params, cfg, batch["tokens"])
    return dense.logits_of(params, cfg, x), aux


# --------------------------------------------------------------- decode path
def prefill(params: Dict, cfg: ModelConfig, tokens: torch.Tensor, *,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (B, S), build the KV cache, return the last
    position's logits (B, 1, padded_vocab) and {"k", "v":
    (L, B, cap, Hkv, dh), "length": S, a () int32 tensor}; the cache is
    laid out as ``dense.prefill`` lays it out (``capacity`` positions,
    zero-padded, or a window config's ring)."""
    s = tokens.shape[1]
    kvs: Dict[str, list] = {}
    x, _ = _forward(params, cfg, tokens, kvs)
    cache = dense._cache_of(kvs, dense._capacity(cfg, s, capacity), s,
                            x.device)
    return dense.logits_of(params, cfg, x[:, -1:]), cache


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One lock-step decode step: ``dense.decode_step`` with the MoE MLP.
    cache: {"k"/"v": (L, B, C, Hkv, dh), "length": () int32}; token:
    (B, 1).  Every row's new KV goes to slot ``length % C``, in place,
    then every row attends ``min(length + 1, C)`` positions through the
    contiguous decode kernel (the length broadcast to (B,)).  Returns
    (logits (B, 1, padded_vocab), cache with length + 1)."""
    return dense.decode_step(params, cfg, cache, token, _mlp)


init_cache = dense.init_cache
