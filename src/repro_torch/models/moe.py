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
waves.

Under a mesh the reference's annotations sit at the same places: the
dispatched buffer and the expert activations (B, E, C, .) with the
experts over ``model``, and the layer's output.  With
``runtime.moe_a2a`` the layer runs as ``_moe_mlp_a2a``: tokens
sequence-sharded over ``model``, each rank routing only its own, and two
all-to-alls moving the (B, E, C, d) buffers to the ranks that own each
expert and back.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.compat import meshenv
from repro_torch.models import common as cm
from repro_torch.models import dense, runtime
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
    gates, experts, me, ce = _route_stats(cfg, router_w, x)
    return gates, experts, cfg.n_experts * torch.sum(me * ce)


def _route_stats(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """``route`` with the aux loss's two factors: (gates, experts, the
    mean router probability per expert ``P_e`` (E,), the share of tokens
    whose first choice is each expert ``f_e`` (E,))."""
    logits = x.float() @ router_w.float()                  # (B, S, E)
    probs = torch.softmax(logits, dim=-1)
    gates, experts = torch.topk(probs, cfg.top_k, dim=-1)
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    me = probs.mean(dim=(0, 1))                             # (E,)
    ce = F.one_hot(experts[..., 0], cfg.n_experts).float().mean(dim=(0, 1))
    return gates, experts, me, ce


def _dispatch(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor):
    """Sort-free capacity dispatch.  x: (B, S, d) -> (xin (B, E, C, d),
    disp (B, E*C) token index per slot (S: the pad row), gsel (B, E*C)
    float32 gate per slot, aux loss)."""
    xin, disp, gsel, me, ce = _dispatch_stats(cfg, router_w, x)
    return xin, disp, gsel, cfg.n_experts * torch.sum(me * ce)


def _dispatch_stats(cfg: ModelConfig, router_w: torch.Tensor,
                    x: torch.Tensor):
    """``_dispatch`` with the aux loss's factors (``_route_stats``) in
    place of the loss."""
    b, s, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = expert_capacity(cfg, s)
    gates, experts, me, ce = _route_stats(cfg, router_w, x)
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
    return xin.reshape(b, E, C, d), disp, gsel, me, ce


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
    loss.  Under ``runtime.moe_a2a`` the all-to-all form runs where it
    can (``_moe_mlp_a2a``).

    On a DTensor the routing, the dispatch and the combine -- row-local,
    and made of sorts, searches and scatters DTensor has no sharding rules
    for -- run on this rank's batch rows, and the aux loss's two factors
    are averaged over the batch shards before their product; the expert
    products run on DTensors, the experts over ``model``."""
    if runtime.moe_a2a():
        out = _moe_mlp_a2a(cfg, lp, x)
        if out is not None:
            return out
    rows = _row_placements(x)
    x_l = _local(x, rows)
    # each rank routes its own rows: the router's gradient is a partial
    # sum over the batch shards
    router = _local(lp["router"], None, rows and _partial_where_split(rows))
    xin, disp, gsel, me, ce = _dispatch_stats(cfg, router, x_l)
    if rows is not None:
        me, ce = (_mean_over_shards(t, x.device_mesh, rows) for t in (me, ce))
        xin = DTensor.from_local(xin, x.device_mesh, rows, run_check=False)
    aux = cfg.n_experts * torch.sum(me * ce)
    xin = cm.shard(xin, "batch", "model", None, None)
    h = torch.einsum("becd,edf->becf", xin, lp["we_gate"])
    u = torch.einsum("becd,edf->becf", xin, lp["we_up"])
    h = cm.shard(F.silu(h) * u, "batch", "model", None, None)
    eout = torch.einsum("becf,efd->becd", h, lp["we_down"])
    out = _combine(x_l, _local(eout, rows), disp, gsel)
    if rows is not None:
        out = DTensor.from_local(out.contiguous(), x.device_mesh, rows,
                                 run_check=False)
    return cm.shard(out, "batch", "seq", None), aux


def _row_placements(x: torch.Tensor):
    """For a DTensor, placements holding this rank's batch rows whole:
    dim 0 over the batch axes (when they divide it), the rest
    replicated; None for a plain tensor."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names)
    bx = tuple(a for a in cm.BATCH_AXES if a in names)
    split = bool(bx) and x.shape[0] % meshenv.mesh_size(mesh, bx) == 0
    return meshenv.placed(mesh, {a: 0 for a in bx} if split else {})


def _mean_over_shards(t: torch.Tensor, mesh, placements) -> DTensor:
    """The mean over the shards of the data placed as ``placements`` of
    each rank's equal-sized statistic ``t``, replicated: their partial sum
    over the shards, over the shard count.  Its gradient reaches each
    rank's ``t`` divided by the count, as the mean's does (the backward of
    a partial sum keeps the replicated gradient on every rank)."""
    n = math.prod(mesh.size(i) for i, p in enumerate(placements)
                  if p.is_shard())
    rep = [Replicate()] * mesh.ndim
    total = DTensor.from_local(t, mesh, _partial_where_split(placements),
                               run_check=False)
    return total.redistribute(mesh, rep) / n


def _partial_where_split(placements):
    """Gradient placements of a replicated input that every rank uses on
    its own shard of the data placed as ``placements``: a partial sum on
    the mesh dims that split the data."""
    return [Partial() if p.is_shard() else Replicate() for p in placements]


def _local(t: torch.Tensor, placements=None, grad_placements=None
           ) -> torch.Tensor:
    """This rank's shard of the DTensor ``t`` placed as ``placements``
    (default: replicated); a plain tensor as it is.  ``grad_placements``:
    how the gradient of the local shard is placed, when not as the
    shard itself (``DTensor.to_local``)."""
    if not isinstance(t, DTensor):
        return t
    mesh = t.device_mesh
    want = list(placements or [Replicate()] * mesh.ndim)
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local(grad_placements=grad_placements)


def _moe_mlp_a2a(cfg: ModelConfig, lp: Dict, x: torch.Tensor):
    """Expert-parallel all-to-all dispatch, per rank.

    Tokens are sequence-sharded over ``model``: each rank routes only its
    own S/m tokens (``_dispatch``, with capacity from S/m), then one
    ``all_to_all_single`` sends each expert's (B_l, C, d) buffer to the
    rank that owns it (experts ``[r E/m, (r+1) E/m)`` on rank r), the rank
    runs its experts over the m senders' buffers, and a second one sends
    the outputs back for the combine; each rank's aux loss is averaged
    over every shard (the reference's ``pmean`` over ``model``; its batch
    shards it leaves to the replicated out spec).  Returns None -- the einsum
    path runs instead -- with no mesh, no ``model`` axis, ``m == 1``, or
    shapes that do not divide, as the reference does."""
    mesh = meshenv.current_mesh()
    if mesh is None or "model" not in mesh.mesh_dim_names:
        return None
    m = meshenv.mesh_size(mesh, "model")
    b, s, d = x.shape
    names = tuple(mesh.mesh_dim_names)
    bx = tuple(a for a in cm.BATCH_AXES if a in names)
    nb = meshenv.mesh_size(mesh, bx)
    if m == 1 or cfg.n_experts % m or s % m or (bx and b % nb):
        return None
    e_loc = cfg.n_experts // m

    x_pl = meshenv.placed(mesh, {**{a: 0 for a in bx}, "model": 1})
    w_pl = meshenv.placed(mesh, {"model": 0})

    x_l = _local(x, x_pl)                                  # (B_l, S/m, d)
    # every rank routes its own tokens, and runs its experts on its batch
    # rows: the gradients are partial sums over the mesh dims that split
    # those
    router = _local(lp["router"], None, _partial_where_split(x_pl))
    w_grad = [w if w.is_shard() else Partial() if x.is_shard()
              else Replicate() for w, x in zip(w_pl, x_pl)]
    wg, wu, wd = (_local(lp[k], w_pl, w_grad)
                  for k in ("we_gate", "we_up", "we_down"))
    xin, disp, gsel, aux = _dispatch(cfg, router, x_l)     # (B_l, E, C, d)
    bl, _, c, _ = xin.shape
    group = mesh.get_group("model")
    # rank-major (m, B_l, e_loc, C, d): chunk r goes to the owner rank r
    send = xin.reshape(bl, m, e_loc, c, d).transpose(0, 1).contiguous()
    recv = funcol.all_to_all_single_autograd(send, None, None, group)
    # (m senders, B_l, e_loc, C, d) -> (B_l, e_loc, m * C, d)
    recv = recv.reshape(m, bl, e_loc, c, d).permute(1, 2, 0, 3, 4).reshape(
        bl, e_loc, m * c, d)
    h = torch.einsum("becd,edf->becf", recv, wg)
    u = torch.einsum("becd,edf->becf", recv, wu)
    eout = torch.einsum("becf,efd->becd", F.silu(h) * u, wd)
    send = eout.reshape(bl, e_loc, m, c, d).permute(2, 0, 1, 3, 4)
    back = funcol.all_to_all_single_autograd(send.contiguous(), None, None,
                                             group)
    back = back.reshape(m, bl, e_loc, c, d).transpose(0, 1).reshape(
        bl, cfg.n_experts, c, d)
    out = DTensor.from_local(_combine(x_l, back, disp, gsel).contiguous(),
                             mesh, x_pl, run_check=False)
    return (cm.shard(out, "batch", "seq", None),
            _mean_over_shards(aux, mesh, x_pl))


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
    zero-padded, or a window config's ring).  ``tokens`` may be a batch
    dict, as the reference's prefill takes."""
    kvs: Dict[str, list] = {}
    x, _ = _forward(params, cfg, tokens, kvs)
    s = x.shape[1]
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
