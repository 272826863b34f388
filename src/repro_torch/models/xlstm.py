"""xLSTM (arXiv:2405.04517) on tensors: mLSTM (matrix memory) and sLSTM
(scalar memory) blocks.

Port of ``repro.models.xlstm``.  xlstm-1.3b repeats groups of seven mLSTM
blocks and one sLSTM block (``cfg.xlstm_pattern``); ``cfg.n_layers`` past
the last full group leaves a tail of the pattern's first kinds.  Each
block carries its own projections (``d_ff = 0``).

The mLSTM runs in the chunkwise-parallel form over a sequence
(``mlstm_chunkwise``: inside a chunk a masked attention-like product,
across chunks the recurrent state C (dh x dh), n (dh), m) and in the exact
recurrent form at decode (``mlstm_recurrent_step``).  The sLSTM feeds
h_{t-1} back into its gates, so it is a sequential loop over time
(``_slstm_block``).  The reference computes all of it in XLA, with no TPU
kernel, and so the port keeps it in PyTorch ops: a decode step launches
none of the attention kernels.

Float32 where the reference has it: the mLSTM's gate weights ``w_i``,
``w_f``, ``b_f`` and the sLSTM's recurrent matrices ``r_*`` and ``b_f``
are float32 whatever ``cfg.dtype`` is, and q, k, v, the gates and every
state are float32.  Traps kept from the reference: a padded chunk step
takes ``i = -1e30`` and ``f = 30`` (no write, no decay); the stabilizer
starts at ``m = -1e30``; where ``m_t`` is very negative,
``max(|den|, exp(-m_t))`` is ``inf`` and h is 0 (not clamped); the decode
conv applies the kernel reversed over its history window.

Under the dry run's roofline mode (``runtime.roofline_mode``) the
reference's two sites are taken: the sLSTM over a sequence becomes its
parallel surrogate (``_slstm_surrogate``: the same op counts a step, the
feedback ``h_{t-1}`` replaced by the shifted input stream; the values
differ), and the mLSTM's chunk is at least 1024.  The dry run's memory
runs take the surrogate alone (``runtime.surrogate_slstm``).

Layouts are the reference's: weights ``(d_in, d_out)``; the groups' params
stacked on a leading ``n_groups`` axis under ``groups.blk{i}``, the tail's
unstacked under ``tail.blk{i}``; the decode cache ``{"groups": {blk{i}:
{"C", "n", "m", "conv"} or {"c", "n", "m", "h"}} stacked on groups,
"tail": [per tail block], "length": ()}``.  Unlike the reference,
``decode_step`` updates the cache's tensors in place.

Under a mesh the params, batch and cache may be DTensors sharded by
``launch.sharding`` (the reference has no ``cm.shard`` site here): the
weights are FSDP-gathered on use, each block's output projection sums
its partial sums over ``model`` before the residual (as ``rglru``
does), the decode's embeddings are looked up on each rank's rows, and
the states are copied back into the stacked cache in its own placements
(``common.copy_into``).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.compat import meshenv
from repro_torch.models import common as cm
from repro_torch.models import dense, runtime
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import _causal_conv, _index

_NEG = -1e30          # "minus infinity" of the stabilizer and of pad gates


def _reshape_last(a: torch.Tensor, shape: Tuple[int, ...],
                  n: int) -> torch.Tensor:
    """``a`` with its last ``n`` dims reshaped to ``shape``.  A DTensor is
    reshaped on each rank's own tensor after those dims are gathered
    where they are sharded: DTensor splits no uneven shard (xlstm-1.3b's
    4 heads over the cluster's ``model`` axis of 8), and the gradient of a
    merge is a split."""
    lead = tuple(a.shape[:a.ndim - n])
    if not isinstance(a, DTensor):
        return a.reshape(*lead, *shape)
    mesh = a.device_mesh
    pl = [Replicate() if p.is_shard() and p.dim >= a.ndim - n else p
          for p in a.placements]
    if pl != list(a.placements):
        a = a.redistribute(mesh, pl)
    local = a.to_local()
    return DTensor.from_local(
        local.reshape(*local.shape[:a.ndim - n], *shape), mesh, pl,
        run_check=False)


def _split_heads(a: torch.Tensor, nh: int) -> torch.Tensor:
    """(..., nh * dh) -> (..., nh, dh)."""
    return _reshape_last(a, (nh, a.shape[-1] // nh), 1)


def _merge_heads(a: torch.Tensor) -> torch.Tensor:
    """(..., nh, dh) -> (..., nh * dh)."""
    return _reshape_last(a, (a.shape[-2] * a.shape[-1],), 2)


def _dt(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def block_pattern(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kinds of one group ("m": mLSTM, "s": sLSTM)."""
    return cfg.xlstm_pattern or ("m", "s")


def group_structure(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    """(full groups, the tail's block kinds) of ``cfg.n_layers``."""
    pat = block_pattern(cfg)
    n_groups = cfg.n_layers // len(pat)
    tail = pat[: cfg.n_layers - n_groups * len(pat)]
    return n_groups, tail


def _ud(cfg: ModelConfig) -> int:
    """The mLSTM's up-projected width."""
    return int(cfg.d_model * cfg.xlstm_up_factor)


# ------------------------------------------------------------------ params
def _blockdiag(gen, lead, h, dh, dt, device):
    """Per-head (dh, dh) matrices, normal 1/sqrt(dh)."""
    return cm.dense_init(gen, lead + (h, dh, dh), dt, device)


def _mlstm_params(gen: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                  device, lead: Tuple[int, ...]) -> Dict:
    d, ud, h = cfg.d_model, _ud(cfg), cfg.n_heads
    dh = ud // h
    f32 = torch.float32

    def proj(d_in, d_out, dtype=dt, scale=1.0):
        return cm.dense_init(gen, lead + (d_in, d_out), dtype, device, scale)

    return {
        "ln": cm.norm_params(lead + (d,), "rmsnorm", dt, device),
        "w_up": proj(d, ud),
        "w_gate": proj(d, ud),
        "conv_w": torch.empty(lead + (cfg.conv_width, ud), dtype=dt,
                              device=device).normal_(0.0, 0.1,
                                                     generator=gen),
        "conv_b": torch.zeros(lead + (ud,), dtype=dt, device=device),
        "wq": _blockdiag(gen, lead, h, dh, dt, device),
        "wk": _blockdiag(gen, lead, h, dh, dt, device),
        "wv": _blockdiag(gen, lead, h, dh, dt, device),
        "w_i": proj(ud, h, f32, 0.3),
        "w_f": proj(ud, h, f32, 0.3),
        "b_f": torch.full(lead + (h,), 3.0, dtype=f32, device=device),
        "w_down": proj(ud, d),
    }


def _slstm_params(gen: torch.Generator, cfg: ModelConfig, dt: torch.dtype,
                  device, lead: Tuple[int, ...]) -> Dict:
    d, h = cfg.d_model, cfg.n_heads
    dh = d // h
    fup = int(d * 4 / 3)
    f32 = torch.float32

    def proj(d_in, d_out):
        return cm.dense_init(gen, lead + (d_in, d_out), dt, device)

    p = {"ln": cm.norm_params(lead + (d,), "rmsnorm", dt, device)}
    for g in ("z", "i", "f", "o"):
        p[f"w_{g}"] = proj(d, d)
        p[f"r_{g}"] = _blockdiag(gen, lead, h, dh, f32, device)
    p["b_f"] = torch.full(lead + (d,), 3.0, dtype=f32, device=device)
    p.update(w_up1=proj(d, fup), w_up2=proj(d, fup), w_down=proj(fup, d))
    return p


_MAKE = {"m": _mlstm_params, "s": _slstm_params}


def init(cfg: ModelConfig, generator: torch.Generator,
         device: torch.device | str, dtype: Optional[torch.dtype] = None
         ) -> Dict:
    """Random weights with the reference's distributions (normal
    ``1/sqrt(d_in)`` projections and per-head matrices, ``0.3/sqrt(ud)``
    float32 gate weights, forget biases 3.0 in float32, normal 0.1 conv
    kernels, zero conv biases, normal 0.02 embeddings, unit RMSNorm
    scales), drawn from ``generator`` on ``device`` in ``dtype`` (default
    ``cfg.dtype``): ``embed``, ``final_norm``, ``lm_head`` unless the
    embeddings are tied, ``groups`` (each block's params stacked on
    ``n_groups``) and ``tail``."""
    dt = dtype or _dt(cfg)
    n_groups, tail = group_structure(cfg)
    p: Dict = {
        "embed": cm.embed_init(generator, cfg.padded_vocab, cfg.d_model, dt,
                               device),
        "final_norm": cm.norm_params((cfg.d_model,), "rmsnorm", dt, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = cm.dense_init(generator, (cfg.d_model,
                                                 cfg.padded_vocab), dt,
                                     device)
    p["groups"] = {f"blk{i}": _MAKE[kind](generator, cfg, dt, device,
                                          (n_groups,))
                   for i, kind in enumerate(block_pattern(cfg))}
    p["tail"] = {f"blk{i}": _MAKE[kind](generator, cfg, dt, device, ())
                 for i, kind in enumerate(tail)}
    return p


# -------------------------------------------------------------- mLSTM cell
def _qkvif(mp: Dict, cfg: ModelConfig, conv: torch.Tensor,
           u: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The cell's inputs from the conv branch (after its SiLU) and the up
    projection u, both (B, T, ud): q, k, v (B, T, H, dh) and the gate
    pre-activations i, f (B, T, H), all float32."""
    ud = u.shape[-1]
    h = cfg.n_heads
    dh = ud // h
    ch = _split_heads(conv, h).float()
    uh = _split_heads(u, h).float()
    q = torch.einsum("bthd,hde->bthe", ch, mp["wq"].float())
    k = torch.einsum("bthd,hde->bthe", ch, mp["wk"].float()) / dh ** 0.5
    v = torch.einsum("bthd,hde->bthe", uh, mp["wv"].float())
    cf = conv.float()
    return q, k, v, cf @ mp["w_i"], cf @ mp["w_f"] + mp["b_f"]


def _local_layout(mesh, rows: int, heads: int
                  ) -> Tuple[Dict[str, int], bool]:
    """How a cell of ``rows`` batch rows and ``heads`` heads runs on
    ``mesh``'s local shards: (the batch axes that shard the rows, as
    ``{axis: 0}``, where they divide them; whether ``model`` shards the
    heads, where it divides them)."""
    sizes = meshenv.axis_sizes(mesh)
    bx = [a for a in ("pod", "data") if a in sizes]
    split = rows % math.prod(sizes[a] for a in bx) == 0
    return ({a: 0 for a in bx} if split else {},
            "model" in sizes and heads % sizes["model"] == 0)


def _mlstm_cell(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                it: torch.Tensor, ft: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, ...]], *extra
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``fn(q, k, v, it, ft, state, *extra)``, the chunkwise or the
    recurrent mLSTM.  On DTensors each rank runs it on plain local tensors
    of its own batch rows and heads (the heads over ``model`` where it
    divides them, else whole on every rank): every op of the cell is per
    row and per head, so nothing crosses ranks, and DTensor needs no rule
    for its ops (torch 2.11 has none for ``cummax``)."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, it, ft, state, *extra)
    mesh = q.device_mesh
    rows, tp = _local_layout(mesh, q.shape[0], q.shape[2])

    seq = {**rows, **({"model": 2} if tp else {})}    # (B, T, H, ...)
    st = {**rows, **({"model": 1} if tp else {})}     # (B, H, ...)
    local = [meshenv.to_local(a, mesh, seq) for a in (q, k, v, it, ft)]
    if state is not None:
        state = tuple(meshenv.to_local(a, mesh, st) for a in state)
    h, out = fn(*local, state, *extra)
    return (meshenv.from_local(h, q, seq),
            tuple(meshenv.from_local(a, q, st) for a in out))


def _mlstm_qkvif(mp: Dict, cfg: ModelConfig, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, ...]:
    """x: (B, T, d) -> q, k, v (B, T, H, dh) float32, the gate
    pre-activations i, f (B, T, H) float32, the output gate branch g and
    the up projection u (B, T, ud)."""
    h = cm.apply_norm(x, mp["ln"], "rmsnorm")
    u = h @ mp["w_up"]
    g = h @ mp["w_gate"]
    conv = F.silu(_causal_conv(u, mp["conv_w"], mp["conv_b"]))
    return _qkvif(mp, cfg, conv, u) + (g, u)


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    it: torch.Tensor, ft: torch.Tensor,
                    state: Optional[Tuple[torch.Tensor, ...]] = None,
                    chunk: int = 64
                    ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """Chunkwise-parallel mLSTM.  q, k, v: (B, T, H, dh); it, ft: (B, T,
    H), all float32; ``state`` (C (B, H, dh, dh), n (B, H, dh), m (B, H))
    or None for the zero state with ``m = -1e30``.  Returns (h (B, T, H,
    dh), the final state).  T is padded to a multiple of ``min(chunk, T)``
    with identity steps (``i = -1e30``: no write and no pull on the
    stabilizer; ``f = 30``: no decay); the chunks run in a loop."""
    b, t, nh, dh = q.shape
    chunk = min(chunk, t)
    pad = (-t) % chunk
    if pad:
        q, k, v = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (q, k, v))
        it = F.pad(it, (0, 0, 0, pad), value=_NEG)
        ft = F.pad(ft, (0, 0, 0, pad), value=30.0)
    nc = (t + pad) // chunk

    def rs(a):      # (B, nc * c, ...) -> (B, nc, c, ...)
        return a.reshape(b, nc, chunk, *a.shape[2:])

    qc, kc, vc, ic, fc = (rs(a) for a in (q, k, v, it, ft))
    if state is None:
        C = q.new_zeros((b, nh, dh, dh))
        n = q.new_zeros((b, nh, dh))
        m = q.new_full((b, nh), _NEG)
    else:
        C, n, m = state
    causal = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                   device=q.device))[None, :, :, None]
    hs = []
    for j in range(nc):
        qj, kj, vj, ij, fj = qc[:, j], kc[:, j], vc[:, j], ic[:, j], fc[:, j]
        cumf = torch.cumsum(F.logsigmoid(fj), dim=1)            # (B, c, H)
        bb = ij - cumf                          # b_s = i_s - cumlogf_s
        big_m = torch.maximum(torch.cummax(bb, dim=1).values, m[:, None])
        m_t = cumf + big_m
        # intra-chunk: w_ts = exp(b_s - M_t) for s <= t
        w = torch.exp(bb[:, None, :, :] - big_m[:, :, None, :])  # (B,t,s,H)
        w = torch.where(causal, w, 0.0)
        sw = torch.einsum("bthd,bshd->btsh", qj, kj) * w
        intra_num = torch.einsum("btsh,bshd->bthd", sw, vj)
        intra_den = sw.sum(dim=2)
        # inter-chunk: the incoming state, decayed
        inter_scale = torch.exp(m[:, None] - big_m)              # (B, c, H)
        inter_num = (torch.einsum("bthd,bhde->bthe", qj, C)
                     * inter_scale[..., None])
        inter_den = torch.einsum("bthd,bhd->bth", qj, n) * inter_scale
        den = intra_den + inter_den
        hs.append((intra_num + inter_num)
                  / torch.maximum(den.abs(), torch.exp(-m_t))[..., None])
        # the state carried to the next chunk
        total_f = cumf[:, -1]                                    # (B, H)
        m_next = total_f + big_m[:, -1]
        sc = torch.exp(ij - cumf + (total_f - m_next)[:, None])  # (B, c, H)
        decay = torch.exp(m + total_f - m_next)
        C = (C * decay[..., None, None]
             + torch.einsum("bshd,bsh,bshe->bhde", kj, sc, vj))
        n = n * decay[..., None] + torch.einsum("bshd,bsh->bhd", kj, sc)
        m = m_next
    h = torch.stack(hs, dim=1).reshape(b, t + pad, nh, dh)[:, :t]
    return h, (C, n, m)


def mlstm_recurrent_step(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         it: torch.Tensor, ft: torch.Tensor,
                         state: Tuple[torch.Tensor, ...]
                         ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The exact recurrent mLSTM step.  q, k, v: (B, 1, H, dh); it, ft:
    (B, 1, H); state (C, n, m).  Returns (h (B, 1, H, dh), the new
    state)."""
    C, n, m = state
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                       # (B, H, dh)
    logf = F.logsigmoid(ft[:, 0])                                # (B, H)
    i1 = it[:, 0]
    m_new = torch.maximum(logf + m, i1)
    fp = torch.exp(logf + m - m_new)
    ip = torch.exp(i1 - m_new)
    C = (C * fp[..., None, None]
         + ip[..., None, None] * torch.einsum("bhd,bhe->bhde", k1, v1))
    n = n * fp[..., None] + ip[..., None] * k1
    num = torch.einsum("bhd,bhde->bhe", q1, C)
    den = torch.einsum("bhd,bhd->bh", q1, n)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    return h[:, None], (C, n, m_new)


def _mlstm_block(mp: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Tuple[torch.Tensor, ...]] = None,
                 conv_state: Optional[torch.Tensor] = None,
                 decode: bool = False, chunk: int = 64
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                            torch.Tensor]:
    """The mLSTM block over x (B, T, d) in chunks of ``chunk``, or one
    decode token (T = 1) from ``state`` and ``conv_state`` (the last
    ``conv_width - 1`` up projections).  Returns (x + out, the cell
    state, the conv state)."""
    if decode:
        h_in = cm.apply_norm(x, mp["ln"], "rmsnorm")
        u = h_in @ mp["w_up"]
        g = h_in @ mp["w_gate"]
        # hist[:, -1] is u_t and out_t = sum_j w[j] u_{t-j}: the kernel
        # applies reversed over the history window
        hist = torch.cat([conv_state, u], dim=1)                 # (B, cw, ud)
        conv = F.silu((hist * cm.flip0(mp["conv_w"])).sum(dim=1, keepdim=True)
                      + mp["conv_b"])
        hseq, new_state = _mlstm_cell(mlstm_recurrent_step,
                                      *_qkvif(mp, cfg, conv, u), state)
        new_conv = hist[:, 1:]
    else:
        q, k, v, it, ft, g, u = _mlstm_qkvif(mp, cfg, x)
        hseq, new_state = _mlstm_cell(mlstm_chunkwise, q, k, v, it, ft,
                                      state, chunk)
        new_conv = u[:, -(cfg.conv_width - 1):]
    hflat = _merge_heads(hseq).to(x.dtype)
    return (x + cm.project_out(hflat * F.silu(g), mp["w_down"]), new_state,
            new_conv)


# -------------------------------------------------------------- sLSTM cell
def _slstm_ffn(sp: Dict, x: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """x plus the sLSTM block's gated FFN of its cell output h (B, T, d)."""
    return x + cm.project_out(cm.gelu(h @ sp["w_up1"]) * (h @ sp["w_up2"]),
                              sp["w_down"])


def _slstm_block(sp: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The sLSTM block, a sequential loop over time.  x: (B, T, d);
    ``state`` (c, n, m, h), each (B, d) float32, or None for zeros with
    ``m = -1e30``.  Returns (x + the gated FFN of h, the final state).
    Under ``runtime.slstm_surrogate`` (the dry run's) a sequence (T > 1)
    takes ``_slstm_surrogate`` instead.  On DTensors either runs on each
    rank's batch rows and heads (``_slstm_sharded``)."""
    t = x.shape[1]
    nh = cfg.n_heads
    xin = cm.apply_norm(x, sp["ln"], "rmsnorm").float()
    # the input's share of the four gates at every step, each (B, T, d)
    zx, ix, ox = (xin @ sp[f"w_{g}"].float() for g in ("z", "i", "o"))
    fx = xin @ sp["w_f"].float() + sp["b_f"]
    # the recurrent matrices of z, i, f, o, each (H, dh, dh) block-diagonal
    r = torch.stack([sp[f"r_{g}"].float() for g in ("z", "i", "f", "o")])
    cell = (_slstm_surrogate if runtime.slstm_surrogate() and t > 1
            else _slstm_loop)
    pre = (zx, ix, fx, ox)
    if isinstance(zx, DTensor):
        hs, state = _slstm_sharded(cell, pre, r, state, nh)
    else:
        hs, state = cell(pre, r, state, nh)
    return _slstm_ffn(sp, x, hs.to(x.dtype)), state


def _slstm_loop(pre: Tuple[torch.Tensor, ...], r: torch.Tensor,
                state: Optional[Tuple[torch.Tensor, ...]], nh: int
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The sLSTM recurrence over time on plain tensors.  pre: the inputs'
    gate shares (z, i, f, o), each (B, T, d) float32; r: the stacked
    recurrent matrices (4, nh, dh, dh).  Returns (h (B, T, d), (c, n, m,
    h))."""
    b, t, d = pre[0].shape
    steps = torch.stack(pre).permute(2, 0, 1, 3)             # (T, 4, B, d)
    if state is None:
        zeros = steps.new_zeros((b, d))
        state = (zeros, zeros, steps.new_full((b, d), _NEG), zeros)
    c, n, m, h = state
    hs = []
    for s in range(t):
        rec = torch.einsum("bhd,ghde->gbhe", h.reshape(b, nh, d // nh),
                           r).reshape(4, b, d)
        gz, gi, gf, go = steps[s] + rec
        z, o = torch.tanh(gz), torch.sigmoid(go)
        logf = F.logsigmoid(gf)
        m_new = torch.maximum(logf + m, gi)
        fp = torch.exp(logf + m - m_new)
        ip = torch.exp(gi - m_new)
        c = fp * c + ip * z
        n = fp * n + ip
        m = m_new
        h = o * c / torch.clamp(n, min=1.0)
        hs.append(h)
    return torch.stack(hs, dim=1), (c, n, m, h)


def _slstm_sharded(cell, pre: Tuple[torch.Tensor, ...], r: torch.Tensor,
                   state: Optional[Tuple[torch.Tensor, ...]], nh: int
                   ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """``cell`` (``_slstm_loop`` or ``_slstm_surrogate``) on DTensors:
    each rank runs it on its own batch rows (over the data axes) and heads
    (over ``model`` where it divides them; the recurrent matrices are
    block-diagonal, so a head feeds back only into itself), on plain
    local tensors with no collective inside.  The results are DTensors in
    that layout."""
    mesh = pre[0].device_mesh
    rows, tp = _local_layout(mesh, pre[0].shape[0], nh)
    seq = {**rows, **({"model": 2} if tp else {})}          # (B, T, d)
    vec = {**rows, **({"model": 1} if tp else {})}          # (B, d)
    local_pre = [meshenv.to_local(a, mesh, seq) for a in pre]
    # every row uses r: its gradient on a rank is a partial sum over the
    # ranks that hold other rows
    heads = meshenv.placed(mesh, {"model": 1} if tp else {})
    local_r = r.redistribute(mesh, heads).to_local(grad_placements=[
        Partial() if n in rows else p
        for n, p in zip(mesh.mesh_dim_names, heads)]).contiguous()
    local_state = (None if state is None else
                   [meshenv.to_local(a, mesh, vec) for a in state])
    hs, out = cell(local_pre, local_r, local_state, local_r.shape[1])
    return (meshenv.from_local(hs, pre[0], seq),
            tuple(meshenv.from_local(a, pre[0], vec) for a in out))


def _slstm_surrogate(pre: Tuple[torch.Tensor, ...], r: torch.Tensor,
                     state: Optional[Tuple[torch.Tensor, ...]], nh: int
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The reference's FLOPs-equivalent parallel surrogate of the sLSTM
    over a sequence (reference ``xlstm._slstm_block`` under its roofline
    mode), for the dry run's counts: the same op counts a step, the
    feedback ``h_{t-1}`` replaced by the shifted ``z`` input stream, the
    stabilizer, cell and normalizer from cumulative sums, so no loop over
    T remains, and ``state`` is not read.  Values differ from the loop's;
    counts do not.  Arguments and results as ``_slstm_loop``'s."""
    del state
    zx, ix, fx, ox = pre
    b, t, d = zx.shape
    hprev = torch.cat([torch.zeros_like(zx[:, :1]), zx[:, :t - 1]], 1)
    hprev = hprev.reshape(b, t, nh, d // nh)

    def rdot(g):
        return torch.einsum("bthd,hde->bthe", hprev, r[g]).reshape(b, t, d)

    z = torch.tanh(zx + rdot(0))
    i_pre = ix + rdot(1)
    f_pre = fx + rdot(2)
    o = torch.sigmoid(ox + rdot(3))
    logf = F.logsigmoid(f_pre)
    m = torch.maximum(torch.cumsum(logf, 1), i_pre)
    fp, ip = torch.exp(logf), torch.exp(i_pre - m)
    c = torch.cumsum(fp * z * ip, 1)
    n = torch.cumsum(fp * ip, 1)
    h = o * c / torch.clamp(n, min=1.0)
    return h, (c[:, -1], n[:, -1], m[:, -1], h[:, -1])


# ----------------------------------------------------------------- forward
def _blocks(params: Dict, cfg: ModelConfig):
    """Every block in order: (where, group index or None, i, kind, block
    params as they are used)."""
    n_groups, tail = group_structure(cfg)
    for g in range(n_groups):
        gp = cm.used(_index(params["groups"], g))
        for i, kind in enumerate(block_pattern(cfg)):
            yield "groups", g, i, kind, gp[f"blk{i}"]
    tp = cm.used(params["tail"])
    for i, kind in enumerate(tail):
        yield "tail", None, i, kind, tp[f"blk{i}"]


_STATE_NAMES = {"m": ("C", "n", "m"), "s": ("c", "n", "m", "h")}


def _forward(params: Dict, cfg: ModelConfig, inputs, want_cache: bool,
             chunk: int) -> Tuple[torch.Tensor, Optional[Dict]]:
    if runtime.roofline_mode():
        chunk = max(chunk, 1024)    # the reference's: few, unrolled chunks
    x, _ = dense.embed_inputs(params, cfg, dense._as_batch(inputs))
    groups: Dict[str, Dict[str, List[torch.Tensor]]] = {}
    tail: List[Dict] = []
    for where, _, i, kind, bp in _blocks(params, cfg):
        if kind == "m":
            x, state, conv = _mlstm_block(bp, cfg, x, chunk=chunk)
            st = dict(zip(_STATE_NAMES["m"], state), conv=conv)
        else:
            x, state = _slstm_block(bp, cfg, x)
            st = dict(zip(_STATE_NAMES["s"], state))
        if not want_cache:
            continue
        if where == "tail":     # copies: not views into the whole sequence
            tail.append({name: a.clone() for name, a in st.items()})
        else:
            for name, a in st.items():
                groups.setdefault(f"blk{i}", {}).setdefault(name, []).append(a)
    x = cm.apply_norm(x, params["final_norm"], "rmsnorm")
    if not want_cache:
        return dense.logits_of(params, cfg, x), None
    cache = {"groups": {blk: {n: torch.stack(a) for n, a in st.items()}
                        for blk, st in groups.items()},
             "tail": tail,
             "length": torch.tensor(x.shape[1], dtype=torch.int32,
                                    device=x.device)}
    return dense.logits_of(params, cfg, x[:, -1:]), cache


def apply(params: Dict, cfg: ModelConfig, batch: Dict, *,
          chunk: int = 64) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, padded_vocab) at every position
    of ``batch["tokens"]`` (B, S), the mLSTM in chunks of ``chunk``."""
    return _forward(params, cfg, batch, want_cache=False, chunk=chunk)[0]


def prefill(params: Dict, cfg: ModelConfig, tokens, *,
            capacity: Optional[int] = None, chunk: int = 64
            ) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (tokens (B, S), left-padded on the wave path, or a
    batch dict) and return the last position's logits (B, 1,
    padded_vocab) and the decode cache: each block's final state (the
    mLSTM's also its last ``conv_width - 1`` up projections) and "length":
    S.  The state is O(1) in S, so ``capacity`` is not used; the mLSTM
    runs in chunks of ``chunk``."""
    return _forward(params, cfg, tokens, want_cache=True, chunk=chunk)


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One lock-step decode step: token (B, 1), every block's state updated
    in place.  Returns (logits (B, 1, padded_vocab), the cache with length
    + 1)."""
    x = cm.embed_rows(params["embed"], token)
    for where, g, i, kind, bp in _blocks(params, cfg):
        st = (cache["tail"][i] if where == "tail"
              else _index(cache["groups"][f"blk{i}"], g))
        names = _STATE_NAMES[kind]
        state = tuple(st[name] for name in names)
        if kind == "m":
            x, state, conv = _mlstm_block(bp, cfg, x, state=state,
                                          conv_state=st["conv"], decode=True)
            cm.copy_into(st["conv"], conv)
        else:
            x, state = _slstm_block(bp, cfg, x, state=state)
        for name, a in zip(names, state):
            cm.copy_into(st[name], a)
    x = cm.apply_norm(x, params["final_norm"], "rmsnorm")
    return dense.logits_of(params, cfg, x), {**cache,
                                            "length": cache["length"] + 1}
