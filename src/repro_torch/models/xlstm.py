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
conv applies the kernel reversed over its history window.  The reference's
roofline surrogate of the sLSTM (taken only under its dry-run's roofline
mode) has no counterpart here.

Layouts are the reference's: weights ``(d_in, d_out)``; the groups' params
stacked on a leading ``n_groups`` axis under ``groups.blk{i}``, the tail's
unstacked under ``tail.blk{i}``; the decode cache ``{"groups": {blk{i}:
{"C", "n", "m", "conv"} or {"c", "n", "m", "h"}} stacked on groups,
"tail": [per tail block], "length": ()}``.  Unlike the reference,
``decode_step`` updates the cache's tensors in place.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm
from repro_torch.models import dense
from repro_torch.models.config import ModelConfig
from repro_torch.models.rglru import _causal_conv, _index

_NEG = -1e30          # "minus infinity" of the stabilizer and of pad gates


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
    b, t, ud = u.shape
    h = cfg.n_heads
    dh = ud // h
    ch = conv.reshape(b, t, h, dh).float()
    uh = u.reshape(b, t, h, dh).float()
    q = torch.einsum("bthd,hde->bthe", ch, mp["wq"].float())
    k = torch.einsum("bthd,hde->bthe", ch, mp["wk"].float()) / dh ** 0.5
    v = torch.einsum("bthd,hde->bthe", uh, mp["wv"].float())
    cf = conv.float()
    return q, k, v, cf @ mp["w_i"], cf @ mp["w_f"] + mp["b_f"]


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
                 decode: bool = False
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...],
                            torch.Tensor]:
    """The mLSTM block over x (B, T, d), or one decode token (T = 1) from
    ``state`` and ``conv_state`` (the last ``conv_width - 1`` up
    projections).  Returns (x + out, the cell state, the conv state)."""
    b, t, _ = x.shape
    if decode:
        h_in = cm.apply_norm(x, mp["ln"], "rmsnorm")
        u = h_in @ mp["w_up"]
        g = h_in @ mp["w_gate"]
        # hist[:, -1] is u_t and out_t = sum_j w[j] u_{t-j}: the kernel
        # applies reversed over the history window
        hist = torch.cat([conv_state, u], dim=1)                 # (B, cw, ud)
        conv = F.silu((hist * mp["conv_w"].flip(0)).sum(dim=1, keepdim=True)
                      + mp["conv_b"])
        hseq, new_state = mlstm_recurrent_step(*_qkvif(mp, cfg, conv, u),
                                               state)
        new_conv = hist[:, 1:]
    else:
        q, k, v, it, ft, g, u = _mlstm_qkvif(mp, cfg, x)
        hseq, new_state = mlstm_chunkwise(q, k, v, it, ft, state)
        new_conv = u[:, -(cfg.conv_width - 1):]
    hflat = hseq.reshape(b, t, _ud(cfg)).to(x.dtype)
    return x + (hflat * F.silu(g)) @ mp["w_down"], new_state, new_conv


# -------------------------------------------------------------- sLSTM cell
def _slstm_block(sp: Dict, cfg: ModelConfig, x: torch.Tensor,
                 state: Optional[Tuple[torch.Tensor, ...]] = None
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """The sLSTM block, a sequential loop over time.  x: (B, T, d);
    ``state`` (c, n, m, h), each (B, d) float32, or None for zeros with
    ``m = -1e30``.  Returns (x + the gated FFN of h, the final state)."""
    b, t, d = x.shape
    nh = cfg.n_heads
    dh = d // nh
    xin = cm.apply_norm(x, sp["ln"], "rmsnorm").float()
    # the input's share of the four gates at every step, (T, 4, B, d)
    pre = torch.stack([xin @ sp["w_z"].float(), xin @ sp["w_i"].float(),
                       xin @ sp["w_f"].float() + sp["b_f"],
                       xin @ sp["w_o"].float()]).permute(2, 0, 1, 3)
    if state is None:
        zeros = xin.new_zeros((b, d))
        state = (zeros, zeros, xin.new_full((b, d), _NEG), zeros)
    c, n, m, h = state
    # the recurrent matrices of z, i, f, o, each (H, dh, dh) block-diagonal
    r = torch.stack([sp[f"r_{g}"].float() for g in ("z", "i", "f", "o")])
    hs = []
    for s in range(t):
        rec = torch.einsum("bhd,ghde->gbhe", h.reshape(b, nh, dh),
                           r).reshape(4, b, d)
        gz, gi, gf, go = pre[s] + rec
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
    hseq = torch.stack(hs, dim=1).to(x.dtype)                    # (B, T, d)
    ff = ((cm.gelu(hseq @ sp["w_up1"]) * (hseq @ sp["w_up2"]))
          @ sp["w_down"])
    return x + ff, (c, n, m, h)


# ----------------------------------------------------------------- forward
def _blocks(params: Dict, cfg: ModelConfig):
    """Every block in order: (where, group index or None, i, kind, block
    params)."""
    n_groups, tail = group_structure(cfg)
    for g in range(n_groups):
        gp = _index(params["groups"], g)
        for i, kind in enumerate(block_pattern(cfg)):
            yield "groups", g, i, kind, gp[f"blk{i}"]
    for i, kind in enumerate(tail):
        yield "tail", None, i, kind, params["tail"][f"blk{i}"]


_STATE_NAMES = {"m": ("C", "n", "m"), "s": ("c", "n", "m", "h")}


def _forward(params: Dict, cfg: ModelConfig, inputs,
             want_cache: bool) -> Tuple[torch.Tensor, Optional[Dict]]:
    x, _ = dense.embed_inputs(params, cfg, dense._as_batch(inputs))
    groups: Dict[str, Dict[str, List[torch.Tensor]]] = {}
    tail: List[Dict] = []
    for where, _, i, kind, bp in _blocks(params, cfg):
        if kind == "m":
            x, state, conv = _mlstm_block(bp, cfg, x)
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


def apply(params: Dict, cfg: ModelConfig, batch: Dict) -> torch.Tensor:
    """Full-sequence forward: logits (B, S, padded_vocab) at every position
    of ``batch["tokens"]`` (B, S), the mLSTM in chunks of 64."""
    return _forward(params, cfg, batch, want_cache=False)[0]


def prefill(params: Dict, cfg: ModelConfig, tokens, *,
            capacity: Optional[int] = None) -> Tuple[torch.Tensor, Dict]:
    """Run the prompt (tokens (B, S), left-padded on the wave path, or a
    batch dict) and return the last position's logits (B, 1,
    padded_vocab) and the decode cache: each block's final state (the
    mLSTM's also its last ``conv_width - 1`` up projections) and "length":
    S.  The state is O(1) in S, so ``capacity`` is not used."""
    return _forward(params, cfg, tokens, want_cache=True)


def decode_step(params: Dict, cfg: ModelConfig, cache: Dict,
                token: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
    """One lock-step decode step: token (B, 1), every block's state updated
    in place.  Returns (logits (B, 1, padded_vocab), the cache with length
    + 1)."""
    x = params["embed"][token]
    for where, g, i, kind, bp in _blocks(params, cfg):
        st = (cache["tail"][i] if where == "tail"
              else _index(cache["groups"][f"blk{i}"], g))
        names = _STATE_NAMES[kind]
        state = tuple(st[name] for name in names)
        if kind == "m":
            x, state, conv = _mlstm_block(bp, cfg, x, state=state,
                                          conv_state=st["conv"], decode=True)
            st["conv"].copy_(conv)
        else:
            x, state = _slstm_block(bp, cfg, x, state=state)
        for name, a in zip(names, state):
            st[name].copy_(a)
    x = cm.apply_norm(x, params["final_norm"], "rmsnorm")
    return dense.logits_of(params, cfg, x), {**cache,
                                            "length": cache["length"] + 1}
