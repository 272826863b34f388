"""The plain reference: a dense decoder's forward pass in float32 with
plain ``torch`` operations, no kernel, no cache and no batching, written
from the block's published description (pre-norm LayerNorm or RMSNorm,
rotary embeddings on the two halves of each head, grouped-query causal
attention, a SwiGLU or tanh-GeLU MLP, optionally beside the attention as
one parallel block, tied or separate head).  It imports nothing of the
program and reads only the weights the benchmark made.

It runs layer by layer, casting one layer's weights to float32 at a time,
and attention one key/value head at a time, so that it fits beside the
weights on the card.  TF32 is switched off while it runs.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Iterator, Sequence

import torch
import torch.nn.functional as F

from portbench.families.dense.model import ModelDims

Cast = Callable[[torch.Tensor], torch.Tensor]


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.float()


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


@contextlib.contextmanager
def no_tf32() -> Iterator[None]:
    was = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = was


def _norm(x: torch.Tensor, p: Dict, m: ModelDims) -> torch.Tensor:
    scale = p["scale"].float()
    if m.norm == "layernorm":
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + m.norm_eps) * scale \
            + p["bias"].float()
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + m.norm_eps) \
        * scale


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, H, D) at positions 0..S-1; the first and second halves of
    each head are the rotated pairs."""
    s, _, d = x.shape
    freqs = 1.0 / theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., : d // 2], x[..., d // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
               ) -> torch.Tensor:
    """Causal attention. q (S, H, D), k/v (S, Hkv, D) -> (S, H, D)."""
    s, h, d = q.shape
    hkv = k.shape[1]
    rep = h // hkv
    out = torch.empty_like(q)
    mask = torch.ones(s, s, dtype=torch.bool, device=q.device).tril()
    for g in range(hkv):
        qs = q[:, g * rep:(g + 1) * rep].transpose(0, 1)     # (rep, S, D)
        sc = qs @ k[:, g].T / math.sqrt(d)                   # (rep, S, S)
        sc = sc.masked_fill(~mask, float("-inf"))
        out[:, g * rep:(g + 1) * rep] = (torch.softmax(sc, -1)
                                         @ v[:, g]).transpose(0, 1)
        del sc
    return out


def _mlp(h: torch.Tensor, lp: Dict, m: ModelDims, cast: Cast, act: Cast
         ) -> torch.Tensor:
    h = act(h)
    if m.gated_mlp:
        return act(F.silu(h @ cast(lp["w_gate"])) * (h @ cast(lp["w_up"]))) \
            @ cast(lp["w_down"])
    u = h @ cast(lp["w_up"])
    if m.use_bias:
        u = u + lp["b_up"].float()
    out = act(F.gelu(u, approximate="tanh")) @ cast(lp["w_down"])
    return out + lp["b_down"].float() if m.use_bias else out


def hidden(params: Dict, m: ModelDims, tokens: torch.Tensor,
           cast: Cast = _f32, act: Cast = _same) -> torch.Tensor:
    """Final-normed hidden states (S, d) of one sequence ``tokens`` (S,).
    ``cast`` turns each weight matrix into the float32 one the products
    use, and ``act`` each product's other operand: the weight as it is
    and the activation as it is for the reference."""
    x = params["embed"][tokens].float()
    lay = params["layers"]
    s = x.shape[0]
    for l in range(m.n_layers):
        lp = {k: ({kk: vv[l] for kk, vv in v.items()} if isinstance(v, dict)
                  else v[l]) for k, v in lay.items()}
        h = _norm(x, lp["ln1"], m)
        ha = act(h)
        q, k, v = ha @ cast(lp["wq"]), ha @ cast(lp["wk"]), ha @ cast(lp["wv"])
        if m.use_bias:
            q, k, v = (q + lp["bq"].float(), k + lp["bk"].float(),
                       v + lp["bv"].float())
        q = _rope(q.view(s, m.n_heads, m.head_dim), m.rope_theta)
        k = _rope(k.view(s, m.n_kv_heads, m.head_dim), m.rope_theta)
        a = _attention(q, k, v.view(s, m.n_kv_heads, m.head_dim))
        a = act(a.reshape(s, m.q_dim)) @ cast(lp["wo"])
        if m.use_bias:
            a = a + lp["bo"].float()
        if m.parallel_block:
            x = x + a + _mlp(h, lp, m, cast, act)
        else:
            x = x + a
            x = x + _mlp(_norm(x, lp["ln2"], m), lp, m, cast, act)
        del q, k, v, a, h, ha
    return _norm(x, params["final_norm"], m)


def logits(params: Dict, m: ModelDims, x: torch.Tensor, cast: Cast = _f32,
           act: Cast = _same, block: int = 32768) -> torch.Tensor:
    """Float32 logits (n, vocab_size) of hidden states ``x`` (n, d), the
    head taken ``block`` vocabulary rows at a time, times the logit
    scale."""
    head = params["embed"] if m.tie_embeddings else params["lm_head"].T
    x = act(x)
    parts = [x @ cast(head[i:i + block]).T
             for i in range(0, m.vocab_size, block)]
    out = torch.cat(parts, dim=-1)[:, : m.vocab_size]
    return out * m.logit_scale if m.logit_scale != 1.0 else out


def served_logits(params: Dict, m: ModelDims, prompt: Sequence[int],
                  served: Sequence[int], device: torch.device | str,
                  cast: Cast = _f32, act: Cast = _same) -> torch.Tensor:
    """The reference's logits at every position that chose a served
    token: (len(served), vocab_size), row i predicting ``served[i]``."""
    toks = torch.as_tensor(list(prompt) + list(served)[:-1],
                           dtype=torch.long, device=device)
    with no_tf32(), torch.no_grad():
        x = hidden(params, m, toks, cast, act)
        return logits(params, m, x[len(prompt) - 1:], cast, act)
