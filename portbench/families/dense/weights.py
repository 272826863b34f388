"""Seeded random weights in the port's parameter layout, made by the
benchmark on the device in a few large calls, and handed as the same
tensors to the program and to the reference.

The layout is the dense family's (``models/dense.py``): matrices
``(d_in, d_out)`` stacked on a leading layer axis, norms as ``{"scale",
"bias"}``, tied embeddings without ``lm_head``.  Every leaf is a view of
one buffer filled by one ``normal_`` call; each view is then scaled in
place: projections by ``1 / sqrt(d_in)``, embeddings by 0.02, biases by
0.02, norm scales to ``1 + 0.1 N(0, 1)`` and norm biases by 0.02, so that
no bias or norm is the identity the comparison could not see.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch

from portbench.families.dense.model import ModelDims

Leaf = Tuple[Tuple[str, ...], Tuple[int, ...], str]


def layout(m: ModelDims) -> List[Leaf]:
    """(path, shape, kind) of every leaf; kind is ``proj`` (scaled by
    ``1/sqrt(shape[-2])``), ``embed``, ``bias``, ``norm_scale`` or
    ``norm_bias``."""
    L, d, f, qd, kvd = m.n_layers, m.d_model, m.d_ff, m.q_dim, m.kv_dim
    v = m.padded_vocab
    out: List[Leaf] = [(("embed",), (v, d), "embed")]

    def norm(path: Tuple[str, ...], shape: Tuple[int, ...]) -> None:
        out.append((path + ("scale",), shape, "norm_scale"))
        if m.norm == "layernorm":
            out.append((path + ("bias",), shape, "norm_bias"))

    norm(("final_norm",), (d,))
    ly = ("layers",)
    norm(ly + ("ln1",), (L, d))
    out += [(ly + ("wq",), (L, d, qd), "proj"), (ly + ("wk",), (L, d, kvd),
            "proj"), (ly + ("wv",), (L, d, kvd), "proj"),
            (ly + ("wo",), (L, qd, d), "proj")]
    if not m.parallel_block:
        norm(ly + ("ln2",), (L, d))
    if m.gated_mlp:
        out += [(ly + ("w_gate",), (L, d, f), "proj"),
                (ly + ("w_up",), (L, d, f), "proj"),
                (ly + ("w_down",), (L, f, d), "proj")]
    else:
        out += [(ly + ("w_up",), (L, d, f), "proj"),
                (ly + ("w_down",), (L, f, d), "proj")]
    if m.use_bias:
        if not m.gated_mlp:
            out += [(ly + ("b_up",), (L, f), "bias"),
                    (ly + ("b_down",), (L, d), "bias")]
        out += [(ly + ("bq",), (L, qd), "bias"), (ly + ("bk",), (L, kvd),
                "bias"), (ly + ("bv",), (L, kvd), "bias"),
                (ly + ("bo",), (L, d), "bias")]
    if not m.tie_embeddings:
        out.append((("lm_head",), (d, v), "proj"))
    return out


def n_params(m: ModelDims) -> int:
    return sum(math.prod(shape) for _, shape, _ in layout(m))


def make(m: ModelDims, seed: int, device: torch.device | str,
         dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The weights of one node, from ``seed``, on ``device``."""
    leaves = layout(m)
    total = sum(math.prod(shape) for _, shape, _ in leaves)
    gen = torch.Generator(device).manual_seed(seed)
    flat = torch.empty(total, dtype=dtype, device=device).normal_(
        0.0, 1.0, generator=gen)
    tree: Dict = {}
    at = 0
    for path, shape, kind in leaves:
        n = math.prod(shape)
        t = flat[at:at + n].view(shape)
        at += n
        if kind == "proj":
            t.mul_(1.0 / math.sqrt(shape[-2]))
        elif kind == "norm_scale":
            t.mul_(0.1).add_(1.0)
        else:                          # embed, bias, norm_bias
            t.mul_(0.02)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree
