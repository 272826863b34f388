"""Weights from the JAX package into the port, through numpy.

The parity tests initialise a model with ``repro.models.registry.init``
(``jax.random``), turn the param pytree into numpy arrays and hand it
here, so both frameworks run on bit-identical weights.  This module itself
imports no JAX: it only walks nested dicts of numpy arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from repro_torch.models import rglru
from repro_torch.models.config import ModelConfig


def _tensor(a: np.ndarray, device: torch.device | str) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":          # ml_dtypes: no torch counterpart
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)   # a writable copy


def _expected_layer_keys(cfg: ModelConfig) -> set:
    """The layer leaves the reference's ``init`` makes for ``cfg``."""
    keys = {"ln1", "wq", "wk", "wv", "wo"}
    if not cfg.parallel_block:
        keys.add("ln2")
    if cfg.qk_norm:
        keys |= {"q_norm", "k_norm"}
    if cfg.use_bias:
        keys |= {"bq", "bk", "bv", "bo"}
    if cfg.is_moe:
        return keys | {"router", "we_gate", "we_up", "we_down"}
    if cfg.act == "swiglu":
        return keys | {"w_gate", "w_up", "w_down"}
    return keys | {"w_up", "w_down"} | ({"b_up", "b_down"} if cfg.use_bias
                                        else set())


_REC_KEYS = {"ln", "w_y", "w_x", "conv_w", "conv_b", "w_a", "w_i", "lam",
             "w_o"}
_ATTN_KEYS = {"ln", "wq", "wk", "wv", "wo"}
_MLP_KEYS = {"ln", "w_gate", "w_up", "w_down"}


def _norm_keys(cfg: ModelConfig) -> set:
    return {"scale", "bias"} if cfg.norm_type == "layernorm" else {"scale"}


def _copy(tree: Dict, want: set, where: str, cfg: ModelConfig,
          device: torch.device | str) -> Dict:
    """A dict of leaves (norms ``ln``/``ln1``/``ln2``/``final_norm``
    one level down) copied to tensors, after checking that its keys are
    ``want``."""
    if set(tree) != want:
        raise KeyError(f"{where} keys {sorted(tree)} != {sorted(want)}")
    out = {}
    for k, v in tree.items():
        if k in ("ln", "ln1", "ln2", "final_norm"):
            out[k] = _copy(v, _norm_keys(cfg), f"{where}.{k}", cfg, device)
        else:
            out[k] = _tensor(v, device)
    return out


def _rglru_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device: torch.device | str) -> Dict:
    """The hybrid family's tree: ``embed``, ``final_norm``, ``lm_head``
    unless tied, ``groups.blk{i}``/``mlp{i}`` stacked on the groups and
    ``tail.blk{i}``/``mlp{i}``, each block's leaves the recurrent block's
    (``lam`` float32) or the attention block's."""
    n_groups, tail = rglru.group_structure(cfg)
    pat = rglru.block_pattern(cfg)
    keys = {"rec": _REC_KEYS, "attn": _ATTN_KEYS}
    top = {"embed", "final_norm", "groups", "tail"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(np_tree) != top:
        raise KeyError(f"param tree keys {sorted(np_tree)} != {sorted(top)}")
    out = _copy({k: v for k, v in np_tree.items()
                 if k not in ("groups", "tail")},
                top - {"groups", "tail"}, "params", cfg, device)
    for name, kinds in (("groups", pat), ("tail", tail)):
        tree = np_tree[name]
        want = {f"{p}{i}" for i in range(len(kinds)) for p in ("blk", "mlp")}
        if set(tree) != want:
            raise KeyError(f"{name} keys {sorted(tree)} != {sorted(want)}")
        out[name] = {}
        for i, kind in enumerate(kinds):
            out[name][f"blk{i}"] = _copy(tree[f"blk{i}"], keys[kind],
                                         f"{name}.blk{i}", cfg, device)
            out[name][f"mlp{i}"] = _copy(tree[f"mlp{i}"], _MLP_KEYS,
                                         f"{name}.mlp{i}", cfg, device)
    w_x = out["groups"]["blk0"]["w_x" if pat[0] == "rec" else "wq"]
    if w_x.shape[:2] != (n_groups, cfg.d_model):
        raise ValueError(f"groups.blk0 {tuple(w_x.shape)} does not match "
                         f"{cfg.name}")
    return out


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device: torch.device | str) -> Dict:
    """The JAX dense, vlm, moe or hybrid param pytree with numpy leaves ->
    the port's params.  The hybrid family's tree is ``_rglru_from_jax``'s;
    the others' are below.

    Leaves: ``embed`` (V, d), ``lm_head`` (d, V) unless the embeddings are
    tied, ``final_norm`` and, stacked on L, ``layers.ln1`` / ``ln2`` (not
    in a parallel block), each norm ``{scale}`` or, for LayerNorm,
    ``{scale, bias}``; ``wq``/``wk``/``wv``/``wo``, ``q_norm``/``k_norm``,
    the biases ``bq``/``bk``/``bv``/``bo``; the MLP's ``w_gate``/``w_up``/
    ``w_down`` (SwiGLU), ``w_up``/``w_down`` and ``b_up``/``b_down`` (GeLU
    with biases), or the moe layer's ``router`` (L, d, E), float32 whatever
    ``cfg.dtype`` is, and ``we_gate``/``we_up`` (L, E, d, f) and
    ``we_down`` (L, E, f, d).  The layouts are the same in both packages,
    so this is a copy per leaf, each keeping its dtype; it checks that no
    leaf is missing or left over."""
    if cfg.family == "hybrid":
        return _rglru_from_jax(np_tree, cfg, device)
    want = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(np_tree) != want:
        raise KeyError(f"param tree keys {sorted(np_tree)} != {sorted(want)}")
    out = _copy({k: v for k, v in np_tree.items() if k != "layers"},
                want - {"layers"}, "params", cfg, device)
    out["layers"] = lyr = _copy(np_tree["layers"], _expected_layer_keys(cfg),
                                "layers", cfg, device)
    if lyr["wq"].shape != (cfg.n_layers, cfg.d_model, cfg.q_dim):
        raise ValueError(f"wq {tuple(lyr['wq'].shape)} does not match "
                         f"{cfg.name}")
    return out
