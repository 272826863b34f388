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

from repro_torch.models import rglru, xlstm
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
_MLSTM_KEYS = {"ln", "w_up", "w_gate", "conv_w", "conv_b", "wq", "wk", "wv",
               "w_i", "w_f", "b_f", "w_down"}
_SLSTM_KEYS = {"ln", "w_z", "r_z", "w_i", "r_i", "w_f", "r_f", "w_o", "r_o",
               "b_f", "w_up1", "w_up2", "w_down"}
# each grouped block kind's leaves, and the leaf of shape (d_model, ...)
# the groups' stacking is checked on
_BLOCK_KEYS = {"rec": (_REC_KEYS, "w_x"), "attn": (_ATTN_KEYS, "wq"),
               "m": (_MLSTM_KEYS, "w_up"), "s": (_SLSTM_KEYS, "w_z")}
_WATTN_KEYS = {"ln", "wq", "bq", "wk", "wv", "bv", "wo", "bo"}
_WMLP_KEYS = {"ln", "w_up", "b_up", "w_down", "b_down"}


def _norm_keys(cfg: ModelConfig) -> set:
    return {"scale", "bias"} if cfg.norm_type == "layernorm" else {"scale"}


def _copy(tree: Dict, want: set, where: str, cfg: ModelConfig,
          device: torch.device | str) -> Dict:
    """A dict of leaves (norms ``ln``/``ln1``/``ln2``/``final_norm``/
    ``enc_norm``/``dec_norm`` one level down) copied to tensors, after
    checking that its keys are ``want``."""
    if set(tree) != want:
        raise KeyError(f"{where} keys {sorted(tree)} != {sorted(want)}")
    out = {}
    for k, v in tree.items():
        if k in ("ln", "ln1", "ln2", "final_norm", "enc_norm", "dec_norm"):
            out[k] = _copy(v, _norm_keys(cfg), f"{where}.{k}", cfg, device)
        else:
            out[k] = _tensor(v, device)
    return out


def _grouped_from_jax(np_tree: Dict, cfg: ModelConfig,
                      device: torch.device | str, family,
                      with_mlp: bool) -> Dict:
    """The hybrid or ssm family's tree (``family``: the model module,
    ``rglru`` or ``xlstm``, whose ``block_pattern`` and
    ``group_structure`` lay it out): ``embed``, ``final_norm``,
    ``lm_head`` unless tied, ``groups.blk{i}`` (and ``mlp{i}`` for the
    hybrid family) stacked on the groups and ``tail.blk{i}``(/``mlp{i}``),
    each block's leaves those of its kind (``_BLOCK_KEYS``), float32
    leaves kept float32."""
    pat = family.block_pattern(cfg)
    n_groups, tail = family.group_structure(cfg)
    top = {"embed", "final_norm", "groups", "tail"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(np_tree) != top:
        raise KeyError(f"param tree keys {sorted(np_tree)} != {sorted(top)}")
    out = _copy({k: v for k, v in np_tree.items()
                 if k not in ("groups", "tail")},
                top - {"groups", "tail"}, "params", cfg, device)
    prefixes = ("blk", "mlp") if with_mlp else ("blk",)
    for name, kinds in (("groups", pat), ("tail", tail)):
        tree = np_tree[name]
        want = {f"{p}{i}" for i in range(len(kinds)) for p in prefixes}
        if set(tree) != want:
            raise KeyError(f"{name} keys {sorted(tree)} != {sorted(want)}")
        out[name] = {}
        for i, kind in enumerate(kinds):
            out[name][f"blk{i}"] = _copy(tree[f"blk{i}"],
                                         _BLOCK_KEYS[kind][0],
                                         f"{name}.blk{i}", cfg, device)
            if with_mlp:
                out[name][f"mlp{i}"] = _copy(tree[f"mlp{i}"], _MLP_KEYS,
                                             f"{name}.mlp{i}", cfg, device)
    probe = out["groups"]["blk0"][_BLOCK_KEYS[pat[0]][1]]
    if probe.shape[:2] != (n_groups, cfg.d_model):
        raise ValueError(f"groups.blk0 {tuple(probe.shape)} does not match "
                         f"{cfg.name}")
    return out


def _whisper_from_jax(np_tree: Dict, cfg: ModelConfig,
                      device: torch.device | str) -> Dict:
    """The audio family's tree: ``enc_pos``, ``dec_pos``, the tied
    ``embed``, ``enc_norm``, ``dec_norm``, and stacked on layers
    ``enc_attn``, ``dec_self``, ``dec_cross`` (``_WATTN_KEYS``: no ``bk``)
    and ``enc_mlp``, ``dec_mlp`` (``_WMLP_KEYS``)."""
    blocks = {"enc_attn": _WATTN_KEYS, "dec_self": _WATTN_KEYS,
              "dec_cross": _WATTN_KEYS, "enc_mlp": _WMLP_KEYS,
              "dec_mlp": _WMLP_KEYS}
    leaves = {"enc_pos", "dec_pos", "embed", "enc_norm", "dec_norm"}
    if set(np_tree) != leaves | set(blocks):
        raise KeyError(f"param tree keys {sorted(np_tree)} != "
                       f"{sorted(leaves | set(blocks))}")
    out = _copy({k: np_tree[k] for k in leaves}, leaves, "params", cfg,
                device)
    for name, keys in blocks.items():
        out[name] = _copy(np_tree[name], keys, name, cfg, device)
    for name, n in (("enc_attn", cfg.n_encoder_layers),
                    ("dec_self", cfg.n_layers)):
        if out[name]["wq"].shape != (n, cfg.d_model, cfg.q_dim):
            raise ValueError(f"{name}.wq {tuple(out[name]['wq'].shape)} "
                             f"does not match {cfg.name}")
    return out


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device: torch.device | str) -> Dict:
    """The JAX param pytree of any family, with numpy leaves -> the port's
    params.  The hybrid and ssm families' trees are ``_grouped_from_jax``'s,
    the audio family's ``_whisper_from_jax``'s; the others' are below.

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
        return _grouped_from_jax(np_tree, cfg, device, rglru, True)
    if cfg.family == "ssm":
        return _grouped_from_jax(np_tree, cfg, device, xlstm, False)
    if cfg.family == "audio":
        return _whisper_from_jax(np_tree, cfg, device)
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
