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


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device: torch.device | str) -> Dict:
    """The JAX dense or moe param pytree with numpy leaves -> the port's
    params.

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
    want = {"embed", "final_norm", "layers"} | (
        set() if cfg.tie_embeddings else {"lm_head"})
    if set(np_tree) != want:
        raise KeyError(f"param tree keys {sorted(np_tree)} != {sorted(want)}")
    norm_keys = {"scale", "bias"} if cfg.norm_type == "layernorm" \
        else {"scale"}

    def norm(tree: Dict, where: str) -> Dict:
        if set(tree) != norm_keys:
            raise KeyError(f"{where} keys {sorted(tree)} != "
                           f"{sorted(norm_keys)}")
        return {k: _tensor(v, device) for k, v in tree.items()}

    expected = _expected_layer_keys(cfg)
    if set(np_tree["layers"]) != expected:
        raise KeyError(f"layer keys {sorted(np_tree['layers'])} != "
                       f"{sorted(expected)}")
    lyr = {k: (norm(v, k) if k in ("ln1", "ln2") else _tensor(v, device))
           for k, v in np_tree["layers"].items()}
    if lyr["wq"].shape != (cfg.n_layers, cfg.d_model, cfg.q_dim):
        raise ValueError(f"wq {tuple(lyr['wq'].shape)} does not match "
                         f"{cfg.name}")
    out = {"embed": _tensor(np_tree["embed"], device),
           "final_norm": norm(np_tree["final_norm"], "final_norm"),
           "layers": lyr}
    if not cfg.tie_embeddings:
        out["lm_head"] = _tensor(np_tree["lm_head"], device)
    return out
