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


def params_from_jax(np_tree: Dict, cfg: ModelConfig,
                    device: torch.device | str) -> Dict:
    """The JAX dense param pytree with numpy leaves -> the port's params.

    Leaves: ``embed`` (V, d), ``lm_head`` (d, V), ``final_norm.scale``
    and, stacked on L, ``layers.{ln1,ln2}.scale``, ``wq``/``wk``/``wv``/
    ``wo``, ``q_norm``/``k_norm`` and ``w_gate``/``w_up``/``w_down``.  The
    layouts are the same in both packages, so this is a copy per leaf;
    it checks that no leaf is missing or left over."""
    want = {"embed", "lm_head", "final_norm", "layers"}
    if set(np_tree) != want:
        raise KeyError(f"param tree keys {sorted(np_tree)} != {sorted(want)}")
    lyr = {k: ({kk: _tensor(vv, device) for kk, vv in v.items()}
               if isinstance(v, dict) else _tensor(v, device))
           for k, v in np_tree["layers"].items()}
    expected = {"ln1", "ln2", "wq", "wk", "wv", "wo", "w_gate", "w_up",
                "w_down"} | ({"q_norm", "k_norm"} if cfg.qk_norm else set())
    if set(lyr) != expected:
        raise KeyError(f"layer keys {sorted(lyr)} != {sorted(expected)}")
    if lyr["wq"].shape != (cfg.n_layers, cfg.d_model, cfg.q_dim):
        raise ValueError(f"wq {tuple(lyr['wq'].shape)} does not match "
                         f"{cfg.name}")
    return {"embed": _tensor(np_tree["embed"], device),
            "lm_head": _tensor(np_tree["lm_head"], device),
            "final_norm": {"scale": _tensor(np_tree["final_norm"]["scale"],
                                            device)},
            "layers": lyr}
