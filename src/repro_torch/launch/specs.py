"""Abstract stand-ins for every model input: fake tensors, no storage.

Port of ``repro.launch.specs``.  ``input_specs(arch, shape)`` gives what
the dry run and the step builders need for one (arch x input shape): the
train state and a labelled batch, the params and a batch, or the params,
a decode cache and a token.  Every tensor is a fake tensor of the active
``FakeTensorMode`` (or of a new one, ``meshenv.abstract_mode``), the
counterpart of the reference's ``ShapeDtypeStruct``.

``cache_struct`` runs each family's ``prefill`` on abstract inputs, so
every family's cache layout -- KV rings, RG-LRU states, mLSTM matrix
memories, Whisper's cross K/V -- comes out right by construction, as the
reference's ``jax.eval_shape`` of the prefill does.  The prompt is
``_PROMPT`` tokens with the cache's capacity set to the context length:
a cache's shape follows its capacity, not the prompt, and the recurrent
families' loops take a Python step per position.  It runs on fake
tensors, not on plain ``meta`` ones: the MoE dispatch's ``argsort`` and
``searchsorted`` and the index ops of the decode paths have fake
implementations, where meta kernels are missing for some of them, and
the prefill's kernels take their plain versions on fake inputs
(``kernels.ops``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.compat import meshenv
from repro_torch.configs import _INPUT_SHAPES, get_config
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.training.train_step import state_shape
from repro_torch.training.tree import flatten

_TOK = torch.int32
# prompt length of the abstract prefill that lays out a decode cache
_PROMPT = 64


def _empty(shape, dtype, device) -> torch.Tensor:
    with meshenv.abstract_mode():
        return torch.empty(shape, dtype=dtype, device=device)


def batch_struct(cfg: ModelConfig, batch: int, seq: int, with_labels: bool,
                 device: torch.device | str = "cpu") -> Dict:
    """The abstract model-input batch for one (config, B, S)."""
    dt = getattr(torch, cfg.dtype)
    out: Dict = {}
    if cfg.family == "audio":
        # frontend stub: precomputed mel/conv frame embeddings
        out["encoder_embeds"] = _empty((batch, cfg.encoder_seq, cfg.d_model),
                                       dt, device)
        out["tokens"] = _empty((batch, seq), _TOK, device)
    elif cfg.embeds_input:
        # frontend stub: precomputed vision patch embeddings + (t, h, w) ids
        out["embeds"] = _empty((batch, seq, cfg.d_model), dt, device)
        out["positions"] = _empty((batch, seq, 3), _TOK, device)
    else:
        out["tokens"] = _empty((batch, seq), _TOK, device)
    if with_labels:
        out["labels"] = _empty((batch, seq), _TOK, device)
    return out


def params_struct(cfg: ModelConfig, device: torch.device | str = "cpu"):
    """The abstract params: drawn on the CPU, then moved to ``device``."""
    with meshenv.abstract_mode():
        ts, build = flatten(registry.init(cfg, torch.Generator(), "cpu"))
        return build([t.to(device) for t in ts])


def state_struct(cfg: ModelConfig, device: torch.device | str = "cpu"):
    return state_shape(cfg, device)


def cache_struct(cfg: ModelConfig, batch: int, seq: int,
                 device: torch.device | str = "cpu"):
    """The abstract decode cache of a context of length ``seq``: the
    output of the family's ``prefill`` with ``capacity=seq``."""
    fam = registry.get_family(cfg)
    with meshenv.abstract_mode(), torch.no_grad():
        ps = params_struct(cfg, device)
        bs = batch_struct(cfg, batch, min(seq, _PROMPT), with_labels=False,
                          device=device)
        _, cache = fam.prefill(ps, cfg, bs, capacity=seq)
    return cache


def token_struct(batch: int, device: torch.device | str = "cpu"):
    return _empty((batch, 1), _TOK, device)


def reduced_depth(cfg: ModelConfig, k_groups: int) -> ModelConfig:
    """The same config with k pattern-groups of layers (the roofline's
    extrapolation)."""
    if cfg.family == "hybrid":
        pat = len(cfg.block_pattern or ("rec", "rec", "attn"))
        return cfg.replace(n_layers=pat * k_groups + cfg.n_layers % pat)
    if cfg.family == "ssm":
        pat = len(cfg.xlstm_pattern or ("m", "s"))
        return cfg.replace(n_layers=pat * k_groups + cfg.n_layers % pat)
    if cfg.family == "audio":
        return cfg.replace(n_layers=k_groups, n_encoder_layers=k_groups)
    return cfg.replace(n_layers=k_groups)


def n_groups_of(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // len(cfg.block_pattern or ("rec", "rec", "attn"))
    if cfg.family == "ssm":
        return cfg.n_layers // len(cfg.xlstm_pattern or ("m", "s"))
    return cfg.n_layers                     # audio: Le == Ld == n_layers


def input_specs(arch: str, shape_name: str,
                cfg_override: Optional[ModelConfig] = None,
                device: torch.device | str = "cpu") -> Dict:
    """Everything the dry run and the steps need for one (arch x input
    shape), as fake tensors on ``device``."""
    shp = _INPUT_SHAPES[shape_name]
    cfg = cfg_override or get_config(arch, shape_name)
    out = {"cfg": cfg, "shape": shp}
    if shp.kind == "train":
        out["state"] = state_struct(cfg, device)
        out["batch"] = batch_struct(cfg, shp.global_batch, shp.seq_len,
                                    with_labels=True, device=device)
    elif shp.kind == "prefill":
        out["params"] = params_struct(cfg, device)
        out["batch"] = batch_struct(cfg, shp.global_batch, shp.seq_len,
                                    with_labels=False, device=device)
    else:  # decode
        out["params"] = params_struct(cfg, device)
        out["cache"] = cache_struct(cfg, shp.global_batch, shp.seq_len,
                                    device)
        out["token"] = token_struct(shp.global_batch, device)
    return out
