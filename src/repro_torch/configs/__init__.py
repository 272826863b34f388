"""Architecture registry of the port.  The dense family (qwen3-8b,
qwen3-32b, starcoder2-7b, command-r-plus-104b), the moe family
(granite-moe-1b-a400m, dbrx-132b), the vlm family (qwen2-vl-7b) and the
hybrid family (recurrentgemma-9b) are ported; the other architectures of
``repro.configs`` raise ``KeyError`` naming the ROADMAP item that brings
them."""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, str] = {
    "starcoder2-7b": "starcoder2_7b",
    "qwen3-8b": "qwen3_8b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "dbrx-132b": "dbrx_132b",
    "qwen3-32b": "qwen3_32b",
    "command-r-plus-104b": "command_r_plus_104b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}

# architectures of the reference still to port -> the ROADMAP item
_PENDING: Dict[str, str] = {
    "xlstm-1.3b": "Queue A item 7 (ssm, xLSTM)",
    "whisper-base": "Queue A item 7 (audio encoder-decoder)",
}


@dataclass(frozen=True)
class _InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # "train" | "prefill" | "decode"


# the port's copy of the reference's input-shape grid
_INPUT_SHAPES: Dict[str, _InputShape] = {
    "train_4k": _InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": _InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": _InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": _InputShape("long_500k", 524288, 1, "decode"),
}

# sliding window applied when long_500k runs on a full-attention arch; a
# per-model config may override it by defining LONG_CONTEXT_WINDOW itself
_DEFAULT_LONG_CONTEXT_WINDOW = 4096


def get_config(arch: str, shape: Optional[str] = None) -> ModelConfig:
    """The full-size config of ``arch`` (``.smoke()`` for the CPU size);
    ``long_500k`` on a full-attention arch returns its sliding-window
    variant, as the reference does."""
    if arch in _PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet: ROADMAP "
                       f"{_PENDING[arch]}; ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg: ModelConfig = mod.CONFIG
    if shape == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                               "audio"):
        window = getattr(mod, "LONG_CONTEXT_WINDOW",
                         _DEFAULT_LONG_CONTEXT_WINDOW)
        cfg = cfg.replace(name=cfg.name + "-window", sliding_window=window)
    return cfg
