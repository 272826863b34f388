"""Architecture registry of the port: every architecture of
``repro.configs``, each family ported -- dense (qwen3-8b, qwen3-32b,
starcoder2-7b, command-r-plus-104b), moe (granite-moe-1b-a400m,
dbrx-132b), vlm (qwen2-vl-7b), hybrid (recurrentgemma-9b), ssm
(xlstm-1.3b) and audio (whisper-base)."""

from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, Optional

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, str] = {
    "starcoder2-7b": "starcoder2_7b",
    "qwen3-8b": "qwen3_8b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "dbrx-132b": "dbrx_132b",
    "qwen3-32b": "qwen3_32b",
    "qwen2-vl-7b": "qwen2_vl_7b",
    "xlstm-1.3b": "xlstm_1_3b",
    "command-r-plus-104b": "command_r_plus_104b",
    "whisper-base": "whisper_base",
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
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(ARCHS)}")
    mod = importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")
    cfg: ModelConfig = mod.CONFIG
    if shape == "long_500k" and cfg.family in ("dense", "moe", "vlm",
                                               "audio"):
        window = getattr(mod, "LONG_CONTEXT_WINDOW",
                         _DEFAULT_LONG_CONTEXT_WINDOW)
        cfg = cfg.replace(name=cfg.name + "-window", sliding_window=window)
    return cfg
