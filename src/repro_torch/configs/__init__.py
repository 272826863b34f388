"""Architecture registry of the port.  Only the dense ``qwen3-8b`` is
ported so far; every other architecture of ``repro.configs`` raises
``KeyError`` naming the ROADMAP item that brings it."""

from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.config import ModelConfig

ARCHS: Dict[str, str] = {"qwen3-8b": "qwen3_8b"}

# architectures of the reference still to port -> the ROADMAP item
_PENDING: Dict[str, str] = {
    "starcoder2-7b": "Queue A item 2 (LayerNorm/GeLU/bias dense variant)",
    "command-r-plus-104b": "Queue A item 2 (parallel-block dense variant)",
    "qwen3-32b": "Queue A item 2 (a second dense config)",
    "qwen2-vl-7b": "Queue A item 7 (vlm, M-RoPE)",
    "granite-moe-1b-a400m": "Queue A item 7 (moe)",
    "dbrx-132b": "Queue A item 7 (moe)",
    "recurrentgemma-9b": "Queue A item 7 (hybrid RG-LRU)",
    "xlstm-1.3b": "Queue A item 7 (ssm, xLSTM)",
    "whisper-base": "Queue A item 7 (audio encoder-decoder)",
}


def get_config(arch: str) -> ModelConfig:
    """The full-size config of ``arch`` (``.smoke()`` for the CPU size)."""
    if arch in _PENDING:
        raise KeyError(f"arch {arch!r} is not ported yet: ROADMAP "
                       f"{_PENDING[arch]}; ported: {sorted(ARCHS)}")
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; ported: {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}").CONFIG
