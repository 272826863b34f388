"""Prefill attention on the card: the wrapper of ``csrc/flash_attention.cu``.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/flash_attention.py`` · ``flash_attention_tpu``: causal,
sliding-window or bidirectional attention with native GQA and an online
softmax in float32.  Its plain version is ``kernels.ref.flash_ref``;
``kernels.ops.attention`` picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# the widths it is built for: the draft's, qwen3-8b's, recurrentgemma-9b's
_HEAD_DIMS = (64, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def check_head_dim(d: int, built) -> None:
    """Raise unless ``d`` is one of the head widths ``built``."""
    if d not in built:
        raise ValueError(f"head_dim {d}: the kernel is built for {built}")


def check_cuda_inputs(tensors, dtype: torch.dtype) -> None:
    """Shared wrapper checks: every tensor on one CUDA device, contiguous,
    16-byte aligned (the kernels load 16 bytes at a time), and ``dtype``
    one the kernels are built for."""
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"kernel inputs must be CUDA tensors, got {dev}")
    if dtype not in DTYPES:
        raise TypeError(f"kernel takes {list(DTYPES)}, got {dtype}")
    for t in tensors:
        if t.device != dev or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(
                f"kernel inputs must be contiguous, 16-byte aligned and on "
                f"one device: got {t.device} (inputs on {dev}), contiguous "
                f"{t.is_contiguous()}, address {t.data_ptr():#x}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         causal: bool = True,
                         window: Optional[int] = None) -> torch.Tensor:
    """Launch the prefill kernel.  q: (B, Sq, H, D), k/v: (B, Skv, Hkv, D),
    all float32 or all bfloat16 -> (B, Sq, H, D) of q's dtype."""
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)} "
                         f"v{tuple(v.shape)}")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or h % hkv or sq < 1 or skv < 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)} k{tuple(k.shape)}")
    check_head_dim(d, _HEAD_DIMS)
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k, v must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_cuda_inputs((q, k, v), q.dtype)
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], b, sq, skv, h, hkv, d, int(causal),
             -1 if window is None else int(window), d ** -0.5,
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
