"""Contiguous decode attention on the card: the wrapper of
``csrc/flash_decode.cu``.

The CUDA kernel replaces the TPU kernel ``src/repro/kernels/flash_decode.py``
· ``flash_decode_tpu``: one query token per row over a contiguous cache,
positions ``max(0, len - window) <= k < len`` valid.  It takes (B,)
lengths, where the TPU kernel takes one scalar for the batch, because the
slot engine decodes every row at its own depth.  Its plain version is
``kernels.ref.decode_ref``; ``kernels.ops.decode`` picks between the two by
the tensors' device.  With q in bfloat16 the kernel runs the tensor-core
body and cuts each row's cache across ``decode_split.decode_splits`` blocks
when the batch is too small to fill the card.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_split import (decode_splits, split_span,
                                              target_blocks)
from repro_torch.kernels.flash_attention import (DTYPES, check_cuda_inputs,
                                                 check_head_dim)

_MAX_REP = 16           # query heads per kv head (kMaxRep in the source)
# the widths it is built for: the draft's, qwen3-8b's, recurrentgemma-9b's
_HEAD_DIMS = (64, 128, 256)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def flash_decode_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor, *,
                      window: Optional[int] = None) -> torch.Tensor:
    """Launch the decode kernel.  q: (B, 1, H, D); caches (B, S, Hkv, D) of
    q's dtype; lengths: (B,) int32 -> (B, 1, H, D)."""
    if q.ndim != 4 or q.shape[1] != 1 or k_cache.ndim != 4 \
            or v_cache.shape != k_cache.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)}")
    b, _, h, d = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    if k_cache.shape[0] != b or k_cache.shape[3] != d or h % hkv \
            or h // hkv > _MAX_REP or s < 1:
        raise ValueError(f"bad heads: q{tuple(q.shape)} "
                         f"cache{tuple(k_cache.shape)}")
    check_head_dim(d, _HEAD_DIMS)
    if tuple(lengths.shape) != (b,) or lengths.dtype != torch.int32:
        raise ValueError(f"lengths must be ({b},) int32, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError("q and the caches must share one dtype")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    check_cuda_inputs((q, k_cache, v_cache, lengths), q.dtype)
    splits = (decode_splits(b, hkv, s, target_blocks(d))
              if q.dtype == torch.bfloat16 else 1)
    out = torch.empty_like(q)
    work = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    fn = _build.function("flash_decode", "flash_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(),
             None if work is None else work.data_ptr(), DTYPES[q.dtype], b, s,
             h, hkv, d, -1 if window is None else int(window), splits,
             split_span(s, splits), d ** -0.5, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_decode launch failed: CUDA error {err}")
    flash_decode_cuda.launches += 1
    flash_decode_cuda.last_splits = splits
    flash_decode_cuda.merge_launches += splits > 1
    return out


flash_decode_cuda.launches = 0
flash_decode_cuda.last_splits = 0   # the splits of the last launch
flash_decode_cuda.merge_launches = 0   # launches that also merged splits
