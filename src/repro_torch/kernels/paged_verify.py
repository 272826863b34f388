"""Paged multi-token verify attention on the card: the wrapper of
``csrc/paged_verify.cu``.

The CUDA kernel replaces the TPU kernel ``src/repro/kernels/spec_verify.py``
· ``flash_paged_verify_tpu`` (fp pools): K query tokens per row over a KV
page pool reached through a block table, their KV already written at
positions ``lengths[b] .. lengths[b]+K-1``, query j attending positions
``<= lengths[b] + j``.  Its plain version is ``kernels.ref.paged_verify_ref``;
``kernels.ops.paged_verify`` picks between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, check_cuda_inputs,
                                                 check_head_dim)

_MAX_ROWS = 64          # K * H / Hkv per block (kMaxRows in the source)
_HEAD_DIMS = (128,)     # the widths it is built for (qwen3-8b's)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_verify_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged verify kernel.  q: (B, K, H, D); pools
    (P, page, Hkv, D) of q's dtype; block_tables: (B, maxp) int32;
    lengths: (B,) int32, each >= 0, the valid tokens before the K new ones
    -> (B, K, H, D).  Table entries must lie in [0, P): the kernel traps on
    any other entry it reads."""
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    b, kq, h, d = q.shape
    n_pages, page, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != d or kq < 1 or h % hkv \
            or kq * (h // hkv) > _MAX_ROWS:
        raise ValueError(f"bad heads or tokens: q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)} (K * H / Hkv must be "
                         f"<= {_MAX_ROWS})")
    check_head_dim(d, _HEAD_DIMS)
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or block_tables.shape[1] < 1 or tuple(lengths.shape) != (b,):
        raise ValueError(f"bad tables{tuple(block_tables.shape)} / "
                         f"lengths{tuple(lengths.shape)} for batch {b}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    check_cuda_inputs((q, k_pool, v_pool, block_tables, lengths), q.dtype)
    out = torch.empty_like(q)
    fn = _build.function("paged_verify", "paged_verify_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], b, kq, h, hkv, d, page, block_tables.shape[1],
             n_pages, d ** -0.5, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_verify launch failed: CUDA error {err}")
    paged_verify_cuda.launches += 1
    return out


paged_verify_cuda.launches = 0
