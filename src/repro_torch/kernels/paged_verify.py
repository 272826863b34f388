"""Paged multi-token verify attention on the card: the wrappers of
``csrc/paged_verify.cu``.

The CUDA kernel replaces the TPU kernel ``src/repro/kernels/spec_verify.py``
· ``flash_paged_verify_tpu`` in both its forms: K query tokens per row over
a KV page pool reached through a block table, their KV already written at
positions ``lengths[b] .. lengths[b]+K-1``, query j attending positions
``<= lengths[b] + j``.  Any K: the kernel tiles the K * H / Hkv query rows
of a kv head, 32 at a time on the tensor cores for q in bfloat16 and 64 at
a time on the CUDA cores for q in float32.  ``paged_verify_cuda`` takes
pools of q's dtype; ``paged_verify_int8_cuda`` int8 pools with bf16 scale pools.  Their
plain versions are ``kernels.ref.paged_verify_ref`` and
``paged_verify_quant_ref``; ``kernels.ops.paged_verify`` and
``paged_verify_quant`` pick between kernel and plain version by the
tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import DTYPES, check_cuda_inputs
from repro_torch.kernels.paged_decode import (check_int8_pools,
                                              check_paged_inputs)

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_INT8_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_verify_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged verify kernel.  q: (B, K, H, D); pools
    (P, page, Hkv, D) of q's dtype; block_tables: (B, maxp) int32;
    lengths: (B,) int32, each >= 0, the valid tokens before the K new ones
    -> (B, K, H, D).  Table entries must lie in [0, P): the kernel traps on
    any other entry it reads."""
    n_pages, page, hkv = check_paged_inputs(q, k_pool, v_pool, block_tables,
                                            lengths, None)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    check_cuda_inputs((q, k_pool, v_pool, block_tables, lengths), q.dtype)
    b, kq, h, d = q.shape
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


def paged_verify_int8_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Launch the int8 paged verify kernel.  q: (B, K, H, D) fp32 or bf16;
    pools (P, page, Hkv, D) int8; scale pools (P, page, Hkv, 1) bf16;
    tables and lengths as in ``paged_verify_cuda`` -> (B, K, H, D) of q's
    dtype."""
    n_pages, page, hkv = check_paged_inputs(q, k_pool, v_pool, block_tables,
                                            lengths, None)
    check_int8_pools(q, k_pool, v_pool, k_scale, v_scale)
    check_cuda_inputs((q, k_pool, v_pool, block_tables, lengths), q.dtype)
    b, kq, h, d = q.shape
    out = torch.empty_like(q)
    fn = _build.function("paged_verify", "paged_verify_int8_fwd",
                         _INT8_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], b, kq, h, hkv, d, page, block_tables.shape[1],
             n_pages, d ** -0.5, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_verify_int8 launch failed: CUDA error "
                           f"{err}")
    paged_verify_int8_cuda.launches += 1
    return out


paged_verify_int8_cuda.launches = 0
