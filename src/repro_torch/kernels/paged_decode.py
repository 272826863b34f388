"""Paged decode attention on the card: the wrapper of
``csrc/paged_decode.cu``.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/paged_decode.py`` · ``flash_paged_decode_tpu`` (fp
pools): one query token per row over a KV page pool reached through a
block table, positions below ``lengths[b]`` valid.  Its plain version is
``kernels.ref.paged_decode_ref``; ``kernels.ops.paged_decode`` picks
between the two by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import (DTYPES, HEAD_DIM,
                                                 check_cuda_inputs)

MAX_REP = 16            # query heads per kv head (kMaxRep in the source)
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 8
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def paged_decode_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                      v_pool: torch.Tensor, block_tables: torch.Tensor,
                      lengths: torch.Tensor) -> torch.Tensor:
    """Launch the paged decode kernel.  q: (B, 1, H, D); pools
    (P, page, Hkv, D) of q's dtype; block_tables: (B, maxp) int32;
    lengths: (B,) int32 -> (B, 1, H, D).

    Table entries must lie in [0, P): JAX clamps an out-of-range gather,
    CUDA would read outside the pool.  The kernel checks every entry it
    reads and traps (a device-side assert) rather than read outside it,
    which costs no host synchronisation per call."""
    if q.ndim != 4 or q.shape[1] != 1 or k_pool.ndim != 4 \
            or v_pool.shape != k_pool.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    b, _, h, d = q.shape
    n_pages, page, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if k_pool.shape[3] != d or h % hkv or h // hkv > MAX_REP:
        raise ValueError(f"bad heads: q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    if d != HEAD_DIM:
        raise ValueError(f"head_dim {d}: the kernel is built for {HEAD_DIM}")
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
    fn = _build.function("paged_decode", "paged_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             DTYPES[q.dtype], b, h, hkv, d, page, block_tables.shape[1],
             n_pages, d ** -0.5, q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    paged_decode_cuda.launches += 1
    return out


paged_decode_cuda.launches = 0
