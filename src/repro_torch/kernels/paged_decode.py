"""Paged decode attention on the card: the wrappers of
``csrc/paged_decode.cu``.

The CUDA kernel replaces the TPU kernel
``src/repro/kernels/paged_decode.py`` · ``flash_paged_decode_tpu`` in both
its forms: one query token per row over a KV page pool reached through a
block table, positions below ``lengths[b]`` valid.  ``paged_decode_cuda``
takes pools of q's dtype; ``paged_decode_int8_cuda`` takes int8 pools with
bf16 scale pools (the TPU kernel's ``k_scale``/``v_scale``), dequantized in
the kernel.  With q in bfloat16 both run the tensor-core body and cut each
row's table across ``decode_split.decode_splits`` blocks when the batch is
too small to fill the card.  Their plain versions are
``kernels.ref.paged_decode_ref`` and ``paged_decode_quant_ref``;
``kernels.ops.paged_decode`` and ``paged_decode_quant`` pick between kernel
and plain version by the tensors' device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.decode_split import (TARGET_BLOCKS,
                                              TARGET_BLOCKS_INT8,
                                              decode_splits, split_span)
from repro_torch.kernels.flash_attention import (DTYPES, check_cuda_inputs,
                                                 check_head_dim)

MAX_REP = 16            # query heads per kv head (kMaxRep in the source)
_HEAD_DIMS = (128,)     # the widths it is built for (qwen3-8b's)
_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 10
             + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
_INT8_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 10
                  + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])


def check_paged_inputs(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor,
                       max_rep: int | None) -> Tuple[int, int, int]:
    """Shape and type checks shared by the paged decode and verify
    wrappers: q (B, K, H, D), pools (P, page, Hkv, D), tables (B, maxp)
    and lengths (B,) int32; ``max_rep`` caps H / Hkv (None: no cap).
    Returns (P, page, Hkv)."""
    if q.ndim != 4 or k_pool.ndim != 4 or v_pool.shape != k_pool.shape:
        raise ValueError(f"bad shapes q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    b, kq, h, d = q.shape
    n_pages, page, hkv = k_pool.shape[0], k_pool.shape[1], k_pool.shape[2]
    if (k_pool.shape[3] != d or kq < 1 or b < 1 or h % hkv
            or (max_rep is not None and h // hkv > max_rep)):
        raise ValueError(f"bad heads or tokens: q{tuple(q.shape)} "
                         f"pool{tuple(k_pool.shape)}")
    check_head_dim(d, _HEAD_DIMS)
    if block_tables.ndim != 2 or block_tables.shape[0] != b \
            or block_tables.shape[1] < 1 or tuple(lengths.shape) != (b,):
        raise ValueError(f"bad tables{tuple(block_tables.shape)} / "
                         f"lengths{tuple(lengths.shape)} for batch {b}")
    if block_tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("block_tables and lengths must be int32")
    return n_pages, page, hkv


def check_int8_pools(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, k_scale: torch.Tensor,
                     v_scale: torch.Tensor) -> None:
    """int8 pools and bf16 scale pools (P, page, Hkv, 1), contiguous, on
    q's device (the pools 16-byte aligned, which ``check_cuda_inputs``
    checks; a scale is read as one bf16)."""
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"int8 pools expected, got {k_pool.dtype} / "
                        f"{v_pool.dtype}")
    want = tuple(k_pool.shape[:3]) + (1,)
    for s in (k_scale, v_scale):
        if s.dtype != torch.bfloat16 or tuple(s.shape) != want:
            raise TypeError(f"scale pools must be bfloat16 {want}, got "
                            f"{s.dtype} {tuple(s.shape)}")
        if s.device != q.device or not s.is_contiguous() \
                or s.data_ptr() % 2:
            raise ValueError(f"scale pools must be contiguous on {q.device}"
                             f", got {s.device}, contiguous "
                             f"{s.is_contiguous()}")


def _splits_and_workspace(q: torch.Tensor, hkv: int, n: int, target: int):
    """The bf16 kernels' splits of a row's ``n`` positions toward ``target``
    blocks (fp32 takes 1) and, with more than one, their fp32 workspace
    (uninitialised: every split writes its partial)."""
    b, _, h, d = q.shape
    splits = (decode_splits(b, hkv, n, target) if q.dtype == torch.bfloat16
              else 1)
    work = (torch.empty(b * h * splits * (d + 2), dtype=torch.float32,
                        device=q.device) if splits > 1 else None)
    return splits, work


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
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)}")
    n_pages, page, hkv = check_paged_inputs(q, k_pool, v_pool, block_tables,
                                            lengths, MAX_REP)
    if k_pool.dtype != q.dtype or v_pool.dtype != q.dtype:
        raise TypeError("q and the pools must share one dtype")
    check_cuda_inputs((q, k_pool, v_pool, block_tables, lengths), q.dtype)
    b, _, h, d = q.shape
    maxp = block_tables.shape[1]
    splits, work = _splits_and_workspace(q, hkv, maxp * page, TARGET_BLOCKS)
    out = torch.empty_like(q)
    fn = _build.function("paged_decode", "paged_decode_fwd", _ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if work is None else work.data_ptr(), DTYPES[q.dtype], b,
             h, hkv, d, page, maxp, n_pages, splits,
             split_span(maxp * page, splits), d ** -0.5,
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode launch failed: CUDA error {err}")
    paged_decode_cuda.launches += 1
    paged_decode_cuda.last_splits = splits
    paged_decode_cuda.merge_launches += splits > 1
    return out


paged_decode_cuda.launches = 0
paged_decode_cuda.last_splits = 0   # the splits of the last launch
paged_decode_cuda.merge_launches = 0   # launches that also merged splits


def paged_decode_int8_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, k_scale: torch.Tensor,
                           v_scale: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """Launch the int8 paged decode kernel.  q: (B, 1, H, D) fp32 or bf16;
    pools (P, page, Hkv, D) int8; scale pools (P, page, Hkv, 1) bf16;
    tables and lengths as in ``paged_decode_cuda`` -> (B, 1, H, D) of q's
    dtype.  In bf16 it splits rows as ``paged_decode_cuda`` does, toward
    ``TARGET_BLOCKS_INT8`` blocks."""
    if q.ndim != 4 or q.shape[1] != 1:
        raise ValueError(f"bad shapes q{tuple(q.shape)}")
    n_pages, page, hkv = check_paged_inputs(q, k_pool, v_pool, block_tables,
                                            lengths, MAX_REP)
    check_int8_pools(q, k_pool, v_pool, k_scale, v_scale)
    check_cuda_inputs((q, k_pool, v_pool, block_tables, lengths), q.dtype)
    b, _, h, d = q.shape
    maxp = block_tables.shape[1]
    splits, work = _splits_and_workspace(q, hkv, maxp * page,
                                         TARGET_BLOCKS_INT8)
    out = torch.empty_like(q)
    fn = _build.function("paged_decode", "paged_decode_int8_fwd",
                         _INT8_ARGTYPES)
    err = fn(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
             k_scale.data_ptr(), v_scale.data_ptr(),
             block_tables.data_ptr(), lengths.data_ptr(), out.data_ptr(),
             None if work is None else work.data_ptr(), DTYPES[q.dtype], b,
             h, hkv, d, page, maxp, n_pages, splits,
             split_span(maxp * page, splits), d ** -0.5,
             q.device.index or 0,
             torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_int8 launch failed: CUDA error "
                           f"{err}")
    paged_decode_int8_cuda.launches += 1
    paged_decode_int8_cuda.last_splits = splits
    paged_decode_int8_cuda.merge_launches += splits > 1
    return out


paged_decode_int8_cuda.launches = 0
paged_decode_int8_cuda.last_splits = 0   # the splits of the last launch
paged_decode_int8_cuda.merge_launches = 0   # launches that also merged splits
