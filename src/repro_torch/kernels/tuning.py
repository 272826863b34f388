"""Tuning registry and autotune sweep for the paged decode kernels.

Port of ``repro.kernels.tuning``.  The reference's paged kernels expose
one tunable, the pages one grid step reads; the port's bf16 paged decode
kernels (rows 2 and 2q of the kernel table) expose their own: the
**split target**, the number of blocks ``decode_split.decode_splits``
aims for when it cuts each row of a batch too small to fill the card
into splits.  Its constants, ``TARGET_BLOCKS`` for pools of q's dtype
and ``TARGET_BLOCKS_INT8`` for int8 pages, assume the 132 SMs of an H100
SXM and each body's blocks per SM.  A target recorded here for a shape
replaces the constant at that shape: both wrappers
(``paged_decode.paged_decode_cuda``, ``paged_decode_int8_cuda``) consult
the registry when the caller forces no split count.

The key is the reference's ``(page_size, head_dim, hkv)`` plus whether
the pages are int8: the two bodies have different best targets, where
the reference's one kernel serves both.  The verify kernels (rows 3, 3q)
and the contiguous decode (row 4) take no tuning: the verify has no
split axis, and row 4's target is fixed by its head width
(``decode_split.target_blocks``).

``autotune_paged_decode`` times each candidate split count at the
caller's shape -- the CUDA kernel by CUDA events on the card, the plain
split-then-merge versions on the CPU, as the reference sweeps in
interpret mode off the TPU -- and records the winner as the target that
reproduces its split count at that shape.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch


@dataclass(frozen=True)
class KernelTuning:
    """The bf16 paged decode kernels' split target for one shape key;
    ``None``: the kernel's own constant (``TARGET_BLOCKS``, or
    ``TARGET_BLOCKS_INT8`` for int8 pages)."""
    target_blocks: Optional[int] = None


DEFAULT_TUNING = KernelTuning()

_REGISTRY: Dict[Tuple[int, int, int, bool], KernelTuning] = {}


def tuning_key(page_size: int, head_dim: int, hkv: int,
               int8: bool = False) -> Tuple[int, int, int, bool]:
    return (int(page_size), int(head_dim), int(hkv), bool(int8))


def record_tuning(page_size: int, head_dim: int, hkv: int,
                  tuning: KernelTuning, int8: bool = False) -> None:
    _REGISTRY[tuning_key(page_size, head_dim, hkv, int8)] = tuning


def tuning_for(page_size: int, head_dim: int, hkv: int,
               int8: bool = False) -> KernelTuning:
    """The recorded tuning for the key, or ``DEFAULT_TUNING``."""
    return _REGISTRY.get(tuning_key(page_size, head_dim, hkv, int8),
                         DEFAULT_TUNING)


def clear_tunings() -> None:
    """Empty the registry: every kernel back on its constant."""
    _REGISTRY.clear()


def _seconds(run, iters: int, on_card: bool) -> float:
    """Seconds per call of ``run`` after one warm call: CUDA events on the
    card, the host clock on the CPU."""
    run()
    if not on_card:
        t0 = time.perf_counter()
        for _ in range(iters):
            run()
        return (time.perf_counter() - t0) / iters
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def autotune_paged_decode(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor, *,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None,
                          candidates: Iterable[int] = (1, 2, 3, 4),
                          iters: int = 20,
                          times: Optional[Dict[int, float]] = None
                          ) -> KernelTuning:
    """Time the bf16 paged decode at each candidate split count on the
    caller's tensors (int8 pages when ``k_scale``/``v_scale`` are given),
    record the fastest under this shape's key and return it.  On a CUDA
    tensor the kernel runs with its split count forced, timed by CUDA
    events; on a CPU tensor the plain split-then-merge version runs.  The
    tuning recorded is the target ``splits * B * Hkv``, which
    ``decode_splits`` turns back into the winner's split count at this
    shape; a candidate no target reaches here raises ``ValueError``.
    ``times``, when given, receives each candidate's milliseconds."""
    # function-level import: the kernel wrappers consult this registry
    from repro_torch.kernels import paged_decode as pd
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_split import decode_splits
    int8 = k_scale is not None
    b, _, _, d = q.shape
    page, hkv = k_pool.shape[1], k_pool.shape[2]
    n = block_tables.shape[1] * page
    on_card = q.is_cuda
    if on_card and q.dtype != torch.bfloat16:
        raise ValueError(f"only the bf16 kernels split: q is {q.dtype}")
    scales = (k_scale, v_scale) if int8 else ()
    if on_card:
        fn = pd.paged_decode_int8_cuda if int8 else pd.paged_decode_cuda
    else:
        fn = (ref.paged_decode_quant_split_ref if int8
              else ref.paged_decode_split_ref)
    best, best_s = DEFAULT_TUNING, float("inf")
    for z in candidates:
        tuning = KernelTuning(target_blocks=z * b * hkv)
        if decode_splits(b, hkv, n, tuning.target_blocks) != z:
            raise ValueError(f"no target gives {z} splits of {n} "
                             f"positions for {b} rows x {hkv} kv heads")

        def run(z=z):
            return fn(q, k_pool, v_pool, *scales, block_tables, lengths,
                      splits=z)

        s = _seconds(run, iters, on_card)
        if times is not None:
            times[z] = s * 1e3
        if s < best_s:
            best, best_s = tuning, s
    record_tuning(page, d, hkv, best, int8=int8)
    return best


__all__ = ["KernelTuning", "DEFAULT_TUNING", "tuning_key", "record_tuning",
           "tuning_for", "clear_tunings", "autotune_paged_decode"]
