"""Dispatch of the attention entry points the model calls.

Port of ``repro.kernels.ops``: a CPU tensor goes to the kernel's plain
version (``kernels.ref``), a CUDA tensor launches the hand-written CUDA
kernel or raises -- no ``try`` falls back to the plain version, and no
library attention stands in for a kernel.  Each kernel wrapper counts its
launches; ``launch_counts`` reads them (``merge_launches``: the split
decode calls that also launched the merge of their splits) and
``reset_launch_counts`` zeroes them, so a run can show that its path went
through the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.flash_decode import flash_decode_cuda
from repro_torch.kernels.paged_decode import (paged_decode_cuda,
                                              paged_decode_int8_cuda)
from repro_torch.kernels.paged_verify import (paged_verify_cuda,
                                              paged_verify_int8_cuda)
from repro_torch.kernels.ref import (decode_ref, flash_ref, paged_decode_ref,
                                     paged_decode_quant_ref, paged_verify_ref,
                                     paged_verify_quant_ref)

# each kernel: its launching wrapper, its CUDA source and the TPU kernel
# (file:line of the function that reaches the Pallas call) it replaces
KERNELS = {
    "flash_attention": dict(
        wrapper=flash_attention_cuda,
        source="src/repro_torch/kernels/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:77"),
    "paged_decode": dict(
        wrapper=paged_decode_cuda,
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_decode.py:192"),
    "flash_decode": dict(
        wrapper=flash_decode_cuda,
        source="src/repro_torch/kernels/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:66"),
    "paged_verify": dict(
        wrapper=paged_verify_cuda,
        source="src/repro_torch/kernels/csrc/paged_verify.cu",
        replaces="src/repro/kernels/spec_verify.py:87"),
    "paged_decode_int8": dict(
        wrapper=paged_decode_int8_cuda,
        source="src/repro_torch/kernels/csrc/paged_decode.cu",
        replaces="src/repro/kernels/paged_decode.py:192 with k_scale/v_scale"),
    "paged_verify_int8": dict(
        wrapper=paged_verify_int8_cuda,
        source="src/repro_torch/kernels/csrc/paged_verify.cu",
        replaces="src/repro/kernels/spec_verify.py:87 with k_scale/v_scale"),
}


def _on_cuda(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for device {t.device}")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention.  q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D)."""
    if _on_cuda(q):
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_ref(q, k, v, causal=causal, window=window)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Block-table paged decode.  q: (B, 1, H, D); pools (P, page, Hkv, D);
    block_tables: (B, maxp) int32; lengths: (B,) int32."""
    if _on_cuda(q):
        return paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths)
    return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths)


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, *,
           window: Optional[int] = None) -> torch.Tensor:
    """Contiguous decode.  q: (B, 1, H, D); caches (B, S, Hkv, D);
    lengths: (B,) int32, positions ``max(0, len - window) <= k < len``
    valid."""
    if _on_cuda(q):
        return flash_decode_cuda(q, k_cache, v_cache, lengths, window=window)
    return decode_ref(q, k_cache, v_cache, lengths, window=window)


def paged_verify(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Block-table multi-token verify.  q: (B, K, H, D); pools
    (P, page, Hkv, D); block_tables: (B, maxp) int32; lengths: (B,) int32
    before the K new tokens, query j attending positions
    ``<= lengths[b] + j``."""
    if _on_cuda(q):
        return paged_verify_cuda(q, k_pool, v_pool, block_tables, lengths)
    return paged_verify_ref(q, k_pool, v_pool, block_tables, lengths)


def paged_decode_quant(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Int8 block-table paged decode: int8 pools (P, page, Hkv, D) plus
    bf16 scale pools (P, page, Hkv, 1) riding the same table, dequantized
    in the kernel.  q, tables and lengths as in ``paged_decode``."""
    if _on_cuda(q):
        return paged_decode_int8_cuda(q, k_pool, v_pool, k_scale, v_scale,
                                      block_tables, lengths)
    return paged_decode_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, lengths)


def paged_verify_quant(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Int8 block-table multi-token verify: pools and scales as in
    ``paged_decode_quant``, q, tables and lengths as in
    ``paged_verify``."""
    if _on_cuda(q):
        return paged_verify_int8_cuda(q, k_pool, v_pool, k_scale, v_scale,
                                      block_tables, lengths)
    return paged_verify_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, lengths)


def launch_counts() -> Dict[str, int]:
    return {name: k["wrapper"].launches for name, k in KERNELS.items()}


def merge_launches() -> int:
    """Launches of the merge of split rows: a bf16 decode call that cut its
    rows into splits launches it once after its kernel (the wrappers with a
    ``merge_launches`` count)."""
    return sum(getattr(k["wrapper"], "merge_launches", 0)
               for k in KERNELS.values())


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k["wrapper"].launches = 0
        if hasattr(k["wrapper"], "merge_launches"):
            k["wrapper"].merge_launches = 0
