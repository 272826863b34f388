"""Dispatch of the attention entry points the model calls.

Port of ``repro.kernels.ops``: a CPU tensor goes to the kernel's plain
version (``kernels.ref``), a CUDA tensor launches the hand-written CUDA
kernel or raises -- no ``try`` falls back to the plain version, and no
library attention stands in for a kernel.  Each kernel wrapper counts its
launches; ``launch_counts`` reads them (``merge_launches``: the split
decode calls that also launched the merge of their splits) and
``reset_launch_counts`` zeroes them, so a run can show that its path went
through the kernels.

Under autograd, prefill attention on the card goes through
``FlashAttentionFn`` (the kernel forward, a plain-recompute backward); the
decode and verify rows only serve and have no backward, so on the card
they raise rather than cut the graph (``forbid_grad``).

Two more kinds of input take explicit branches:

* **A DTensor** (the mesh layer's sharded steps): ``attention`` and
  ``decode`` redistribute their inputs so that every rank holds whole
  sequences of its batch rows and of its heads (batch over the data
  axes, heads over ``model`` when both head counts divide it, the cache's
  sequence gathered), run the kernel -- or, on the CPU, the plain version
  -- on the local shards, and wrap the result as a DTensor of the same
  placements; ``to_local``/``from_local`` carry gradients.  A CUDA
  DTensor never reaches the plain version.
* **Fake tensors** (only the dry run and ``launch.specs`` make them)
  take the plain version: there is nothing to launch.  A plain ``meta``
  tensor, like any device but the card and the CPU, has no attention
  path and raises.  Under
  autograd it is recomputed in the backward, as ``FlashAttentionFn``
  recomputes, so the saved tensors are the card's.  A hook the
  dry run sets (``kernel_scope``) brackets each such call, so that its
  byte count reads the kernel's operands and result, not the plain
  version's intermediates.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Callable, Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor

from repro_torch.compat import meshenv
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda)
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


def _abstract(t: torch.Tensor) -> bool:
    """A fake tensor: shapes only, nothing to launch on."""
    return isinstance(t, FakeTensor)


def _on_cuda(t: torch.Tensor) -> bool:
    if isinstance(t, DTensor):
        raise TypeError("the paged rows take no DTensor: engines run "
                        "unsharded")
    if _abstract(t):
        return False
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention path for device {t.device}")


# the dry run's bracket around a plain version run on fake tensors:
# (kernel name, inputs) -> context manager
_KERNEL_SCOPE: ContextVar[Optional[Callable]] = ContextVar(
    "repro_torch_kernel_scope", default=None)


@contextlib.contextmanager
def kernel_scope(hook: Callable):
    """Call ``hook(name, inputs)`` (a context manager) around each
    kernel's plain version run on fake tensors in the block."""
    tok = _KERNEL_SCOPE.set(hook)
    try:
        yield
    finally:
        _KERNEL_SCOPE.reset(tok)


def _abstract_call(name: str, plain: Callable, *inputs, **kw):
    hook = _KERNEL_SCOPE.get()
    scope = (contextlib.nullcontext() if hook is None
             else hook(name, inputs))
    with scope:
        return plain(*inputs, **kw)


def _attention_dims(mesh, b: int, heads) -> Dict[str, int]:
    """Which mesh dims shard an attention call's tensors: the batch axes
    dim 0 when they divide ``b``, ``model`` dim 2 (heads) when it divides
    every count in ``heads``; the rest replicate."""
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    bx = [a for a in ("pod", "data") if a in sizes]
    dims: Dict[str, int] = {}
    if bx and b % math.prod(sizes[a] for a in bx) == 0:
        dims.update({a: 0 for a in bx})
    if "model" in sizes and all(h % sizes["model"] == 0 for h in heads):
        dims["model"] = 2
    return dims


def _needs_grad(tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def forbid_grad(row: str, *tensors: torch.Tensor) -> None:
    """Raise ``RuntimeError`` when grad mode is on and an input of the
    forward-only kernel ``row`` requires grad: its output would carry no
    gradient, and the graph would be cut without a sign."""
    if _needs_grad(tensors):
        raise RuntimeError(f"{row} has no backward: call it under "
                           f"torch.no_grad() or on inputs that do not "
                           f"require grad")


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True,
              window: Optional[int] = None) -> torch.Tensor:
    """Prefill attention.  q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D).  On
    the card, with grad mode on and an input requiring grad, the kernel
    runs under ``FlashAttentionFn``; otherwise it launches directly.  A
    DTensor runs on its local batch rows and heads."""
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        dims = _attention_dims(mesh, q.shape[0], (q.shape[2], k.shape[2]))
        out = attention(*(meshenv.to_local(t, mesh, dims)
                          for t in (q, k, v)),
                        causal=causal, window=window)
        return meshenv.from_local(out, q, dims)
    if _abstract(q):
        if _needs_grad((q, k, v)):
            # as FlashAttentionFn: keep q, k, v and recompute in backward
            from torch.utils.checkpoint import checkpoint
            return checkpoint(_abstract_call, "flash_attention", flash_ref,
                              q, k, v, causal=causal, window=window,
                              use_reentrant=False)
        return _abstract_call("flash_attention", flash_ref, q, k, v,
                              causal=causal, window=window)
    if _on_cuda(q):
        if _needs_grad((q, k, v)):
            return FlashAttentionFn.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window)
    return flash_ref(q, k, v, causal=causal, window=window)


def paged_decode(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor, lengths: torch.Tensor, *,
                 splits: Optional[int] = None) -> torch.Tensor:
    """Block-table paged decode.  q: (B, 1, H, D); pools (P, page, Hkv, D);
    block_tables: (B, maxp) int32; lengths: (B,) int32.  ``splits`` (the
    reference's ``pages_per_step`` override) forces the bf16 kernel's
    split count over ``kernels.tuning``'s; the plain version ignores
    it."""
    if _on_cuda(q):
        forbid_grad("paged_decode", q, k_pool, v_pool)
        return paged_decode_cuda(q, k_pool, v_pool, block_tables, lengths,
                                 splits=splits)
    return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths)


def decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
           lengths: torch.Tensor, *,
           window: Optional[int] = None) -> torch.Tensor:
    """Contiguous decode.  q: (B, 1, H, D); caches (B, S, Hkv, D);
    lengths: (B,) int32, positions ``max(0, len - window) <= k < len``
    valid.  A DTensor runs on its local batch rows and heads over the
    whole cache sequence.  Its split target is fixed by the head width
    (``decode_split.target_blocks``): no entry in ``kernels.tuning``, as
    the reference's contiguous decode takes no tuning."""
    if isinstance(q, DTensor):
        mesh = q.device_mesh
        dims = _attention_dims(mesh, q.shape[0],
                               (q.shape[2], k_cache.shape[2]))
        local = [meshenv.to_local(t, mesh, dims)
                 for t in (q, k_cache, v_cache)]
        lens = meshenv.to_local(lengths, mesh,
                                {a: 0 for a, d in dims.items() if d == 0})
        return meshenv.from_local(decode(*local, lens, window=window), q, dims)
    if _abstract(q):
        return _abstract_call("flash_decode", decode_ref, q, k_cache,
                              v_cache, lengths, window=window)
    if _on_cuda(q):
        forbid_grad("decode", q, k_cache, v_cache)
        return flash_decode_cuda(q, k_cache, v_cache, lengths, window=window)
    return decode_ref(q, k_cache, v_cache, lengths, window=window)


def paged_verify(q: torch.Tensor, k_pool: torch.Tensor, v_pool: torch.Tensor,
                 block_tables: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """Block-table multi-token verify.  q: (B, K, H, D); pools
    (P, page, Hkv, D); block_tables: (B, maxp) int32; lengths: (B,) int32
    before the K new tokens, query j attending positions
    ``<= lengths[b] + j``.  No split axis, so no ``splits`` and no entry
    in ``kernels.tuning``, as the reference's verify takes its tuning
    only for the pages a step reads."""
    if _on_cuda(q):
        forbid_grad("paged_verify", q, k_pool, v_pool)
        return paged_verify_cuda(q, k_pool, v_pool, block_tables, lengths)
    return paged_verify_ref(q, k_pool, v_pool, block_tables, lengths)


def paged_decode_quant(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *,
                       splits: Optional[int] = None) -> torch.Tensor:
    """Int8 block-table paged decode: int8 pools (P, page, Hkv, D) plus
    bf16 scale pools (P, page, Hkv, 1) riding the same table, dequantized
    in the kernel.  q, tables, lengths and ``splits`` as in
    ``paged_decode`` (the int8 key of ``kernels.tuning``)."""
    if _on_cuda(q):
        forbid_grad("paged_decode_quant", q, k_pool, v_pool, k_scale,
                    v_scale)
        return paged_decode_int8_cuda(q, k_pool, v_pool, k_scale, v_scale,
                                      block_tables, lengths, splits=splits)
    return paged_decode_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                  block_tables, lengths)


def paged_verify_quant(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, k_scale: torch.Tensor,
                       v_scale: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor) -> torch.Tensor:
    """Int8 block-table multi-token verify: pools and scales as in
    ``paged_decode_quant``, q, tables and lengths as in
    ``paged_verify`` (no split axis, no tuning)."""
    if _on_cuda(q):
        forbid_grad("paged_verify_quant", q, k_pool, v_pool, k_scale,
                    v_scale)
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
