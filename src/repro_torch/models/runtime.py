"""Lowering-mode and sharding-variant switches of the mesh layer.

Port of ``repro.models.runtime``: context-variable flags read where the
model code consults them, set for a block with ``perf_flags`` or
``roofline_lowering``.

* ``roofline_mode`` / ``roofline_lowering``: the reference unrolls its
  structural ``lax.scan`` loops under this flag because XLA's cost
  analysis counts a loop body once.  The port's loops are Python loops
  and the dry run's counting mode (``launch.dryrun``) sees every
  iteration, so the sites with a counterpart are the xLSTM's two
  (``models/xlstm.py``): the sLSTM time loop's parallel surrogate, and
  the mLSTM's chunk raised to at least 1024.  The reference's
  ``scan_unroll`` and ``attn_chunk`` have no counterpart: the port has no
  ``lax.scan`` and no attention chunk loop (the kernels tile on the
  card).
* ``slstm_surrogate`` / ``surrogate_slstm``: the sLSTM's surrogate
  alone, without the roofline's larger mLSTM chunk, for the dry run's
  memory runs: its loop of T steps, even on each rank's local fake
  tensors, keeps xlstm-1.3b's ``train_4k`` memory runs at over
  30 minutes on a CPU.
* The sharding variants: ``seq_parallel`` (the residual stream's sequence
  dim over ``model``, read by ``common.logical``), ``decode_seq_shard``
  (``attention.decode_attention_seqsharded``), ``attn_batch_only`` (no
  ``model`` constraint on q/k/v), ``gqa_native`` (the reference's
  switch to K/V kept at ``n_kv_heads`` in its attention; the port's
  kernels always keep them so, so it has nothing to switch and the flag
  only travels with ``perf_flags`` and the dry run's variants) and
  ``moe_a2a`` (``moe._moe_mlp_a2a``).
"""

from __future__ import annotations

import contextlib
from contextvars import ContextVar

_ROOFLINE: ContextVar[bool] = ContextVar("repro_torch_roofline_mode",
                                         default=False)
_SEQ_PARALLEL: ContextVar[bool] = ContextVar("repro_torch_seq_parallel",
                                             default=False)
_DECODE_SEQ_SHARD: ContextVar[bool] = ContextVar(
    "repro_torch_decode_seq_shard", default=False)
_ATTN_BATCH_ONLY: ContextVar[bool] = ContextVar(
    "repro_torch_attn_batch_only", default=False)
_GQA_NATIVE: ContextVar[bool] = ContextVar("repro_torch_gqa_native",
                                           default=False)
_MOE_A2A: ContextVar[bool] = ContextVar("repro_torch_moe_a2a",
                                        default=False)


def roofline_mode() -> bool:
    return _ROOFLINE.get()


@contextlib.contextmanager
def roofline_lowering():
    tok = _ROOFLINE.set(True)
    try:
        yield
    finally:
        _ROOFLINE.reset(tok)


_SLSTM_SURROGATE: ContextVar[bool] = ContextVar(
    "repro_torch_slstm_surrogate", default=False)


def slstm_surrogate() -> bool:
    """The sLSTM over a sequence takes its parallel surrogate: under
    ``roofline_lowering`` or ``surrogate_slstm``."""
    return _ROOFLINE.get() or _SLSTM_SURROGATE.get()


@contextlib.contextmanager
def surrogate_slstm():
    tok = _SLSTM_SURROGATE.set(True)
    try:
        yield
    finally:
        _SLSTM_SURROGATE.reset(tok)


def moe_a2a() -> bool:
    """Explicit expert-parallel all-to-all MoE dispatch (``moe.py``)."""
    return _MOE_A2A.get()


def gqa_native() -> bool:
    """GQA-native attention: K/V stay at ``n_kv_heads``."""
    return _GQA_NATIVE.get()


def seq_parallel() -> bool:
    """Sequence parallelism: the residual stream's sequence dim sharded
    over ``model``."""
    return _SEQ_PARALLEL.get()


def decode_seq_shard() -> bool:
    """Sequence-sharded decode: each ``model`` rank writes and attends its
    own chunk of the cache, partials combined by all-reduce."""
    return _DECODE_SEQ_SHARD.get()


def attn_batch_only() -> bool:
    """Skip the ``model`` constraint on the q/k/v projections."""
    return _ATTN_BATCH_ONLY.get()


@contextlib.contextmanager
def perf_flags(seq_parallel_: bool = False, decode_seq_shard_: bool = False,
               attn_batch_only_: bool = False, gqa_native_: bool = False,
               moe_a2a_: bool = False):
    pairs = [(_SEQ_PARALLEL, seq_parallel_),
             (_DECODE_SEQ_SHARD, decode_seq_shard_),
             (_ATTN_BATCH_ONLY, attn_batch_only_),
             (_GQA_NATIVE, gqa_native_),
             (_MOE_A2A, moe_a2a_)]
    toks = [(var, var.set(val)) for var, val in pairs]
    try:
        yield
    finally:
        for var, tok in toks:
            var.reset(tok)
