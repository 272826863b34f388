"""Step builders for the dry run and the launchers: the train step, the
prefill step and the serve step (one decode token), per architecture.

Port of ``repro.launch.steps``.  The ssm family's mLSTM runs in chunks
of 256, as the reference's steps set it (the chunk sets the intra-chunk
FLOPs and temporaries the dry run counts).  The reference's attention
chunk arguments (``q_chunk``, ``kv_chunk``, ``skip_masked_blocks``) are
XLA settings the port has no counterpart for (the kernels tile on the
card): accepted and dropped.

Under a mesh (``compat.meshenv.mesh_context``) the steps of every family
take DTensors sharded by ``launch.sharding`` -- the state or params, the
batch, the cache -- and run the same code; the prefill step lays its
cache out by the cache specs, nested groups and tail lists included, as
the reference's ``out_shardings`` do.
"""

from __future__ import annotations

from typing import Optional

from repro_torch.compat import meshenv
from repro_torch.configs import _InputShape
from repro_torch.launch import sharding
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import AdamWConfig
from repro_torch.training.train_step import make_train_step

# microbatch count for train_4k per architecture
_TRAIN_MICROBATCHES = {
    "dbrx-132b": 8, "command-r-plus-104b": 8, "qwen3-32b": 8,
    "recurrentgemma-9b": 4, "qwen3-8b": 4, "starcoder2-7b": 4,
    "qwen2-vl-7b": 4, "granite-moe-1b-a400m": 2, "xlstm-1.3b": 2,
    "whisper-base": 1,
}
# the ssm family's mLSTM chunk in every step (reference steps.py)
_SSM_CHUNK = 256


def _apply_kw(cfg: ModelConfig) -> dict:
    """The family's own chunk argument: xlstm's ``chunk``, else none."""
    return {"chunk": _SSM_CHUNK} if cfg.family == "ssm" else {}


def microbatches_for(cfg: ModelConfig, shape: _InputShape) -> int:
    """The architecture's microbatch count, halved until it divides the
    global batch (the reference's count).  Under a mesh a microbatch
    whose rows the batch axes do not divide runs with its rows whole
    along the axes that do not (``train_step._microbatch_rows``)."""
    mb = _TRAIN_MICROBATCHES.get(cfg.name.replace("-window", ""), 4)
    while shape.global_batch % mb != 0:
        mb //= 2
    return max(mb, 1)


def build_train_step(cfg: ModelConfig, shape: _InputShape,
                     microbatches: Optional[int] = None,
                     q_chunk: int = 1024, kv_chunk: int = 1024,
                     skip_masked_blocks: bool = False):
    """``train_step(state, batch) -> (state, metrics)`` with AdamW's
    defaults and ``microbatches``, or else the architecture's count
    (``microbatches_for``)."""
    del q_chunk, kv_chunk, skip_masked_blocks
    return make_train_step(cfg, AdamWConfig(),
                           microbatches=microbatches or microbatches_for(
                               cfg, shape), **_apply_kw(cfg))


def build_prefill_step(cfg: ModelConfig, shape: _InputShape,
                       q_chunk: int = 1024, kv_chunk: int = 1024):
    """``prefill_step(params, batch) -> (logits, cache)`` with a cache of
    ``shape.seq_len`` positions."""
    del q_chunk, kv_chunk
    fam = registry.get_family(cfg)

    def prefill_step(params, batch):
        logits, cache = fam.prefill(params, cfg, batch,
                                    capacity=shape.seq_len,
                                    **_apply_kw(cfg))
        mesh = meshenv.current_mesh()
        if mesh is not None:
            cache = _constrain(cache, sharding.cache_shardings(cache, mesh))
        return logits, cache

    return prefill_step


def _constrain(tree, specs):
    """Each DTensor of ``tree`` (nested dicts and lists) laid out by its
    spec in ``specs``, a tree of the same structure."""
    if isinstance(tree, dict):
        return {k: _constrain(v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_constrain(v, s) for v, s in zip(tree, specs)]
    return meshenv.with_sharding_constraint(tree, specs)


def build_serve_step(cfg: ModelConfig, shape: _InputShape):
    """``serve_step(params, cache, token) -> (logits, cache)``: one decode
    token against a cache of ``shape.seq_len`` positions."""
    del shape
    fam = registry.get_family(cfg)

    def serve_step(params, cache, token):
        return fam.decode_step(params, cfg, cache, token)

    return serve_step
