"""Cross-entropy train step, generic over the model registry.

Port of ``repro.training.train_step``.  Gradients come from
``torch.autograd`` through the port's ``apply``: on the card prefill
attention runs the row 1 kernel forward and a plain recompute backward
(``kernels.flash_attention.FlashAttentionFn``).  Microbatch gradients
accumulate in float32 in a loop, where the reference scans.  A param the
loss does not reach (qwen2-vl's ``embed`` under embedding inputs) gets a
zero gradient, as JAX gives it: it still decays, and its moments still
update.  Under a mesh the state and the batch may be DTensors
(``launch.sharding``): the same code runs, the collectives coming from
DTensor, and the microbatches hold the reference's rows
(``_regroup_rows``).  Rows that the batch axes do not divide, a
microbatch's included, are sharded over the axes that divide them and
run whole on every rank along the rest (``_replica_axes``: the step runs
on the mesh of the other dims, where GSPMD would pad the rows).
``state_shape`` is the dry run's abstract train
state, made of fake tensors (the reference's ``jax.eval_shape``).
"""

from __future__ import annotations

import itertools
import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.compat import meshenv
from repro_torch.models import common as cm
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import flatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over (B, S) in float32; labels < vocab_size; padded classes
    never appear.

    Under a mesh the vocab dim is gathered first and the gold logit is
    read on each rank's own rows: DTensor's gather along a sharded dim (a
    masked partial) fails on these indices, and its gather's backward
    allocates a zero gradient of the global shape on every rank."""
    logits = cm.shard(logits.float(), "batch", None, None)
    logz = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        mesh, rows = logits.device_mesh, logits.placements
        lab = labels if isinstance(labels, DTensor) else DTensor.from_local(
            labels, mesh, [Replicate()] * mesh.ndim, run_check=False)
        lab = lab.redistribute(mesh, rows).to_local()
        gold = DTensor.from_local(_gold(logits.to_local(), lab), mesh, rows,
                                  run_check=False)
    else:
        gold = _gold(logits, labels)
    return torch.mean(logz - gold)


def _gold(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Each position's logit of its label: (B, S, V), (B, S) -> (B, S)."""
    return torch.gather(logits, -1, labels.long()[..., None])[..., 0]


def loss_fn(params, cfg: ModelConfig, batch: Dict, aux_weight: float = 0.01,
            **apply_kw) -> Tuple[torch.Tensor, Dict]:
    logits, aux = registry.apply_with_aux(params, cfg, batch, **apply_kw)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _replica_axes(batch: Dict) -> Tuple[str, ...]:
    """The batch axes (``cm.BATCH_AXES``, extent above 1) of a DTensor
    batch's mesh that do not shard its rows: along them every rank holds
    the same rows.  ``()`` for a plain batch."""
    x = next((v for v in batch.values() if isinstance(v, DTensor)), None)
    if x is None:
        return ()
    mesh = x.device_mesh
    return tuple(n for n, size, p in zip(mesh.mesh_dim_names, mesh.shape,
                                         x.placements)
                 if n in cm.BATCH_AXES and size > 1 and not p.is_shard(0))


def loss_and_grads(params, cfg: ModelConfig, batch: Dict, **apply_kw):
    """(loss, parts, grads): ``loss_fn`` on ``batch`` (``apply_kw`` to the
    family's ``apply``) and its gradient
    with respect to every leaf of ``params`` (a tree of the same
    structure; zero where the loss does not reach), taken through
    aliases of the leaves, so the caller's params never require grad.

    Under a mesh with batch axes that do not shard the rows
    (``_replica_axes``), ``loss_fn`` runs on the mesh of the other dims:
    params and batch moved there (``meshenv.onto``: gathered over the
    replica axes, each rank along them computing the same gradient),
    the results moved back.  Left on the whole mesh, DTensor's backward
    may split a contraction over such an axis and reduce-scatter the
    partial sum onto rows it does not divide, which it cannot view."""
    leaves, build = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    replicas = _replica_axes(batch)
    if not replicas:
        loss, parts = loss_fn(build(live), cfg, batch, **apply_kw)
    else:
        mesh = next(v for v in batch.values()
                    if isinstance(v, DTensor)).device_mesh
        sub = meshenv.submesh(mesh, [n for n in mesh.mesh_dim_names
                                     if n not in replicas])
        with meshenv.mesh_context(sub):
            loss, parts = loss_fn(
                build([meshenv.onto(p, sub) for p in live]), cfg,
                {k: meshenv.onto(v, sub) for k, v in batch.items()},
                **apply_kw)
    grads = torch.autograd.grad(loss, live, materialize_grads=True)
    loss, parts = loss.detach(), {k: v.detach() for k, v in parts.items()}
    if replicas:
        loss = meshenv.lift(loss, mesh)
        parts = {k: meshenv.lift(v, mesh) for k, v in parts.items()}
    return loss, parts, build(list(grads))


def _row_shards(mb: int, extents) -> Tuple[int, ...]:
    """The positions in ``extents`` (the extents of a batch's row axes,
    in mesh order) of the largest set of axes whose product divides
    ``mb`` rows: the axes a microbatch of ``mb`` rows is sharded over."""
    sets = (c for r in range(len(extents) + 1)
            for c in itertools.combinations(range(len(extents)), r)
            if mb % math.prod(extents[i] for i in c) == 0)
    return max(sets, key=lambda c: math.prod(extents[i] for i in c))


def _microbatch_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor batch laid out for ``n`` microbatches: its rows sharded
    over the row axes that divide a microbatch's rows (``_row_shards``;
    replicated over the rest), then regrouped (``_regroup_rows``).  A
    microbatch of fewer rows than the shards, or of rows they do not
    divide, so runs whole along the axes dropped (``loss_and_grads``),
    where the reference's GSPMD pads it.  A plain tensor is returned as
    it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    dims = [i for i, p in enumerate(x.placements) if p.is_shard()]
    keep = _row_shards(x.shape[0] // n, [mesh.size(i) for i in dims])
    if len(keep) < len(dims):
        names = tuple(mesh.mesh_dim_names[dims[i]] for i in keep)
        x = meshenv.with_sharding_constraint(x, (names or None,))
    return _regroup_rows(x, n)


def _regroup_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """A DTensor batch laid out for ``n`` microbatches: afterwards slice i
    of the ``n`` equal slices of each rank's rows, over the ranks in shard
    order, is the global rows ``[i mb, (i + 1) mb)``, the reference's
    microbatch i, and every rank works on every microbatch.  The grouping
    is the reference's because the MoE aux loss of a microbatch is not
    linear in its rows.  One ``all_to_all_single`` over the batch shards
    moves each slice of ``l = local rows / n`` rows to its rank.  A plain
    tensor, or rows on one shard, is returned as it is; rows that do not
    split into ``n`` equal slices raise."""
    if not isinstance(x, DTensor):
        return x
    mesh, pl = x.device_mesh, x.placements
    dims = [i for i, p in enumerate(pl) if p.is_shard()]
    if any(not pl[i].is_shard(0) for i in dims):
        raise ValueError(f"a batch is sharded on its rows only, not {pl}")
    local = x.to_local()
    if local.shape[0] % n:
        raise ValueError(f"{local.shape[0]} rows on each rank do not split "
                         f"into {n} microbatches")
    ranks = math.prod(mesh.size(i) for i in dims)
    if n == 1 or ranks == 1:
        return x
    coord, r = mesh.get_coordinate(), 0
    for i in dims:                      # shard order: mesh dims row-major
        r = r * mesh.size(i) + coord[i]
    names = tuple(mesh.mesh_dim_names[i] for i in dims)
    group = (mesh.get_group(dims[0]) if len(dims) == 1
             else mesh[names]._flatten().get_group())
    l = local.shape[0] // n
    # slice t here is global block k = r n + t of l rows: microbatch
    # k // ranks, held by rank k % ranks
    dest = [(r * n + t) % ranks for t in range(n)]
    send = torch.cat([local[t * l:(t + 1) * l]
                      for t in sorted(range(n), key=dest.__getitem__)])
    # microbatch i's block for this rank comes from rank (i ranks + r) // n;
    # received in source order, which is microbatch order
    src = [(i * ranks + r) // n for i in range(n)]
    recv = funcol.all_to_all_single(
        send, [l * src.count(q) for q in range(ranks)],
        [l * dest.count(q) for q in range(ranks)], group)
    return DTensor.from_local(funcol.wait_tensor(recv), mesh, pl,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def _split_microbatch(batch: Dict, n: int, i: int) -> Dict:
    """Microbatch ``i`` of ``n``: rows ``[i mb, (i + 1) mb)``.  A DTensor
    batch, laid out by ``_regroup_rows``, is cut on each rank's own rows:
    slice i of them is the rank's part of those rows, and no batch is
    gathered."""
    def slc(x):
        if isinstance(x, DTensor):
            local = x.to_local()
            mb = local.shape[0] // n
            return DTensor.from_local(local[i * mb:(i + 1) * mb],
                                      x.device_mesh, x.placements,
                                      run_check=False)
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


def microbatch_grads(params, cfg: ModelConfig, batch: Dict,
                     microbatches: int = 1, **apply_kw):
    """(loss, parts, grads) of the train step before its update: with
    ``microbatches`` > 1 the gradients of equal slices of the (global)
    batch dimension, accumulated in float32 and averaged, each rank's
    rows of a DTensor batch laid out first (``_microbatch_rows``), and
    ``parts`` are ``ce`` the mean total loss and ``aux`` 0, as the
    reference reports them; with one, ``loss_and_grads``."""
    if microbatches == 1:
        return loss_and_grads(params, cfg, batch, **apply_kw)
    batch = {k: _microbatch_rows(v, microbatches) for k, v in batch.items()}
    leaves, build = flatten(params)
    acc = [torch.zeros_like(p, dtype=torch.float32) for p in leaves]
    loss = acc[0].new_zeros(())
    for i in range(microbatches):
        mb = _split_microbatch(batch, microbatches, i)
        mb_loss, _, g = loss_and_grads(params, cfg, mb, **apply_kw)
        for a, gi in zip(acc, flatten(g)[0]):
            a.add_(gi.float())
        loss = loss + mb_loss
    loss = loss / microbatches
    return (loss, {"ce": loss, "aux": torch.zeros_like(loss)},
            build([a.div_(microbatches) for a in acc]))


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, **apply_kw):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}, updated in place
    (``adamw_update``) with the gradients of ``microbatch_grads``; batch
    contains "labels" plus model inputs.  Of
    ``apply_kw``, xlstm's ``chunk`` goes to ``apply``; the reference's
    attention chunks (``q_chunk``, ``kv_chunk``, ``skip_masked_blocks``)
    are XLA settings with no counterpart in the port (the kernels tile on
    the card), accepted and dropped."""
    apply_kw = {k: v for k, v in apply_kw.items() if k == "chunk"}

    def train_step(state, batch):
        params = state["params"]
        loss, parts, grads = microbatch_grads(params, cfg, batch,
                                              microbatches, **apply_kw)
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads,
                                               state["opt"])
        metrics = {"loss": loss, **parts, **om}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device | str) -> Dict[str, Any]:
    params = registry.init(cfg, generator, device)
    return {"params": params, "opt": init_opt_state(params)}


def state_shape(cfg: ModelConfig, device: torch.device | str = "cpu"):
    """The train state of ``cfg`` as fake tensors on ``device``: shapes
    and dtypes only, nothing allocated (the dry-run path).  Drawn on the
    CPU, then moved: the draw needs no generator on ``device``."""
    from repro_torch.compat import meshenv
    with meshenv.abstract_mode():
        ts, build = flatten(init_state(cfg, torch.Generator(), "cpu"))
        return build([t.to(device) for t in ts])
