"""Cross-entropy train step, generic over the model registry.

Port of ``repro.training.train_step``.  Gradients come from
``torch.autograd`` through the port's ``apply``: on the card prefill
attention runs the row 1 kernel forward and a plain recompute backward
(``kernels.flash_attention.FlashAttentionFn``).  Microbatch gradients
accumulate in float32 in a loop, where the reference scans.  A param the
loss does not reach (qwen2-vl's ``embed`` under embedding inputs) gets a
zero gradient, as JAX gives it: it still decays, and its moments still
update.  ``state_shape`` (the reference's dry-run path, ``jax.eval_shape``)
belongs to the mesh layer and is not ported.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.training.optimizer import (AdamWConfig, adamw_update,
                                            init_opt_state)
from repro_torch.training.tree import flatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean CE over (B, S) in float32; labels < vocab_size; padded classes
    never appear."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(logz - gold)


def loss_fn(params, cfg: ModelConfig, batch: Dict, aux_weight: float = 0.01
            ) -> Tuple[torch.Tensor, Dict]:
    logits, aux = registry.apply_with_aux(params, cfg, batch)
    ce = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def loss_and_grads(params, cfg: ModelConfig, batch: Dict):
    """(loss, parts, grads): ``loss_fn`` on ``batch`` and its gradient
    with respect to every leaf of ``params`` (a tree of the same
    structure; zero where the loss does not reach), taken through
    aliases of the leaves, so the caller's params never require grad."""
    leaves, build = flatten(params)
    live = [p.detach().requires_grad_(True) for p in leaves]
    loss, parts = loss_fn(build(live), cfg, batch)
    grads = torch.autograd.grad(loss, live, materialize_grads=True)
    return (loss.detach(), {k: v.detach() for k, v in parts.items()},
            build(list(grads)))


def _split_microbatch(batch: Dict, n: int, i: int) -> Dict:
    def slc(x):
        mb = x.shape[0] // n
        return x[i * mb:(i + 1) * mb]
    return {k: slc(v) for k, v in batch.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig,
                    microbatches: int = 1, **apply_kw):
    """Returns train_step(state, batch) -> (state, metrics).

    state = {"params": ..., "opt": ...}, updated in place
    (``adamw_update``); batch contains "labels" plus model inputs.  With
    microbatches > 1, gradients are accumulated over equal slices of the
    (global) batch dimension, and the metrics report ``ce`` as the mean
    total loss and ``aux`` as 0, as the reference does.  ``apply_kw``
    (``q_chunk``, ``kv_chunk``, xlstm's ``chunk``) are the reference's XLA
    chunk settings; the port's ``apply`` takes none, so they are accepted
    and dropped."""
    del apply_kw

    def train_step(state, batch):
        params = state["params"]
        if microbatches == 1:
            loss, parts, grads = loss_and_grads(params, cfg, batch)
        else:
            leaves, build = flatten(params)
            acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                   for p in leaves]
            loss = acc[0].new_zeros(())
            for i in range(microbatches):
                mb = _split_microbatch(batch, microbatches, i)
                mb_loss, _, g = loss_and_grads(params, cfg, mb)
                for a, gi in zip(acc, flatten(g)[0]):
                    a.add_(gi.float())
                loss = loss + mb_loss
            grads = build([a.div_(microbatches) for a in acc])
            loss = loss / microbatches
            parts = {"ce": loss, "aux": torch.zeros_like(loss)}
        new_params, new_opt, om = adamw_update(opt_cfg, params, grads,
                                               state["opt"])
        metrics = {"loss": loss, **parts, **om}
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


def init_state(cfg: ModelConfig, generator: torch.Generator,
               device: torch.device | str) -> Dict[str, Any]:
    params = registry.init(cfg, generator, device)
    return {"params": params, "opt": init_opt_state(params)}
