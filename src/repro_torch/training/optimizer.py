"""AdamW on tensors: decoupled weight decay and bias correction.

Port of ``repro.training.optimizer``, leaf by leaf in the same order and
the same float32 arithmetic.  One thing differs in form only: the update
is in place.  Each param and its float32 moments ``mu`` and ``nu`` are
overwritten (``adamw_update`` returns the same param tree and moment
tensors), so a train state needs no second copy of itself -- what lets a
full-width model train on one card.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Tuple

import torch

from repro_torch.training.tree import flatten, leaves


class AdamWConfig(NamedTuple):
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1


def lr_schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup then cosine decay to min_lr_ratio * lr (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos
    return cfg.lr * torch.clamp(warm, max=1.0) * decay


def init_opt_state(params) -> Dict[str, Any]:
    """float32 first and second moments whatever the param dtype, and an
    int32 step count, on the params' device."""
    ps, build = flatten(params)

    def zeros():
        return build([torch.zeros_like(p, dtype=torch.float32)
                      for p in ps])

    return {"mu": zeros(), "nu": zeros(),
            "step": torch.zeros((), dtype=torch.int32, device=ps[0].device)}


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in leaves(tree)))


def _update(p, g, mu, nu, *, cfg, scale, lr, bc1, bc2, decay) -> None:
    """One AdamW step of one leaf, in place."""
    g = g.float() * scale
    mu.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
    nu.mul_(cfg.b2).addcmul_(g, g, value=1 - cfg.b2)
    del g
    update = (mu / bc1).div_(torch.sqrt(nu / bc2).add_(cfg.eps))
    p32 = p.float()
    if decay:
        update = update + cfg.weight_decay * p32
    p.copy_(p32 - lr * update)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, state
                 ) -> Tuple[Any, Dict[str, Any], Dict[str, torch.Tensor]]:
    """One AdamW step.  Returns (params, new_state, metrics): the params
    and the moments are updated in place; the step count is a new tensor.
    Clip by global norm, then bias correction in float32; decay applies
    to every leaf with ``ndim >= 2`` -- the stacked norm scales and
    biases (L, d) too -- and not to unstacked vectors."""
    step = state["step"] + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = lr_schedule(cfg, step)
    bc1 = 1 - cfg.b1 ** step.float()
    bc2 = 1 - cfg.b2 ** step.float()
    for p, g, mu, nu in zip(leaves(params), leaves(grads),
                            leaves(state["mu"]), leaves(state["nu"])):
        _update(p, g, mu, nu, cfg=cfg, scale=scale, lr=lr, bc1=bc1,
                bc2=bc2, decay=p.ndim >= 2)
    return (params, {"mu": state["mu"], "nu": state["nu"], "step": step},
            {"grad_norm": gnorm, "lr": lr})
