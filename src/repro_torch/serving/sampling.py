"""Token sampling: greedy / temperature / top-p (nucleus).

Port of ``repro.serving.sampling``.  Greedy is the first index of the
maximum (``torch.argmax``, like ``jnp.argmax``) with padded vocab entries
masked, so greedy streams match the reference token for token.  Sampling
at temperature > 0 draws from a ``torch.Generator``; it cannot give
``jax.random``'s bits, so it is held to the reference by distribution
only.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def masked_logits(logits: torch.Tensor,
                  vocab_size: Optional[int]) -> torch.Tensor:
    """float32 logits with padded vocab entries (>= vocab_size) at -1e30."""
    lg = logits.float()
    if vocab_size is not None and vocab_size < lg.shape[-1]:
        lg = lg.clone()
        lg[..., vocab_size:] = -1e30
    return lg


def sample(generator: Optional[torch.Generator], logits: torch.Tensor,
           temperature: Union[float, torch.Tensor] = 0.0, top_p: float = 1.0,
           vocab_size: Optional[int] = None) -> torch.Tensor:
    """logits: (B, 1, V) -> tokens (B, 1) int64.

    ``temperature`` is a scalar or a (B,) tensor; rows at temperature <= 0
    decode greedily."""
    lg = masked_logits(logits[:, -1], vocab_size)
    greedy = torch.argmax(lg, dim=-1)[:, None]
    if isinstance(temperature, (int, float)):
        if temperature <= 0.0:
            return greedy
        temperature = torch.full((lg.shape[0],), float(temperature))
    temp = torch.as_tensor(temperature, dtype=torch.float32,
                           device=lg.device).reshape(-1)
    is_greedy = temp <= 0.0
    lg = lg / torch.where(is_greedy, torch.ones_like(temp), temp)[:, None]
    if top_p < 1.0:
        sorted_lg = torch.sort(lg, dim=-1, descending=True).values
        cum = torch.cumsum(torch.softmax(sorted_lg, dim=-1), dim=-1)
        # smallest set with cumulative probability >= top_p.  Where the
        # float32 sum never reaches top_p the count is V: the reference's
        # take_along_axis then reads NaN and masks nothing; the index is
        # clamped to V - 1, whose cutoff (the smallest logit) masks nothing
        cutoff_idx = torch.sum(cum < top_p, dim=-1, keepdim=True).clamp(
            max=lg.shape[-1] - 1)
        cutoff = torch.gather(sorted_lg, -1, cutoff_idx)
        lg = torch.where(lg < cutoff, torch.full_like(lg, -1e30), lg)
    drawn = torch.multinomial(torch.softmax(lg, dim=-1), 1,
                              generator=generator)
    return torch.where(is_greedy[:, None], greedy, drawn)
