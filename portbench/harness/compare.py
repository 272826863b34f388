"""The comparison that decides ``correct`` for a served model: by how much
a served (greedy) token's reference logit lies below the reference's best
at that position, in standard deviations of that position's reference
logits, taken as the widest over every served token of the sample."""

from __future__ import annotations

from typing import Sequence

import torch


def gaps_sd(ref_logits: torch.Tensor, tokens: Sequence[int]) -> torch.Tensor:
    """(n,) gaps: ``(max(ref[i]) - ref[i, tokens[i]]) / std(ref[i])``;
    ``ref_logits`` (n, V) float32.  A token outside the vocabulary has no
    reference logit and reads infinite."""
    ref = ref_logits.float()
    t = torch.as_tensor(list(tokens), dtype=torch.long, device=ref.device)
    inside = (t >= 0) & (t < ref.shape[1])
    picked = ref.gather(1, t.clamp(0, ref.shape[1] - 1)[:, None])[:, 0]
    gap = (ref.max(dim=1).values - picked) / ref.std(dim=1)
    return torch.where(inside, gap, torch.full_like(gap, float("inf")))


def first_choice_gaps_sd(ref_logits: torch.Tensor,
                         other_logits: torch.Tensor) -> torch.Tensor:
    """The gaps of the token that ``other_logits`` puts first at each
    position (the control's reading: no decoding needed)."""
    return gaps_sd(ref_logits, other_logits.argmax(dim=1).tolist())
