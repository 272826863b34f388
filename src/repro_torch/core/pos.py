"""Proof-of-Stake executor / judge sampling (paper §3.2, §4.2, Assumption 5.3).

Selection probability of node i is s_i / sum_j s_j over the eligible set.
Sampling is without replacement for multi-winner draws (duel executors,
judges), matching "two executors sampled via our PoS-based selection" +
"k judges (also selected via PoS)".
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def selection_probs(stakes: Dict[str, float], eligible: Sequence[str]) -> Dict[str, float]:
    w = {n: max(0.0, stakes.get(n, 0.0)) for n in eligible}
    tot = sum(w.values())
    if tot <= 0.0:
        # degenerate: uniform over eligible (no stake anywhere)
        return {n: 1.0 / len(eligible) for n in eligible} if eligible else {}
    return {n: w[n] / tot for n in w}


def pos_sample(stakes: Dict[str, float], eligible: Sequence[str],
               k: int, rng: np.random.Generator,
               exclude: Sequence[str] = ()) -> List[str]:
    """Draw up to ``k`` distinct nodes, probability proportional to stake."""
    pool = [n for n in eligible if n not in set(exclude)]
    out: List[str] = []
    while pool and len(out) < k:
        probs = selection_probs(stakes, pool)
        names = list(probs)
        p = np.asarray([probs[n] for n in names])
        p = p / p.sum()
        pick = names[int(rng.choice(len(names), p=p))]
        out.append(pick)
        pool.remove(pick)
    return out


def pos_sample_one(stakes: Dict[str, float], eligible: Sequence[str],
                   rng: np.random.Generator,
                   exclude: Sequence[str] = ()) -> Optional[str]:
    got = pos_sample(stakes, eligible, 1, rng, exclude)
    return got[0] if got else None
