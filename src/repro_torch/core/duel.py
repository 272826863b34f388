"""Duel-and-judge mechanism (paper §4.2, Figure 3).

A fraction p_d of delegated requests becomes a *duel*: two PoS-sampled
executors both answer; k PoS-sampled judges compare the two responses
pairwise; majority decides.  The loser is slashed P from its stake, the winner
earns R_add, each voting judge earns a judge fee.  The outcome is recorded on
the credit ledger (broadcast as a block in the full-chain path).

Quality model (Assumption 5.3): executor i with latent quality q_i beats j
with probability  P(i > j) = 1/2 (1 + q_i - q_j)  — this is the pairwise form
whose selection-weighted aggregate gives Q_i = 1/2 (1 + q_i - Q̄).  Judges
observe the true winner with accuracy ``judge_accuracy`` (noisy comparisons).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.ledger import CreditOp


@dataclass(frozen=True)
class DuelParams:
    p_d: float = 0.1          # duel rate over delegated requests
    k_judges: int = 2         # judges per duel (paper ablation uses k=2)
    r_add: float = 0.5        # winner bonus
    penalty: float = 0.5      # loser stake slash P
    judge_fee: float = 0.1    # per-judge reward for correct-majority service
    judge_accuracy: float = 0.9


@dataclass(frozen=True)
class DuelOutcome:
    duel_id: str
    executor_a: str
    executor_b: str
    judges: Tuple[str, ...]
    votes_a: int
    winner: str
    loser: str
    ops: Tuple[CreditOp, ...]


def true_win_prob(q_a: float, q_b: float) -> float:
    """P(a beats b) = 1/2 (1 + q_a - q_b), clipped to [0, 1]."""
    return float(np.clip(0.5 * (1.0 + q_a - q_b), 0.0, 1.0))


def run_duel(duel_id: str, executor_a: str, executor_b: str,
             judges: Sequence[str], q: Dict[str, float],
             params: DuelParams, rng: np.random.Generator,
             treasury: str = "__treasury__") -> DuelOutcome:
    """Resolve one duel and emit the ledger ops that settle it.

    The winner bonus and judge fees are funded by the treasury (system mint
    account); the loser penalty is a stake slash (burned), exactly matching
    the paper's 'additional reward R_add' / 'penalty P' accounting in §5.
    """
    p_a = true_win_prob(q.get(executor_a, 0.5), q.get(executor_b, 0.5))
    true_winner = executor_a if rng.random() < p_a else executor_b

    votes_a = 0
    for _ in judges:
        correct = rng.random() < params.judge_accuracy
        vote = true_winner if correct else (
            executor_b if true_winner == executor_a else executor_a)
        votes_a += int(vote == executor_a)

    winner = executor_a if votes_a * 2 > len(judges) else (
        executor_b if votes_a * 2 < len(judges) else true_winner)  # tie → truth
    loser = executor_b if winner == executor_a else executor_a

    ops: List[CreditOp] = [
        CreditOp("transfer", treasury, winner, params.r_add, ref=duel_id),
        CreditOp("slash", loser, "", params.penalty, ref=duel_id),
    ]
    ops += [CreditOp("transfer", treasury, j, params.judge_fee, ref=duel_id)
            for j in judges]
    return DuelOutcome(duel_id, executor_a, executor_b, tuple(judges),
                       votes_a, winner, loser, tuple(ops))


def expected_extra_requests(n_requests: int, alpha: float, p_d: float,
                            k: int) -> float:
    """Paper §7.1: expected duel overhead = N · α · p_d · (1 + k)."""
    return n_requests * alpha * p_d * (1 + k)
