"""Stochastic credit dynamics on tensors: the Monte Carlo counterpart of
``gametheory``.

Port of ``repro.core.creditsim``: at every step a batch of delegated
requests arrives; executors and their rivals are picked by PoS, each in
proportion to stake (with replacement); a fraction ``p_d`` become duels
whose winners follow Assumption 5.3's pairwise win probability; stakes
move by base reward, cost, bonus and penalty.  The draws come from an
explicit ``torch.Generator`` on the stakes' device, so they are not the
reference's ``jax.random`` bits: the two agree in distribution only.
Several requests may land on one node in a step, and their payoffs all
count (``index_add_``, as the reference's ``.at[].add``).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CreditSimParams(NamedTuple):
    q: torch.Tensor      # (N,) latent quality
    c: torch.Tensor      # (N,) per-request cost
    R: float = 1.0
    p_d: float = 0.1
    R_add: float = 0.5
    P: float = 0.5
    restake: float = 1.0  # fraction of net payoff flowing back into stake


def _pos_pick(gen: torch.Generator, stakes: torch.Tensor,
              n: int) -> torch.Tensor:
    """Sample ``n`` independent nodes proportional to stake (floored at
    1e-9), with replacement."""
    return torch.multinomial(torch.clamp(stakes, min=1e-9), n,
                             replacement=True, generator=gen)


def _bernoulli(gen: torch.Generator, p, n: int,
               device: torch.device) -> torch.Tensor:
    """``n`` independent draws, True with probability ``p`` (a float or an
    (n,) tensor): a uniform draw below ``p``."""
    return torch.rand(n, generator=gen, device=device) < p


def simulate(params: CreditSimParams, s0: torch.Tensor,
             generator: torch.Generator, steps: int = 500,
             requests_per_step: int = 32
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (stake trajectory (steps, N) float32, duel win counts,
    duel counts (N,) int32)."""
    n_nodes, m, dev = s0.shape[0], requests_per_step, s0.device
    stakes = s0.to(torch.float32)
    wins = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    duels = torch.zeros(n_nodes, dtype=torch.int32, device=dev)
    traj = stakes.new_empty((steps, n_nodes))
    for t in range(steps):
        execs = _pos_pick(generator, stakes, m)                   # (m,)
        is_duel = _bernoulli(generator, params.p_d, m, dev)
        rivals = _pos_pick(generator, stakes, m)                  # (m,)
        # duel win prob per Assumption 5.3's pairwise form
        p_win = torch.clamp(0.5 * (1.0 + params.q[execs]
                                   - params.q[rivals]), 0, 1)
        won = _bernoulli(generator, p_win, m, dev)

        base = params.R - params.c[execs]                         # (m,)
        duel_pay = torch.where(won, params.R_add, -params.P)
        pay = base + torch.where(is_duel, duel_pay, 0.0)
        # mirror payoff for the rival in a duel
        rival_pay = torch.where(is_duel,
                                (params.R - params.c[rivals])
                                + torch.where(won, -params.P, params.R_add),
                                0.0)

        d_stake = (stakes.new_zeros(n_nodes)
                   .index_add_(0, execs, params.restake * pay)
                   .index_add_(0, rivals, params.restake * rival_pay))
        stakes = torch.clamp(stakes + d_stake, min=1e-6)

        wins.index_add_(0, execs, (is_duel & won).to(torch.int32))
        wins.index_add_(0, rivals, (is_duel & ~won).to(torch.int32))
        duels.index_add_(0, execs, is_duel.to(torch.int32))
        duels.index_add_(0, rivals, is_duel.to(torch.int32))
        traj[t] = stakes
    return traj, wins, duels
