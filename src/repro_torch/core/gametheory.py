"""Game-theoretic stake dynamics (paper section 5) on tensors.

Port of ``repro.core.gametheory``: the continuous-time system of
Assumptions 5.1-5.4,

    p_i      = s_i / sum_j s_j                  (PoS selection prob.)
    Qbar     = sum_i p_i q_i                    (selection-weighted quality)
    Q_i      = (1 + q_i - Qbar) / 2             (duel win probability)
    Delta_i  = (R - c_i) + p_d [Q_i R_add - (1 - Q_i) P]   (Lemma 5.5)
    ds_i/dt  = eta lam p_i Delta_i              (Assumption 5.4)

and the induced share dynamics of Proposition 5.6,

    dp_i/dt = eta lam / S * p_i (Delta_i - Deltabar),
    Deltabar = sum_j p_j Delta_j.

``integrate`` takes RK4 steps in a loop (the reference scans them), in
float32 on the device of the stakes; stakes are floored at 1e-9 after
each step.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class GameParams(NamedTuple):
    q: torch.Tensor     # (N,) intrinsic quality q_i in [0, 1]
    c: torch.Tensor     # (N,) per-request cost c_i > 0
    lam: float = 10.0   # delegated request arrival rate
    R: float = 1.0      # base reward
    p_d: float = 0.1    # duel rate
    R_add: float = 0.5  # duel winner bonus
    P: float = 0.5      # duel loser penalty
    eta: float = 0.05   # stake growth constant


def payoff_delta(params: GameParams, s: torch.Tensor) -> torch.Tensor:
    """Delta_i(t) of Lemma 5.5 given current stakes s (N,)."""
    p = s / torch.sum(s)
    q_bar = torch.sum(p * params.q)
    q_i = 0.5 * (1.0 + params.q - q_bar)
    return (params.R - params.c) + params.p_d * (
        q_i * params.R_add - (1.0 - q_i) * params.P)


def stake_rhs(params: GameParams, s: torch.Tensor) -> torch.Tensor:
    """ds/dt = eta lam p_i Delta_i (Assumption 5.4 + Lemma 5.5)."""
    p = s / torch.sum(s)
    return params.eta * params.lam * p * payoff_delta(params, s)


def share_rhs(params: GameParams, s: torch.Tensor) -> torch.Tensor:
    """Analytic dp_i/dt of Proposition 5.6 (for verification)."""
    S = torch.sum(s)
    p = s / S
    delta = payoff_delta(params, s)
    delta_bar = torch.sum(p * delta)
    return params.eta * params.lam / S * p * (delta - delta_bar)


def integrate(params: GameParams, s0: torch.Tensor, dt: float = 0.05,
              steps: int = 2000) -> Tuple[torch.Tensor, torch.Tensor]:
    """RK4 integration; returns (stake trajectory, share trajectory), each
    (steps, N) float32."""
    s = s0.to(torch.float32)
    traj = s.new_empty((steps,) + tuple(s.shape))
    for t in range(steps):
        k1 = stake_rhs(params, s)
        k2 = stake_rhs(params, s + 0.5 * dt * k1)
        k3 = stake_rhs(params, s + 0.5 * dt * k2)
        k4 = stake_rhs(params, s + dt * (k3))
        s = s + dt / 6.0 * (k1 + 2 * k2 + 2 * k3 + k4)
        s = torch.clamp(s, min=1e-9)      # stakes are nonnegative
        traj[t] = s
    shares = traj / torch.sum(traj, dim=-1, keepdim=True)
    return traj, shares


def group_share(shares: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """p_H(t) for a subset H (Proposition 5.7)."""
    return torch.sum(torch.where(mask, shares, 0.0), dim=-1)


def verify_proposition_56(params: GameParams, s: torch.Tensor,
                          dt: float = 1e-4) -> float:
    """Max abs error between analytic dp/dt and finite-difference dp/dt."""
    p0 = s / torch.sum(s)
    s1 = s + dt * stake_rhs(params, s)
    p1 = s1 / torch.sum(s1)
    fd = (p1 - p0) / dt
    an = share_rhs(params, s)
    return float(torch.max(torch.abs(fd - an)))
