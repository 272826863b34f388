"""The port's section 5 modules: ``repro_torch.core.gametheory`` and
``repro_torch.core.creditsim``.

Mirrors ``tests/test_gametheory.py`` (the payoff formula, the analytic
share derivative against the finite difference, shares summing to one,
the high-quality group's share growing, equal quality staying balanced,
the Monte Carlo agreeing with the ODE), and adds:

* Proposition 5.6 by ``torch.autograd``: the share map's Jacobian times
  ``stake_rhs`` equals ``share_rhs`` in float64;
* ``integrate`` against the reference's at float32, within 1e-5 of the
  largest stake over 2000 RK4 steps;
* ``creditsim`` held by distribution, not by draws (the port draws from a
  ``torch.Generator``, the reference from ``jax.random``): PoS picks in
  proportion to stake, the duel share, and each node's duel win rate over
  a few seeds against the reference's, within binomial bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import creditsim as jcs
from repro.core import gametheory as jgt
from repro_torch.core.creditsim import CreditSimParams, _pos_pick, simulate
from repro_torch.core.gametheory import (GameParams, group_share, integrate,
                                         payoff_delta, share_rhs, stake_rhs,
                                         verify_proposition_56)

STAKE_REL = 1e-5


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _params(q, p_d=0.3, dtype=torch.float32):
    q = torch.as_tensor(q, dtype=dtype)
    return GameParams(q=q, c=torch.full(q.shape, 0.3, dtype=dtype), p_d=p_d,
                      R_add=1.0, P=1.0)


class TestLemma55:
    def test_payoff_formula(self):
        p = _params([0.8, 0.2])
        d = payoff_delta(p, torch.tensor([1.0, 1.0]))
        # Qbar = 0.5; Q_hi = 0.5(1+0.8-0.5)=0.65; Delta = (1-0.3)+0.3(0.65-0.35)
        assert float(d[0]) == pytest.approx(0.7 + 0.3 * (0.65 - 0.35))
        assert float(d[1]) == pytest.approx(0.7 + 0.3 * (0.35 - 0.65))


class TestProp56:
    @given(st.lists(st.floats(0.05, 0.95), min_size=2, max_size=8),
           st.floats(0.5, 5.0))
    @settings(max_examples=25, deadline=None)
    def test_analytic_equals_finite_difference(self, qs, s0):
        p = _params(qs)
        err = verify_proposition_56(p, torch.full((len(qs),), s0))
        assert err < 1e-2

    def test_analytic_equals_autograd(self):
        """dp/dt = (dp/ds) ds/dt, the Jacobian-vector product by autograd,
        in float64."""
        p = _params([0.9, 0.55, 0.3, 0.1], p_d=0.4, dtype=torch.float64)
        s = torch.tensor([1.0, 2.5, 0.7, 3.0], dtype=torch.float64)
        _, dp = torch.autograd.functional.jvp(lambda x: x / x.sum(), s,
                                              stake_rhs(p, s))
        torch.testing.assert_close(dp, share_rhs(p, s), rtol=1e-12,
                                   atol=1e-15)

    def test_shares_sum_invariant(self):
        p = _params([0.9, 0.5, 0.1])
        rhs = share_rhs(p, torch.tensor([1.0, 2.0, 3.0]))
        assert float(rhs.sum()) == pytest.approx(0.0, abs=1e-7)


class TestThm58:
    def test_high_quality_group_share_increases(self):
        p = _params([0.9, 0.8, 0.2, 0.1], p_d=0.5)
        _, shares = integrate(p, torch.ones(4), dt=0.1, steps=5000)
        hi = p.q > 0.5
        traj = [float(group_share(shares[i], hi))
                for i in range(0, 5000, 250)]
        assert all(np.diff(traj) > -1e-6)
        assert traj[-1] > 0.8

    def test_equal_quality_stays_balanced(self):
        p = _params([0.5, 0.5, 0.5, 0.5])
        _, shares = integrate(p, torch.ones(4), steps=1000)
        np.testing.assert_allclose(shares[-1].numpy(), 0.25, atol=1e-4)

    def test_montecarlo_agrees_with_ode(self):
        q = torch.tensor([0.85, 0.75, 0.25, 0.15])
        cp = CreditSimParams(q=q, c=torch.full((4,), 0.3), p_d=0.5,
                             R_add=1.0, P=1.0)
        traj, wins, duels = simulate(cp, torch.ones(4) * 10.0,
                                     torch.Generator().manual_seed(0),
                                     steps=1200)
        sh = (traj[-1] / traj[-1].sum()).numpy()
        assert sh[:2].sum() > 0.75
        wr = wins.numpy() / np.maximum(duels.numpy(), 1)
        assert wr[0] > wr[3]
        assert traj.dtype == torch.float32 and traj.shape == (1200, 4)
        assert wins.dtype == duels.dtype == torch.int32


def test_integrate_matches_reference():
    q = [0.9, 0.7, 0.4, 0.2, 0.05]
    pj = jgt.GameParams(q=jnp.asarray(q), c=jnp.full((5,), 0.3), p_d=0.5,
                        R_add=1.0, P=1.0)
    s0 = np.array([1.0, 2.0, 0.5, 1.5, 3.0], np.float32)
    traj_j, shares_j = jgt.integrate(pj, jnp.asarray(s0), dt=0.05,
                                     steps=2000)
    traj_t, shares_t = integrate(_params(q, p_d=0.5), torch.from_numpy(s0),
                                 dt=0.05, steps=2000)
    assert traj_t.dtype == torch.float32 and traj_t.shape == (2000, 5)
    traj_j = np.asarray(traj_j)
    np.testing.assert_array_less(np.abs(traj_t.numpy() - traj_j),
                                 STAKE_REL * traj_j.max())
    np.testing.assert_allclose(shares_t.numpy(), np.asarray(shares_j),
                               atol=1e-5)


def test_pos_picks_follow_stake():
    stakes = torch.tensor([1.0, 3.0, 0.0, 6.0])
    n = 40_000
    picks = _pos_pick(torch.Generator().manual_seed(1), stakes, n)
    freq = np.bincount(picks.numpy(), minlength=4) / n
    want = np.array([0.1, 0.3, 0.0, 0.6])
    sd = np.sqrt(want * (1 - want) / n)
    np.testing.assert_array_less(np.abs(freq - want), 5 * sd + 1e-12)


def test_duel_counts_and_win_rates_match_reference_in_distribution():
    """Over 6 seeds, each package's duel share is p_d and each node's duel
    win rate agrees with the reference's within 5 binomial standard
    deviations of their difference."""
    q = [0.85, 0.75, 0.25, 0.15]
    s0 = np.full(4, 10.0, np.float32)
    kw = dict(p_d=0.5, R_add=1.0, P=1.0)
    steps, m = 300, 32
    tw = np.zeros(4)
    td = np.zeros(4)
    jw = np.zeros(4)
    jd = np.zeros(4)
    for seed in range(6):
        _, w, d = simulate(CreditSimParams(q=torch.tensor(q),
                                           c=torch.full((4,), 0.3), **kw),
                           torch.from_numpy(s0),
                           torch.Generator().manual_seed(seed), steps=steps,
                           requests_per_step=m)
        tw += w.numpy()
        td += d.numpy()
        _, w, d = jcs.simulate(jcs.CreditSimParams(
            q=jnp.asarray(q), c=jnp.full((4,), 0.3), **kw), jnp.asarray(s0),
            jax.random.PRNGKey(seed), steps=steps, requests_per_step=m)
        jw += np.asarray(w)
        jd += np.asarray(d)
    for wins, duels in ((tw, td), (jw, jd)):
        # each duel counts on two nodes
        n_duels = duels.sum() / 2
        n_req = 6 * steps * m
        sd = np.sqrt(0.5 * 0.5 / n_req)
        assert abs(n_duels / n_req - 0.5) < 5 * sd
        assert wins.sum() == n_duels
    for i in range(4):
        pt, pj = tw[i] / td[i], jw[i] / jd[i]
        sd = np.sqrt(pt * (1 - pt) / td[i] + pj * (1 - pj) / jd[i])
        assert abs(pt - pj) < 5 * sd + 1e-9, (i, pt, pj, sd)
