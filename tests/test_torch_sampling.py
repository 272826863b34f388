"""Top-p (nucleus) sampling of the port against the JAX reference.

``repro_torch.serving.sampling.sample`` draws from a ``torch.Generator``
and the reference ``repro.serving.sampling.sample`` from ``jax.random``,
so the two are held to each other by distribution: the same numpy logits
(fixed seeds), one row repeated ``N`` times so that each call makes ``N``
independent draws, go through both.  Every draw of either must lie in the
nucleus, every token the nucleus gives an expected count of 20 or more
must be drawn by both, and the two histograms must agree within the
bounds stated below.  ``top_p = 0.99999999`` is 1.0 in float32, which
the float32 cumulative sum may never reach: the reference then reads
past the sorted logits (NaN) and masks nothing, and the port must draw
from the whole vocabulary too instead of raising.
"""

import numpy as np
import pytest
import torch

from repro_torch.serving.sampling import sample

N = 20000        # draws per call: one logit row repeated N times
V = 64
TEMPERATURE = 0.7
# two-sample bounds over N draws each.  Total variation between two
# samples of one distribution over k tokens is about sqrt(k / (pi N)), at
# most 0.032 here (k <= 64); the bound is twice that.  The two-sample
# chi-square statistic sum (a - b)^2 / (a + b) over the k tokens drawn is
# chi-square with k - 1 degrees of freedom; its bound is the 1e-6 upper
# quantile, so a fault that moves a token's share by a few percent of it
# fails while chance does not
TV_BOUND = 0.064
CHI2_P = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _logits(seed, v=V):
    rng = np.random.default_rng(seed)
    return (2.0 * rng.standard_normal((1, 1, v))).astype(np.float32)


def _nucleus(logits, temperature, top_p):
    """The tokens top-p keeps and their probabilities, by the reference's
    rule in float32: sort descending, cumulate the softmax, keep every
    logit >= the one at the count of sums below top_p (no mask when the
    count is V)."""
    lg = logits[0, 0] / np.float32(temperature)
    order = np.sort(lg)[::-1]
    p = np.exp(order - order[0])
    cum = np.cumsum((p / p.sum()).astype(np.float32), dtype=np.float32)
    idx = int(np.sum(cum < np.float32(top_p)))
    keep = (lg >= order[idx]) if idx < lg.size else np.ones_like(lg, bool)
    w = np.where(keep, np.exp(lg - lg.max()), 0.0)
    return keep, w / w.sum()


def _draws(logits, temperature, top_p, seed):
    import jax
    import jax.numpy as jnp
    from repro.serving.sampling import sample as jax_sample
    rows = np.repeat(logits, N, axis=0)
    mine = sample(torch.Generator().manual_seed(seed), torch.from_numpy(rows),
                  temperature, top_p=top_p)
    ref = jax_sample(jax.random.PRNGKey(seed), jnp.asarray(rows), temperature,
                     top_p=top_p)
    return mine.numpy().ravel(), np.asarray(ref).ravel()


@pytest.mark.parametrize("top_p", [0.3, 0.8, 0.95, 0.99999999])
@pytest.mark.parametrize("seed", [0, 1])
def test_top_p_draws_match_the_reference_by_distribution(top_p, seed):
    from scipy.stats import chi2
    logits = _logits(seed)
    keep, probs = _nucleus(logits, TEMPERATURE, top_p)
    mine, ref = _draws(logits, TEMPERATURE, top_p, seed)
    assert mine.shape == ref.shape == (N,)
    for draws in (mine, ref):
        assert keep[draws].all(), sorted(set(draws[~keep[draws]].tolist()))
    common = np.flatnonzero(probs * N >= 20)
    for draws in (mine, ref):
        assert set(common.tolist()) <= set(draws.tolist())
    a = np.bincount(mine, minlength=V).astype(np.float64)
    b = np.bincount(ref, minlength=V).astype(np.float64)
    tv = 0.5 * np.abs(a - b).sum() / N
    seen = (a + b) > 0
    stat = float((((a - b) ** 2)[seen] / (a + b)[seen]).sum())
    bound = float(chi2.isf(CHI2_P, max(1, int(seen.sum()) - 1)))
    assert tv <= TV_BOUND, (tv, TV_BOUND)
    assert stat <= bound, (stat, bound)


def test_top_p_near_one_draws_where_the_reference_draws():
    """The (4, 1, 1000) case: at top_p 0.99999999 (1.0 in float32) the
    reference returns a token per row, and the port must too, each a
    token of the vocabulary."""
    import jax
    import jax.numpy as jnp
    from repro.serving.sampling import sample as jax_sample
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((4, 1, 1000)).astype(np.float32)
    ref = np.asarray(jax_sample(jax.random.PRNGKey(0), jnp.asarray(logits),
                                1.0, top_p=0.99999999))
    mine = sample(torch.Generator().manual_seed(0), torch.from_numpy(logits),
                  1.0, top_p=0.99999999)
    assert ref.shape == tuple(mine.shape) == (4, 1)
    assert ((mine >= 0) & (mine < 1000)).all()
    # no mask: the whole vocabulary stays drawable, as in the reference
    keep, _ = _nucleus(logits[:1], 1.0, 0.99999999)
    assert keep.sum() >= 999


def test_greedy_rows_of_a_top_p_batch_match_the_reference():
    """A (B,) temperature vector with greedy rows (<= 0): those rows take
    the argmax in both, whatever top_p does to the sampled rows."""
    import jax
    import jax.numpy as jnp
    from repro.serving.sampling import sample as jax_sample
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((6, 1, V)).astype(np.float32)
    temp = np.asarray([0.0, 0.8, -1.0, 1.2, 0.0, 0.5], np.float32)
    mine = sample(torch.Generator().manual_seed(1), torch.from_numpy(logits),
                  torch.from_numpy(temp), top_p=0.9).numpy()
    ref = np.asarray(jax_sample(jax.random.PRNGKey(1), jnp.asarray(logits),
                                jnp.asarray(temp), top_p=0.9))
    greedy = temp <= 0
    want = logits[:, 0].argmax(-1)[:, None]
    np.testing.assert_array_equal(mine[greedy], want[greedy])
    np.testing.assert_array_equal(ref[greedy], want[greedy])
    for i in np.flatnonzero(~greedy):
        keep, _ = _nucleus(logits[i:i + 1], float(temp[i]), 0.9)
        assert keep[mine[i, 0]] and keep[ref[i, 0]]
