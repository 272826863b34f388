"""Port slot engine vs ``repro.serving.Engine`` (``paged=False``; CPU, fp32).

Both engines serve the same requests on bridged weights: greedy token
streams must be identical and so must the engines' counters, with
continuous batching, with wave batching (``continuous=False``) and when a
queued request needs a bigger cache than the resident ones (the cache grows
only once the batch drains).  The executors' load snapshots must agree
field by field while both are stepped in lockstep.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro.serving import Engine as JEngine
from repro.serving import EngineExecutor as JEngineExecutor
from repro.serving import GenRequest as JGenRequest
from repro_torch.configs import get_config
from repro_torch.models import bridge
from repro_torch.serving import Engine, EngineExecutor, GenRequest

STAT_FIELDS = ("served", "prefill_tokens", "decode_tokens", "batches",
               "decode_steps", "peak_resident")


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(1), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _reqs(cls, seed, n, max_prompt=24, max_new=(2, 10)):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, max_prompt + 1))
        out.append(cls(rid=f"r{i}",
                       tokens=rng.integers(2, 400, size=plen).astype(np.int32),
                       max_new=int(rng.integers(*max_new) + 1)))
    return out


@pytest.mark.parametrize("kw,seed,n,max_new", [
    (dict(max_batch=3, bucket=16), 5, 7, (2, 10)),
    # wave batching: refill only when the batch is empty
    (dict(max_batch=3, bucket=16, continuous=False), 6, 5, (2, 10)),
    # budgets from 2 to 40 tokens: the 32-token cache must grow
    (dict(max_batch=2, bucket=16, capacity=32), 8, 5, (1, 40)),
])
def test_greedy_streams_match_reference(setup, kw, seed, n, max_new):
    cfg_j, cfg_t, pj, pt = setup
    ej = JEngine(cfg_j, pj, **kw)
    et = Engine(cfg_t, pt, **kw)
    rj = ej.serve(_reqs(JGenRequest, seed, n, max_new=max_new))
    rt = et.serve(_reqs(GenRequest, seed, n, max_new=max_new))
    for a, b in zip(rj, rt):
        assert a.rid == b.rid
        np.testing.assert_array_equal(b.result, a.result, err_msg=a.rid)
    for f in STAT_FIELDS:
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert et.load_snapshot() == ej.load_snapshot()
    assert not et.paged and et._capacity == ej._capacity


def test_executor_load_matches_reference_in_lockstep(setup):
    cfg_j, cfg_t, pj, pt = setup
    kw = dict(max_batch=2, bucket=16)
    xj = JEngineExecutor(JEngine(cfg_j, pj, **kw), gate_on_pages=True,
                         max_pending_tokens=80)
    xt = EngineExecutor(Engine(cfg_t, pt, **kw), gate_on_pages=True,
                        max_pending_tokens=80)
    done_j, done_t = [], []
    xj.bind(None, lambda r, st, ft: done_j.append(r.rid))
    xt.bind(None, lambda r, st, ft: done_t.append(r.rid))
    admitted = [(xj.admit(a), xt.admit(b)) for a, b in zip(
        _reqs(JGenRequest, 12, 6), _reqs(GenRequest, 12, 6))]
    assert all(a == b for a, b in admitted)
    assert not all(a for a, _ in admitted)     # the pending gate pushed back
    assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
    while xj.has_work() or xt.has_work():
        assert xj.has_work() and xt.has_work()
        xj.step()
        xt.step()
        assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
        assert xt.n_active == xj.n_active
    assert done_t == done_j
    assert 0 < xt.estimate(24, 8) < float("inf")
