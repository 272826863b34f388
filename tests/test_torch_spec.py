"""Port speculative engine vs ``repro.serving.Engine(spec_draft=...)``
(CPU, fp32).

Both engines serve the same requests on bridged weights, the target's and
the draft's: greedy streams must be identical, and so must the
speculative counters (drafted, accepted, the accepted-length histogram),
with a draft that always agrees (the target itself), with the reference's
disagreeing ``cfg.draft()`` sibling, and with a pool so small that LIFO
preemption re-prefills the draft's rows.  The speculative streams must
also equal the plain paged engine's, and ``SpecEngineExecutor.load()``
must equal the reference's while both are stepped in lockstep.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro.serving import Engine as JEngine
from repro.serving import GenRequest as JGenRequest
from repro.serving import SpecEngineExecutor as JSpecEngineExecutor
from repro_torch.configs import get_config
from repro_torch.models import bridge
from repro_torch.serving import Engine, GenRequest, SpecEngineExecutor

STAT_FIELDS = ("served", "prefill_tokens", "decode_tokens", "batches",
               "decode_steps", "peak_resident", "preempted", "spec_steps",
               "spec_drafted", "spec_accepted")


def _bridge(pj, cfg):
    return bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                  cfg, "cpu")


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(2), cfg_j)
    dj = jregistry.init(jax.random.PRNGKey(10_000), cfg_j.draft())
    return dict(cfg_j=cfg_j, cfg_t=cfg_t, pj=pj, pt=_bridge(pj, cfg_t),
                draft_j=(cfg_j.draft(), dj),
                draft_t=(cfg_t.draft(), _bridge(dj, cfg_t.draft())))


def _reqs(cls, seed, n, max_new_hi=12):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, 25))
        out.append(cls(rid=f"r{i}",
                       tokens=rng.integers(2, 400, size=plen).astype(np.int32),
                       max_new=int(rng.integers(2, max_new_hi + 1))))
    return out


def _drafts(s, agreeing):
    if agreeing:       # the target drafts for itself: every draft accepted
        return (s["cfg_j"], s["pj"]), (s["cfg_t"], s["pt"])
    return s["draft_j"], s["draft_t"]


@pytest.mark.parametrize("agreeing,kw,seed,n", [
    (True, dict(max_batch=3, bucket=16, page_size=8, spec_k=3), 5, 6),
    (False, dict(max_batch=3, bucket=16, page_size=8), 6, 6),
    # a pool too small for the load: preemption mid-verify, draft rows
    # re-prefilled on re-admission
    (True, dict(max_batch=4, bucket=16, page_size=16, num_pages=4), 7, 5),
])
def test_spec_streams_match_reference_and_plain_paged(setup, agreeing, kw,
                                                      seed, n):
    s = setup
    dj, dt = _drafts(s, agreeing)
    ej = JEngine(s["cfg_j"], s["pj"], paged=True, spec_draft=dj, **kw)
    et = Engine(s["cfg_t"], s["pt"], paged=True, spec_draft=dt, **kw)
    rj = ej.serve(_reqs(JGenRequest, seed, n))
    rt = _reqs(GenRequest, seed, n)
    for r in rt:
        et.submit(r)
    while et.has_work():
        et.step()
        et.debug_page_accounting()
    kw_plain = {k: v for k, v in kw.items() if k != "spec_k"}
    plain = Engine(s["cfg_t"], s["pt"], paged=True, **kw_plain).serve(
        _reqs(GenRequest, seed, n))
    for a, b, c in zip(rj, rt, plain):
        np.testing.assert_array_equal(b.result, a.result, err_msg=a.rid)
        np.testing.assert_array_equal(b.result, c.result, err_msg=a.rid)
    for f in STAT_FIELDS:
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert et.spec_accept_hist == ej.spec_accept_hist
    assert et.spec_alpha == pytest.approx(ej.spec_alpha, abs=1e-12)
    assert et.stats.spec_drafted > 0
    if agreeing:
        assert et.stats.spec_accepted > 0.9 * et.stats.spec_drafted
    else:
        assert et.stats.spec_accepted < et.stats.spec_drafted
    if "num_pages" in kw:
        assert et.stats.preempted > 0          # the tight pool actually bit
    assert et.debug_page_accounting() == ej.debug_page_accounting()


def test_spec_executor_load_matches_reference_in_lockstep(setup):
    s = setup
    kw = dict(max_batch=2, bucket=16, page_size=8, num_pages=8)
    xj = JSpecEngineExecutor(JEngine(s["cfg_j"], s["pj"], paged=True,
                                     spec_draft=s["draft_j"], **kw),
                             gate_on_pages=True)
    xt = SpecEngineExecutor(Engine(s["cfg_t"], s["pt"], paged=True,
                                   spec_draft=s["draft_t"], **kw),
                            gate_on_pages=True)
    done_j, done_t = [], []
    xj.bind(None, lambda r, st, ft: done_j.append(r.rid))
    xt.bind(None, lambda r, st, ft: done_t.append(r.rid))
    admitted = [(xj.admit(a), xt.admit(b)) for a, b in zip(
        _reqs(JGenRequest, 11, 4), _reqs(GenRequest, 11, 4))]
    assert all(a == b for a, b in admitted)
    assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
    while xj.has_work() or xt.has_work():
        assert xj.has_work() and xt.has_work()
        xj.step()
        xt.step()
        lj, lt = dataclasses.asdict(xj.load()), dataclasses.asdict(xt.load())
        assert lt.pop("expected_tokens_per_step") == pytest.approx(
            lj.pop("expected_tokens_per_step"), abs=1e-12)
        assert lt == lj
    assert done_t == done_j
    assert 0 < xt.estimate(24, 8) < float("inf")


def test_spec_rejects_what_the_reference_rejects(setup):
    s = setup
    with pytest.raises(ValueError, match="paged"):
        Engine(s["cfg_t"], s["pt"], spec_draft=s["draft_t"])
    with pytest.raises(ValueError, match="tokenizer"):
        Engine(s["cfg_t"], s["pt"], paged=True, spec_draft=(
            s["draft_t"][0].replace(vocab_size=256), s["draft_t"][1]))
    eng = Engine(s["cfg_t"], s["pt"], paged=True, spec_draft=s["draft_t"])
    with pytest.raises(ValueError, match="greedy"):
        eng.submit(GenRequest(rid="t", tokens=np.arange(2, 9, dtype=np.int32),
                              temperature=0.5))
    with pytest.raises(ValueError, match="spec-enabled"):
        SpecEngineExecutor(Engine(s["cfg_t"], s["pt"], paged=True))
