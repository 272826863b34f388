"""Port disaggregated prefill/decode vs ``repro`` (CPU, fp32).

Mirrors ``tests/test_disagg.py`` for the port:

1.  Sim twins -- the port's ``DisaggTokenBucketExecutor`` and
    ``SpecTokenBucketExecutor`` give the same completion times, load
    snapshots and estimates as the reference's on the same inputs.
2.  Engine parity -- ``DisaggEngineExecutor`` greedy outputs equal a
    colocated paged engine's, and the port's pair equals the reference's
    pair on bridged weights: tokens, ``handoffs`` and ``handoff_bytes``,
    including a tight decode pool that preempts, and a decode engine with
    the prefix cache whose pinned pages are neither gathered nor counted.
3.  Accounting -- ``debug_page_accounting`` holds on both engines after
    every step, and both pools drain.
4.  Sim-vs-engine admission agreement on the same decode-page budget.
5.  Preemption resets a request's clocks; completion stamps stay monotone.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core.node import QueuedRequest as JQueuedRequest
from repro.models import registry as jregistry
from repro.serving import DisaggEngineExecutor as JDisaggEngineExecutor
from repro.serving import Engine as JEngine
from repro.serving import GenRequest as JGenRequest
from repro.sim import BackendProfile as JBackendProfile
from repro.sim import DisaggTokenBucketExecutor as JDisaggBucket
from repro.sim import EventLoop as JEventLoop
from repro.sim import SpecTokenBucketExecutor as JSpecBucket
from repro.sim.workload import Request as JRequest
from repro_torch.configs import get_config
from repro_torch.core.node import QueuedRequest
from repro_torch.models import bridge
from repro_torch.serving import (DisaggEngineExecutor, Engine,
                                 EngineExecutor, GenRequest)
from repro_torch.sim import (BackendProfile, DisaggTokenBucketExecutor,
                             EventLoop, SpecTokenBucketExecutor)
from repro_torch.sim.workload import Request

PROF = dict(prefill_tps=1e4, decode_tps=100.0, saturation=2,
            max_concurrency=8, quality=0.5, kv_token_budget=4096)


# ---------------------------------------------------------------------------
# 1. sim twins
# ---------------------------------------------------------------------------

class _Harness:
    """A simulated executor on a bare loop, recording completions; built
    from either package's classes."""

    def __init__(self, side, cls, *profiles, **kw):
        (loop_cls, prof_cls, self._qr_cls, self._req_cls) = side
        self.loop = loop_cls()
        self.ex = cls(*(prof_cls(**p) for p in profiles), **kw)
        self.done = {}
        self.ex.bind(self.loop, self._cb)

    def _cb(self, qr, started_at, first_token_at):
        self.done[qr.req.rid] = (self.loop.now, started_at, first_token_at)

    def admit(self, rid, prompt, output, t=0.0):
        return self.ex.admit(self._qr_cls(
            self._req_cls(rid=rid, origin="n", arrival=t,
                          prompt_tokens=prompt, output_tokens=output,
                          slo_s=600.0),
            enqueue_time=t, delegated=False, origin_node="n"))


JAX_SIDE = (JEventLoop, JBackendProfile, JQueuedRequest, JRequest)
PORT_SIDE = (EventLoop, BackendProfile, QueuedRequest, Request)

# (admissions as (prompt, output, time), profiles, executor keywords)
DISAGG_SCENARIOS = {
    "lone": ([(200, 500, 0.0)], (PROF,), {}),
    "shared-decode": ([(100, 400, 0.0)] * 4, (PROF,), {}),
    "paged-churn": ([(p, p, 0.3 * i) for i, p in
                     enumerate((40, 300, 17, 250, 400, 64, 9, 128))],
                    (PROF,), dict(page_size=16)),
    "split-profiles": ([(1000, 200, 0.0), (500, 800, 0.1), (64, 64, 0.2)],
                       (PROF, dict(PROF, prefill_tps=2e3,
                                   kv_token_budget=1024)),
                       dict(kv_bytes_per_token=1000,
                            transfer_bytes_per_s=1e6, transfer_base_s=0.5)),
}


def _drive(side, cls, admissions, profiles, kw, probes):
    """Admit in time order, snapshot ``load()`` at each probe time, run to
    the end; returns (admit decisions, loads, estimates, completions)."""
    h = _Harness(side, cls, *profiles, **kw)
    events = sorted([(t, 0, i) for i, (_, _, t) in enumerate(admissions)]
                    + [(t, 1, None) for t in probes])
    decisions, loads, estimates = [], [], []
    for t, kind, i in events:
        h.loop.run(until=t)
        if kind == 0:
            p, o, _ = admissions[i]
            decisions.append(h.admit(f"r{i}", p, o, t))
        else:
            loads.append(dataclasses.asdict(h.ex.load()))
            estimates.append(h.ex.estimate(256, 512))
    h.loop.run()
    return decisions, loads, estimates, h.done


@pytest.mark.parametrize("name", sorted(DISAGG_SCENARIOS))
def test_disagg_sim_twin_equals_reference(name):
    admissions, profiles, kw = DISAGG_SCENARIOS[name]
    probes = (0.005, 0.05, 0.2, 1.0, 3.0, 6.0)
    ref = _drive(JAX_SIDE, JDisaggBucket, admissions, profiles, kw, probes)
    got = _drive(PORT_SIDE, DisaggTokenBucketExecutor, admissions, profiles,
                 kw, probes)
    assert got == ref
    assert len(got[3]) == sum(got[0])          # every admitted one finished


def test_disagg_sim_transfer_model_equals_reference():
    for kw in ({}, dict(kv_bytes_per_token=1000, transfer_bytes_per_s=1e6,
                        transfer_base_s=0.5)):
        a = JDisaggBucket(JBackendProfile(**PROF), **kw)
        b = DisaggTokenBucketExecutor(BackendProfile(**PROF), **kw)
        for tokens in (0, 1, 24, 2000):
            assert b.transfer_s(tokens) == a.transfer_s(tokens)
    # the default wire charges the port's KV bytes per token: qwen3-8b bf16
    assert DisaggTokenBucketExecutor(BackendProfile(**PROF)) \
        .kv_bytes_per_token == 147456


@pytest.mark.parametrize("kw", [dict(), dict(page_size=16),
                                dict(spec_k=2, spec_alpha=0.9,
                                     spec_overhead=0.3)])
def test_spec_sim_twin_equals_reference(kw):
    admissions = [(p, 3 * p, 0.2 * i) for i, p in
                  enumerate((40, 300, 17, 250, 64))]
    probes = (0.01, 0.5, 2.0, 5.0)
    ref = _drive(JAX_SIDE, JSpecBucket, admissions, (PROF,), kw, probes)
    got = _drive(PORT_SIDE, SpecTokenBucketExecutor, admissions, (PROF,), kw,
                 probes)
    assert got == ref
    assert got[1][0]["expected_tokens_per_step"] > 1.0


# ---------------------------------------------------------------------------
# 2. real-engine parity
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _reqs(cls, seed, n=4, max_prompt=24, max_new_hi=10, prefix=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, max_prompt + 1))
        toks = rng.integers(2, 400, size=plen).astype(np.int32)
        if prefix is not None:
            toks = np.concatenate([prefix, toks]).astype(np.int32)
        out.append(cls(rid=f"r{i}", tokens=toks,
                       max_new=int(rng.integers(2, max_new_hi + 1))))
    return out


def _drain(ex, reqs, each_step=None):
    """Admit with retries (the reservation gate may push back) and drain,
    calling ``each_step(ex)`` after every step."""
    done = []
    ex.bind(None, lambda r, st_, ft: done.append(r))
    pending = list(reqs)
    while pending or ex.has_work():
        while pending and ex.admit(pending[0]):
            pending.pop(0)
        ex.step()
        if each_step is not None:
            each_step(ex)
    return done


def _by_rid(reqs):
    return {r.rid: np.asarray(r.result) for r in reqs}


def _pair(engine_cls, ex_cls, cfg, params, page_size=16, pre_batch=2,
          dec_batch=4, num_pages=None, prefix_cache=False):
    return ex_cls(
        engine_cls(cfg, params, max_batch=pre_batch, bucket=16, paged=True,
                   page_size=page_size),
        engine_cls(cfg, params, max_batch=dec_batch, bucket=16, paged=True,
                   page_size=page_size, num_pages=num_pages,
                   prefix_cache=prefix_cache))


def _accounted(ex):
    ex.prefill.debug_page_accounting()
    ex.decode.debug_page_accounting()


def test_disagg_matches_colocated_paged(setup):
    _, cfg, _, params = setup
    ref = Engine(cfg, params, max_batch=4, bucket=16, paged=True,
                 page_size=16)
    a = _by_rid(ref.serve(_reqs(GenRequest, 11)))
    ex = _pair(Engine, DisaggEngineExecutor, cfg, params)
    b = _by_rid(_drain(ex, _reqs(GenRequest, 11), _accounted))
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(b[rid], a[rid], err_msg=rid)
    assert ex.prefill.stats.handoffs == ex.decode.stats.handoffs == len(a)
    assert ex.prefill.stats.handoff_bytes == ex.decode.stats.handoff_bytes
    assert ex.engine_stats().handoffs == len(a)


# (pair keywords, request seed, count, max_new_hi): the plain pair, a
# page of 8, and a decode pool of 4 pages that preempts LIFO
PARITY_CASES = {
    "plain": (dict(), 11, 4, 10),
    "page8": (dict(page_size=8, pre_batch=1, dec_batch=3), 3, 5, 12),
    "tight-decode-pool": (dict(num_pages=4), 7, 5, 16),
}


@pytest.mark.parametrize("name", sorted(PARITY_CASES))
def test_disagg_pair_equals_reference(setup, name):
    cfg_j, cfg_t, pj, pt = setup
    kw, seed, n, hi = PARITY_CASES[name]
    ej = _pair(JEngine, JDisaggEngineExecutor, cfg_j, pj, **kw)
    et = _pair(Engine, DisaggEngineExecutor, cfg_t, pt, **kw)
    a = _by_rid(_drain(ej, _reqs(JGenRequest, seed, n, max_new_hi=hi)))
    b = _by_rid(_drain(et, _reqs(GenRequest, seed, n, max_new_hi=hi),
                       _accounted))
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(b[rid], a[rid], err_msg=rid)
    for side in ("prefill", "decode"):
        sj, st = getattr(ej, side).stats, getattr(et, side).stats
        assert (st.handoffs, st.handoff_bytes, st.preempted, st.served) == \
            (sj.handoffs, sj.handoff_bytes, sj.preempted, sj.served), side
    if name == "tight-decode-pool":
        assert et.decode.stats.preempted > 0       # the tight pool bit
        # a preempted request crosses the wire again
        assert et.prefill.stats.handoffs > len(a)
    for eng in (et.prefill, et.decode):
        assert eng.load_snapshot()["pages_used"] == 0


def test_tight_decode_pool_stays_token_exact_against_slot(setup):
    _, cfg, _, params = setup
    ref = Engine(cfg, params, max_batch=2, bucket=16)
    a = _by_rid(ref.serve(_reqs(GenRequest, 7, 5, max_new_hi=16)))
    ex = _pair(Engine, DisaggEngineExecutor, cfg, params, num_pages=4)
    b = _by_rid(_drain(ex, _reqs(GenRequest, 7, 5, max_new_hi=16),
                       _accounted))
    for rid in a:
        np.testing.assert_array_equal(b[rid], a[rid], err_msg=rid)
    assert ex.decode.stats.preempted > 0


def test_handoffs_copy_pages_and_logits(setup):
    """A handoff holds copies: the prefill engine's later writes to its
    released pages and logits rows do not reach it, and its byte count is
    2 L (length - cached) Hkv dh elements."""
    _, cfg, _, params = setup
    eng = Engine(cfg, params, max_batch=2, bucket=16, paged=True,
                 page_size=16)
    for r in _reqs(GenRequest, 5, n=2):
        eng.submit(r)
    eng.step()
    hs = eng.extract_handoffs()
    assert len(hs) == 2
    saved = [(h.k.clone(), h.v.clone(), h.logits.clone()) for h in hs]
    eng._kv["k_pool"].fill_(7.0)
    eng._kv["v_pool"].fill_(7.0)
    eng._logits.fill_(7.0)
    for h, (k, v, logits) in zip(hs, saved):
        assert torch.equal(h.k, k) and torch.equal(h.v, v)
        assert torch.equal(h.logits, logits)
        assert h.length == len(h.req.tokens) + 1 and len(h.out) == 1
        assert h.k.shape[1] == -(-h.length // 16)
        assert h.kv_bytes == (2 * cfg.n_layers * h.length * cfg.n_kv_heads
                              * cfg.head_dim * 4)
    eng.debug_page_accounting()
    assert eng.load_snapshot()["pages_used"] == 0


def test_prefix_cache_pins_are_not_gathered_nor_counted(setup):
    """Disagg with ``prefix_cache=True`` on the decode engine: a second wave
    sharing a 32-token prefix is pinned by ``prefix_pin``; its cached
    pages are neither gathered nor counted, as in the reference, and the
    tokens equal a colocated paged engine's."""
    cfg_j, cfg_t, pj, pt = setup
    prefix = np.random.default_rng(99).integers(2, 400, size=32) \
        .astype(np.int32)
    got, hand = {}, {}
    for tag, eng_cls, ex_cls, req_cls, cfg, params in (
            ("ref", JEngine, JDisaggEngineExecutor, JGenRequest, cfg_j, pj),
            ("port", Engine, DisaggEngineExecutor, GenRequest, cfg_t, pt)):
        ex = _pair(eng_cls, ex_cls, cfg, params, prefix_cache=True)
        extracted = []
        orig = ex.prefill.extract_handoffs

        def recording(fn=None, orig=orig, extracted=extracted):
            hs = orig(fn)
            extracted.extend((h.req.rid, h.cached_tokens, h.k.shape[1],
                              h.kv_bytes) for h in hs)
            return hs

        ex.prefill.extract_handoffs = recording
        out = {}
        for w in range(2):
            wave = _reqs(req_cls, 20 + w, n=3, prefix=prefix)
            for r in wave:
                r.rid = f"w{w}.{r.rid}"
            check = _accounted if tag == "port" else None
            out.update(_by_rid(_drain(ex, wave, check)))
        got[tag], hand[tag] = out, (extracted, ex.prefill.stats.handoff_bytes,
                                    ex.decode.stats.handoff_bytes,
                                    ex.decode.prefix_hit_tokens)
    assert got["port"].keys() == got["ref"].keys()
    for rid in got["ref"]:
        np.testing.assert_array_equal(got["port"][rid], got["ref"][rid])
    assert hand["port"] == hand["ref"]
    extracted = hand["port"][0]
    pinned = [e for e in extracted if e[1] > 0]
    assert pinned and all(e[1] == 32 for e in pinned)
    for rid, cached, n_pages, nbytes in extracted:
        length = len(next(r for r in _reqs(GenRequest, 20 + int(rid[1]),
                                           n=3, prefix=prefix)
                          if r.rid == rid[3:]).tokens) + 1
        assert n_pages == -(-length // 16) - cached // 16
        assert nbytes == (2 * cfg_t.n_layers * (length - cached)
                          * cfg_t.n_kv_heads * cfg_t.head_dim * 4)
    colo = Engine(cfg_t, pt, max_batch=4, bucket=16, paged=True,
                  page_size=16)
    for w in range(2):
        for r in colo.serve(_reqs(GenRequest, 20 + w, n=3, prefix=prefix)):
            np.testing.assert_array_equal(got["port"][f"w{w}.{r.rid}"],
                                          r.result)


def test_requires_two_paged_engines_of_one_page_size(setup):
    _, cfg, _, params = setup
    with pytest.raises(ValueError, match="two paged engines"):
        DisaggEngineExecutor(
            Engine(cfg, params, max_batch=2, bucket=16),
            Engine(cfg, params, max_batch=2, bucket=16, paged=True))
    with pytest.raises(ValueError, match="page_size mismatch"):
        DisaggEngineExecutor(
            Engine(cfg, params, max_batch=2, bucket=16, paged=True,
                   page_size=8),
            Engine(cfg, params, max_batch=2, bucket=16, paged=True,
                   page_size=16))


def test_load_snapshots_equal_reference_in_lockstep(setup):
    """Both pairs admit and step in lockstep; ``load()`` agrees field by
    field after every step."""
    cfg_j, cfg_t, pj, pt = setup
    ej = _pair(JEngine, JDisaggEngineExecutor, cfg_j, pj, num_pages=6)
    et = _pair(Engine, DisaggEngineExecutor, cfg_t, pt, num_pages=6)
    for ex in (ej, et):
        ex.bind(None, lambda r, st_, ft: None)
    pj_, pt_ = (_reqs(JGenRequest, 4, 5, max_new_hi=8),
                _reqs(GenRequest, 4, 5, max_new_hi=8))
    while pj_ or ej.has_work():
        while pj_ and ej.admit(pj_[0]):
            assert et.admit(pt_.pop(0))
            pj_.pop(0)
        ej.step()
        et.step()
        a, b = dataclasses.asdict(ej.load()), dataclasses.asdict(et.load())
        assert b == a
    assert not et.has_work()


# ---------------------------------------------------------------------------
# 3-4. accounting and sim-vs-engine admission agreement
# ---------------------------------------------------------------------------

def test_engine_pools_conserved_every_step(setup):
    _, cfg, _, params = setup
    ex = _pair(Engine, DisaggEngineExecutor, cfg, params, page_size=8,
               dec_batch=3, num_pages=9)

    def conserved(ex):
        _accounted(ex)
        for snap in (ex.prefill.load_snapshot(), ex.decode.load_snapshot()):
            assert snap["pages_used"] + snap["free_pages"] \
                == snap["pages_total"]

    _drain(ex, _reqs(GenRequest, 23, n=6, max_new_hi=12), conserved)
    assert ex.prefill.load_snapshot()["pages_used"] == 0
    assert ex.decode.load_snapshot()["pages_used"] == 0


def test_admission_decisions_agree_with_the_sim(setup):
    """The simulated and real disagg executors give the same admit/deny
    sequence for the same decode-page budget (both gate on
    ``paged_admit_ok`` over the decode pool minus staging
    reservations)."""
    _, cfg, _, params = setup
    page, pool = 16, 8
    sim = _Harness(PORT_SIDE, DisaggTokenBucketExecutor,
                   dict(PROF, kv_token_budget=page * pool),
                   dict(PROF, kv_token_budget=64 * page), page_size=page)
    ex = DisaggEngineExecutor(
        Engine(cfg, params, max_batch=8, bucket=16, paged=True,
               page_size=page, num_pages=64),
        Engine(cfg, params, max_batch=8, bucket=16, paged=True,
               page_size=page, num_pages=pool))
    ex.bind(None, lambda r, st_, ft: None)
    rng = np.random.default_rng(5)
    sim_dec, eng_dec = [], []
    for i, plen in enumerate((40, 30, 50, 20)):     # pages 3, 2, 4, 2
        sim_dec.append(sim.admit(f"s{i}", plen, 64))
        eng_dec.append(ex.admit(GenRequest(
            rid=f"e{i}", tokens=rng.integers(2, 400, size=plen)
            .astype(np.int32), max_new=64)))
    # 3 + 2 reserved, then 4 > 8 - 5 denied, then 2 fits
    assert sim_dec == eng_dec == [True, True, False, True]


# ---------------------------------------------------------------------------
# 5. preemption clocks
# ---------------------------------------------------------------------------

def test_preempted_requests_have_clocks_reset(setup):
    _, cfg, _, params = setup
    eng = Engine(cfg, params, max_batch=4, bucket=16, paged=True,
                 page_size=16, num_pages=4)
    for r in _reqs(GenRequest, 7, n=5, max_new_hi=16):
        eng.submit(r)
    saw = False
    while eng.has_work():
        eng.step()
        if eng.stats.preempted > 0:
            q = eng.take_queued()
            for r in q:
                assert r.started_at == 0.0 and r.first_token_at == 0.0
            saw = saw or bool(q)
            for r in reversed(q):
                eng.requeue(r)
    assert eng.stats.preempted > 0 and saw


@pytest.mark.parametrize("flavor", ["paged", "disagg"])
def test_completion_timestamps_monotone_under_preemption(setup, flavor):
    _, cfg, _, params = setup
    reqs = _reqs(GenRequest, 7, n=5, max_new_hi=16)
    done = []
    if flavor == "paged":
        ex = EngineExecutor(Engine(cfg, params, max_batch=4, bucket=16,
                                   paged=True, page_size=16, num_pages=4))
        ex.bind(None, lambda r, st_, ft: done.append((r, st_, ft)))
        for r in reqs:
            ex.engine.submit(r)          # bypass the gate: force pressure
        ex.drain()
        preempted = ex.engine.stats.preempted
    else:
        ex = _pair(Engine, DisaggEngineExecutor, cfg, params, num_pages=4)
        ex.bind(None, lambda r, st_, ft: done.append((r, st_, ft)))
        pending = list(reqs)
        while pending or ex.has_work():
            while pending and ex.admit(pending[0]):
                pending.pop(0)
            ex.step()
        preempted = ex.decode.stats.preempted
    assert preempted > 0 and len(done) == len(reqs)
    for r, started, first_tok in done:
        assert 0.0 < r.enqueued_at <= started <= first_tok <= r.finished_at
