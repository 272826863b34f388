"""Port prefix cache (``Engine(paged=True, prefix_cache=True)``) vs the JAX
engine (CPU, fp32).

The cases of ``tests/test_prefix_cache.py`` that drive the engine, each
run by both packages on bridged weights: cache hits through divergent
suffixes, copy-on-write at page granularity mid-chain, LIFO preemption
round-trips on a tight pool, int8 pages (a shared page shares its
scales), cold-page eviction and refcount conservation through churn, the
executor's page headroom while stepping, the legacy free list without the
cache, pool growth flushing the chain, the chain walk against the shared
hit rule, ``prefix_pin``, and the ``ValueError`` without paging.  Greedy
tokens must equal the JAX engine's (and a cache-less engine's), and so
must the hit counters, the page accounting and the load snapshots.  The
reference's ``slow`` random sweep is not repeated.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro.serving import Engine as JEngine
from repro.serving import GenRequest as JGenRequest
from repro_torch.configs import get_config
from repro_torch.models import bridge
from repro_torch.serving import Engine, EngineExecutor, GenRequest
from repro_torch.sim.executor import prefix_hit_pages


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _prefix(seed, n):
    return np.random.default_rng(seed).integers(2, 400, size=n) \
        .astype(np.int32)


def _shared(cls, prefix, specs):
    """Requests sharing ``prefix``, each with its own (rid, seed,
    suffix_len, max_new) suffix."""
    out = []
    for rid, seed, sfx, max_new in specs:
        suf = np.random.default_rng(seed).integers(2, 400, size=sfx) \
            .astype(np.int32)
        out.append(cls(rid=rid, tokens=np.concatenate([prefix, suf]),
                       max_new=max_new))
    return out


def _by_rid(reqs):
    return {r.rid: np.asarray(r.result) for r in reqs}


def _sequential(eng, reqs):
    """Serve one at a time, so later requests see earlier ones' pages."""
    got = {}
    for r in reqs:
        got.update(_by_rid(eng.serve([r])))
    return got


def _pair(s, kv_quant=False, **kw):
    """A JAX and a port engine with the same arguments."""
    cfg_j, cfg_t, pj, pt = s
    if kv_quant:
        cfg_j, cfg_t = (c.replace(kv_quant=True) for c in (cfg_j, cfg_t))
    return JEngine(cfg_j, pj, **kw), Engine(cfg_t, pt, **kw)


def _assert_same(ej, et, got_j, got_t, ref=None):
    assert got_t.keys() == got_j.keys()
    for rid in got_j:
        np.testing.assert_array_equal(got_t[rid], got_j[rid], err_msg=rid)
        if ref is not None:
            np.testing.assert_array_equal(got_t[rid], ref[rid], err_msg=rid)
    assert et.prefix_hit_tokens == ej.prefix_hit_tokens
    assert et.prefix_lookup_tokens == ej.prefix_lookup_tokens
    assert et.prefix_hit_rate == pytest.approx(ej.prefix_hit_rate,
                                               abs=1e-12)
    assert et.debug_page_accounting() == ej.debug_page_accounting()
    assert et.load_snapshot() == ej.load_snapshot()


KW = dict(bucket=16, paged=True, page_size=16)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_hits_match_reference_and_cold_engine(setup, kv_quant):
    """Sequential requests sharing a 40-token prefix hit the chain; the
    port's tokens equal the JAX engine's and a cache-less port engine's.
    On int8 pages a shared page shares its scales too."""
    specs = [("a", 1, 7, 5), ("b", 2, 13, 4), ("c", 3, 2, 6)]
    prefix = _prefix(0, 40)
    ej, et = _pair(setup, kv_quant, max_batch=3, num_pages=64,
                   prefix_cache=True, **KW)
    got_j = _sequential(ej, _shared(JGenRequest, prefix, specs))
    got_t = _sequential(et, _shared(GenRequest, prefix, specs))
    _, cold = _pair(setup, kv_quant, max_batch=3, num_pages=64, **KW)
    ref = _by_rid(cold.serve(_shared(GenRequest, prefix, specs)))
    _assert_same(ej, et, got_j, got_t, ref)
    assert et.prefix_hit_tokens > 0 and et.prefix_hit_rate > 0.0
    acct = et.debug_page_accounting()
    assert acct["held"] == 0 and acct["cold"] > 0
    assert et.load_snapshot()["resident_prefixes"]


def test_copy_on_write_mid_chain(setup):
    """A prompt matching only the first page of a registered chain shares
    exactly that page and recomputes the rest; the full chain still
    replays afterwards (the shared page was never written)."""
    prefix = _prefix(1, 48)
    diverged = np.concatenate([prefix[:16], (prefix[16:] + 1) % 400]) \
        .astype(np.int32)
    tokens = np.concatenate([diverged, np.array([5, 6, 7], np.int32)])
    ej, et = _pair(setup, max_batch=2, num_pages=64, prefix_cache=True, **KW)
    hits = {}
    for name, eng, cls in (("j", ej, JGenRequest), ("t", et, GenRequest)):
        eng.serve(_shared(cls, prefix, [("base", 9, 4, 4)]))
        before = eng.prefix_hit_tokens
        cow = _by_rid(eng.serve([cls(rid="cow", tokens=tokens, max_new=4)]))
        mid = eng.prefix_hit_tokens - before
        again = _by_rid(eng.serve(_shared(cls, prefix,
                                          [("again", 10, 4, 4)])))
        hits[name] = (cow, again, mid, eng.prefix_hit_tokens - before - mid)
    assert hits["t"][2:] == hits["j"][2:] == (16, 48)
    for j in (0, 1):
        _assert_same(ej, et, hits["j"][j], hits["t"][j])
    _, cold = _pair(setup, max_batch=2, num_pages=64, **KW)
    ref = _by_rid(cold.serve([GenRequest(rid="cow", tokens=tokens,
                                         max_new=4)]))
    np.testing.assert_array_equal(hits["t"][0]["cow"], ref["cow"])


@pytest.mark.parametrize("kv_quant", [False, True])
def test_tight_pool_preemption_roundtrip(setup, kv_quant):
    """Preempt-and-requeue churn on a pool too small for the load keeps
    cached-prefix outputs equal to the reference's; the pool drains."""
    specs = [("a", 1, 7, 6), ("b", 2, 13, 5), ("c", 3, 2, 4),
             ("d", 4, 20, 6)]
    prefix = _prefix(2, 40)
    ej, et = _pair(setup, kv_quant, max_batch=4, prefix_cache=True,
                   num_pages=6 if kv_quant else 12, **KW)
    got_j = _by_rid(ej.serve(_shared(JGenRequest, prefix, specs)))
    reqs = _shared(GenRequest, prefix, specs)
    for r in reqs:
        et.submit(r)
    while et.has_work():
        et.step()
        et.debug_page_accounting()
    _assert_same(ej, et, got_j, _by_rid(reqs))
    assert et.stats.preempted == ej.stats.preempted > 0   # the pool bit
    acct = et.debug_page_accounting()
    assert acct["held"] == 0 and acct["free"] + acct["cold"] == 12


def test_refcounts_reconcile_through_churn(setup):
    """Alternating prefixes on a 10-page pool force cold-page eviction;
    after every wave free + cold + held partition the pool exactly, as in
    the JAX engine."""
    ej, et = _pair(setup, max_batch=3, num_pages=10, prefix_cache=True,
                   **KW)
    rng = np.random.default_rng(42)
    for wave in range(4):
        prefix = rng.integers(2, 400, size=int(rng.integers(20, 40))) \
            .astype(np.int32)
        specs = [(f"w{wave}r{i}", int(rng.integers(0, 10 ** 6)),
                  int(rng.integers(1, 10)), int(rng.integers(2, 5)))
                 for i in range(3)]
        got_j = _by_rid(ej.serve(_shared(JGenRequest, prefix, specs)))
        got_t = _by_rid(et.serve(_shared(GenRequest, prefix, specs)))
        _assert_same(ej, et, got_j, got_t)
        acct = et.debug_page_accounting()
        assert acct["held"] == 0
        assert acct["free"] + acct["cold"] == \
            et.load_snapshot()["free_pages"]


def test_page_headroom_never_negative_while_stepping(setup):
    """Cold pages count as free in the snapshot, so the executor's page
    headroom stays in [0, 1] through hits and revivals."""
    _, cfg_t, _, pt = setup
    ex = EngineExecutor(Engine(cfg_t, pt, max_batch=3, num_pages=12,
                               prefix_cache=True, **KW))
    done = []
    ex.bind(None, lambda r, st_, ft: done.append(r))
    pending = _shared(GenRequest, _prefix(7, 36),
                      [(f"r{i}", i, 5 + i, 4) for i in range(5)])
    while pending or ex.has_work():
        while pending and ex.admit(pending[0]):
            pending.pop(0)
        ex.step()
        ld = ex.load()
        assert 0.0 <= ld.page_headroom <= 1.0 and ld.pages_used >= 0
    assert len(done) == 5 and ex.load().cache_hit_rate > 0.0


def test_engine_without_the_cache_keeps_the_free_list(setup):
    ej, et = _pair(setup, max_batch=2, num_pages=8, **KW)
    specs = [("a", 1, 4, 3), ("b", 2, 6, 3)]
    got_j = _by_rid(ej.serve(_shared(JGenRequest, _prefix(1, 20), specs)))
    got_t = _by_rid(et.serve(_shared(GenRequest, _prefix(1, 20), specs)))
    _assert_same(ej, et, got_j, got_t)
    assert et.debug_page_accounting() == {"free": 8, "cold": 0, "held": 0}
    assert et.prefix_hit_tokens == 0


def test_pool_growth_flushes_the_chain(setup):
    """Reallocating the pool for a too-large request forgets every cached
    page: a rerun of the small prompt is cold again."""
    ej, et = _pair(setup, max_batch=2, num_pages=4, prefix_cache=True, **KW)
    for eng, cls in ((ej, JGenRequest), (et, GenRequest)):
        eng.serve(_shared(cls, _prefix(2, 20), [("a", 1, 4, 3)]))
        assert eng.debug_page_accounting()["cold"] > 0
        eng.serve([cls(rid="big", tokens=_prefix(3, 90), max_new=3)])
        before = eng.prefix_hit_tokens
        eng.serve(_shared(cls, _prefix(2, 20), [("a2", 9, 4, 3)]))
        assert eng.prefix_hit_tokens == before
    assert et.debug_page_accounting() == ej.debug_page_accounting()
    assert et.load_snapshot() == ej.load_snapshot()


def test_chain_walk_matches_the_shared_rule(setup):
    """A prompt sharing exactly ``c`` leading tokens with a registered one
    reuses ``prefix_hit_pages(len, page, c)`` pages."""
    _, cfg_t, _, pt = setup
    eng = Engine(cfg_t, pt, max_batch=2, num_pages=64, prefix_cache=True,
                 **KW)
    base = _prefix(4, 56)
    eng.serve(_shared(GenRequest, base, [("base", 1, 4, 3)]))
    for common in (0, 5, 15, 16, 17, 32, 48, 56):
        probe = np.concatenate([base[:common], (base[common:] + 1) % 400,
                                np.array([3, 4], np.int32)]).astype(np.int32)
        assert len(eng._prefix_lookup_pages(probe)) == \
            prefix_hit_pages(len(probe), 16, common), common


def test_prefix_pin_claims_and_counts_like_the_reference(setup):
    """``prefix_pin`` claims the cached pages of a prompt under its
    request id (held, not evictable), counts the lookup, and returns 0
    when pinned twice or when nothing is cached."""
    ej, et = _pair(setup, max_batch=2, num_pages=16, prefix_cache=True,
                   **KW)
    prefix = _prefix(5, 40)
    out = {}
    for name, eng, cls in (("j", ej, JGenRequest), ("t", et, GenRequest)):
        assert eng.prefix_pin(cls(rid="early", tokens=prefix)) == 0
        eng.serve(_shared(cls, prefix, [("base", 1, 5, 3)]))
        probe = _shared(cls, prefix, [("p", 2, 9, 3)])[0]
        out[name] = (eng.prefix_pin(probe), eng.prefix_pin(probe),
                     eng.prefix_pin(cls(rid="miss", tokens=_prefix(6, 40))))
    assert out["t"] == out["j"] == (32, 0, 0)
    assert et.debug_page_accounting() == ej.debug_page_accounting()
    assert et.debug_page_accounting()["held"] == 2
    assert et.prefix_lookup_tokens == ej.prefix_lookup_tokens
    assert et.load_snapshot() == ej.load_snapshot()


def test_prefix_cache_requires_paged(setup):
    _, cfg_t, _, pt = setup
    with pytest.raises(ValueError, match="paged"):
        Engine(cfg_t, pt, max_batch=2, bucket=16, prefix_cache=True)
