"""Port int8 KV engines (``cfg.kv_quant``) vs the JAX engines (CPU, fp32).

Both packages serve the same requests on bridged weights: int8 slot,
paged and speculative engines (the target drafting for itself, and the
fp ``cfg.draft()`` sibling on a tight pool) must emit identical greedy
tokens and counters, LIFO preemption round-trips included; int8 paged
pages hold the slot cache's values, so the two port backends agree; the
shared ``quantized_pages`` rule doubles the pool, and stepped churn keeps
the page accounting and the executors' load snapshots equal to the
reference's.
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
               "decode_steps", "peak_resident", "preempted", "spec_steps",
               "spec_drafted", "spec_accepted")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32",
                                                       kv_quant=True)
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32",
                                                   kv_quant=True)
    pj = jregistry.init(jax.random.PRNGKey(4), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _reqs(cls, seed, n, max_new_hi=10):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, 25))
        out.append(cls(rid=f"r{i}",
                       tokens=rng.integers(2, 400, size=plen).astype(np.int32),
                       max_new=int(rng.integers(2, max_new_hi + 1))))
    return out


def _serve_port(eng, reqs):
    for r in reqs:
        eng.submit(r)
    while eng.has_work():
        eng.step()
        if eng.paged:
            eng.debug_page_accounting()
    return reqs


@pytest.mark.parametrize("kw,seed,n,max_new_hi", [
    (dict(max_batch=2, bucket=16), 7, 4, 10),                  # slot
    (dict(max_batch=3, bucket=16, paged=True, page_size=16,
          num_pages=8), 7, 4, 10),                             # paged
    # num_pages=2 doubles to 4 usable int8 pages: LIFO preemption
    (dict(max_batch=4, bucket=16, paged=True, page_size=16,
          num_pages=2), 7, 5, 16),
    # speculative over int8 pages, the target drafting for itself
    (dict(max_batch=3, bucket=16, paged=True, page_size=8,
          spec_k=3, spec_draft="self"), 5, 4, 10),
    # ... and the disagreeing fp cfg.draft() sibling on a tight pool
    (dict(max_batch=4, bucket=16, paged=True, page_size=16, num_pages=3,
          spec_draft="draft"), 6, 4, 12),
])
def test_int8_engines_match_reference(model, kw, seed, n, max_new_hi):
    cfg_j, cfg_t, pj, pt = model
    kw = dict(kw)
    draft = kw.pop("spec_draft", None)
    kw_j, kw_t = dict(kw), dict(kw)
    if draft == "self":
        kw_j["spec_draft"], kw_t["spec_draft"] = (cfg_j, pj), (cfg_t, pt)
    elif draft == "draft":
        dj = jregistry.init(jax.random.PRNGKey(10_000), cfg_j.draft())
        kw_j["spec_draft"] = (cfg_j.draft(), dj)
        kw_t["spec_draft"] = (cfg_t.draft(), bridge.params_from_jax(
            jax.tree_util.tree_map(np.asarray, dj), cfg_t.draft(), "cpu"))
        assert not cfg_t.draft().kv_quant      # the draft keeps fp caches
    ej, et = JEngine(cfg_j, pj, **kw_j), Engine(cfg_t, pt, **kw_t)
    rj = ej.serve(_reqs(JGenRequest, seed, n, max_new_hi))
    rt = _serve_port(et, _reqs(GenRequest, seed, n, max_new_hi))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.result, a.result, err_msg=a.rid)
    for f in STAT_FIELDS:
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    if kw.get("num_pages", 99) <= 2:
        assert et.stats.preempted > 0          # the tight pool actually bit
    if et.paged:
        assert et.load_snapshot() == ej.load_snapshot()
        assert et.debug_page_accounting() == ej.debug_page_accounting()
    if draft:
        assert et.spec_accept_hist == ej.spec_accept_hist


def test_int8_paged_matches_int8_slot_tokens(model):
    """Paged int8 pages hold the slot cache's int8 values bit for bit
    (scattered, not re-quantized), so the two backends emit the same
    greedy tokens."""
    _, cfg_t, _, pt = model
    slot = Engine(cfg_t, pt, max_batch=2, bucket=16)
    paged = Engine(cfg_t, pt, max_batch=3, bucket=16, paged=True,
                   page_size=16, num_pages=8)
    rs = slot.serve(_reqs(GenRequest, 11, 4))
    rp = paged.serve(_reqs(GenRequest, 11, 4))
    for a, b in zip(rs, rp):
        np.testing.assert_array_equal(a.result, b.result, err_msg=a.rid)


def test_quantized_pages_rule_and_lockstep_load(model):
    """int8 pools hold quantized_pages(n) = 2n usable pages, as the
    reference's engine and simulator count them; stepped churn on a tight
    int8 pool keeps pages_used + free_pages == pages_total, and the
    executors' load snapshots equal the reference's at every step."""
    cfg_j, cfg_t, pj, pt = model
    kw = dict(max_batch=3, bucket=16, paged=True, page_size=8, num_pages=5)
    xj = JEngineExecutor(JEngine(cfg_j, pj, **kw), gate_on_pages=True)
    xt = EngineExecutor(Engine(cfg_t, pt, **kw), gate_on_pages=True)
    assert xt.engine.load_snapshot()["pages_total"] == 10
    assert Engine(cfg_t.replace(kv_quant=False), pt, **kw) \
        .load_snapshot()["pages_total"] == 5
    done_j, done_t = [], []
    xj.bind(None, lambda r, st, ft: done_j.append(r.rid))
    xt.bind(None, lambda r, st, ft: done_t.append(r.rid))
    admitted = [(xj.admit(a), xt.admit(b)) for a, b in zip(
        _reqs(JGenRequest, 23, 6, 12), _reqs(GenRequest, 23, 6, 12))]
    assert all(a == b for a, b in admitted)
    while xj.has_work() or xt.has_work():
        assert xj.has_work() and xt.has_work()
        xj.step()
        xt.step()
        assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
        snap = xt.engine.load_snapshot()
        assert snap["pages_used"] + snap["free_pages"] == snap["pages_total"]
        assert snap["kv_used"] == snap["pages_used"] * snap["page_size"]
        xt.engine.debug_page_accounting()
    assert done_t == done_j
    assert xt.engine.load_snapshot()["pages_used"] == 0
