"""The engine's step traced from inside (the port alone, CPU, fp32).

Every span a step records nests as the engine's docstring says: the
prefill inside an admission, the three ``engine.decode.*`` parts inside
``engine.decode_step`` (or ``engine.spec_verify``), where they cover it,
and no two siblings overlap.  ``EngineStats.decode_launch_s`` is the sum
of the launch parts and stays within ``decode_wall_s``; it and the queue
counters advance with tracing off too; ``queue_wait_s`` is the sum over
admitted requests of (admission start - ``enqueued_at``) on the slot,
paged and wave paths.
"""

import time

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import registry
from repro_torch.obs import Tracer, set_tracer
from repro_torch.serving import Engine, GenRequest

STEP_NAMES = ("engine.sample", "engine.admit", "engine.prefill",
              "engine.pages", "engine.decode_step", "engine.spec_verify",
              "engine.decode.inputs", "engine.decode.launch",
              "engine.decode.wait")
DECODE_PARTS = ("engine.decode.inputs", "engine.decode.launch",
                "engine.decode.wait")
# the innermost span of STEP_NAMES that holds each one (None: top level)
PARENT = {"engine.sample": None, "engine.admit": None,
          "engine.prefill": "engine.admit", "engine.pages": None,
          "engine.decode_step": None, "engine.spec_verify": None}
CARD_S = 0.003      # a stand-in for the card's share of a step


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    draft = cfg.draft().replace(dtype="float32")
    dparams = registry.init(draft, torch.Generator().manual_seed(1), "cpu")
    return cfg, params, draft, dparams


def _engine(model, mode, **kw):
    cfg, params, draft, dparams = model
    if mode == "wave":
        # a window config takes the left-padded wave path
        return Engine(cfg.replace(sliding_window=64), params, max_batch=3,
                      bucket=16, **kw)
    return Engine(cfg, params, max_batch=3, bucket=16,
                  paged=mode != "slot",
                  spec_draft=(draft, dparams) if mode == "spec" else None,
                  spec_k=3, **kw)


def _slowed(eng):
    """Each decode or verify call sleeps ``CARD_S`` before it runs, so a
    step is long against the few microseconds between its parts."""
    def slow(fn):
        def run(*a, **k):
            time.sleep(CARD_S)
            return fn(*a, **k)
        return run
    for name in ("_decode", "_decode_paged", "_verify"):
        if hasattr(eng, name):
            setattr(eng, name, slow(getattr(eng, name)))
    return eng


def _requests(n, seed=3):
    rng = np.random.default_rng(seed)
    return [GenRequest(rid=f"r{i}", max_new=int(rng.integers(3, 8)),
                       tokens=rng.integers(2, 400, size=int(
                           rng.integers(5, 30))).astype(np.int32))
            for i in range(n)]


def _serve_traced(eng, reqs):
    tracer = Tracer()
    old = set_tracer(tracer)
    try:
        eng.serve(reqs)
    finally:
        set_tracer(old)
    return [s for s in tracer.spans if s.name in STEP_NAMES]


def _inside(a, b):
    return b.t0 <= a.t0 and a.t1 <= b.t1


@pytest.mark.parametrize("mode", ["paged", "slot", "spec"])
def test_step_spans_nest_cover_and_feed_the_counters(model, mode):
    eng = _slowed(_engine(model, mode))
    spans = _serve_traced(eng, _requests(7))
    names = {s.name for s in spans}
    outer = "engine.spec_verify" if mode == "spec" else "engine.decode_step"
    want = {"engine.sample", "engine.admit", "engine.prefill", outer,
            *DECODE_PARTS} | ({"engine.pages"} if mode != "slot" else set())
    assert names == want
    # every span's innermost holder is the one the step's layout names;
    # a decode part's is its decode_step or spec_verify
    for s in spans:
        holders = [p for p in spans if p is not s and _inside(s, p)]
        inner = min(holders, key=lambda p: p.dur, default=None)
        expect = outer if s.name in DECODE_PARTS else PARENT[s.name]
        assert (inner.name if inner else None) == expect, s.name
    # siblings never overlap: spans of one holder, in time order
    by_holder = {}
    for s in spans:
        holders = [p for p in spans if p is not s and _inside(s, p)]
        key = id(min(holders, key=lambda p: p.dur)) if holders else None
        by_holder.setdefault(key, []).append(s)
    for group in by_holder.values():
        group.sort(key=lambda s: s.t0)
        for a, b in zip(group, group[1:]):
            assert a.t1 <= b.t0, (a.name, b.name)
    # the three parts cover each step to within 1%
    steps = [s for s in spans if s.name == outer]
    parts = [s for s in spans if s.name in DECODE_PARTS]
    assert len(parts) == 3 * len(steps) > 0
    assert sum(p.dur for p in parts) >= 0.99 * sum(s.dur for s in steps)
    st = eng.stats
    launches = [s.dur for s in spans if s.name == "engine.decode.launch"]
    assert st.decode_launch_s == pytest.approx(sum(launches), rel=1e-12)
    assert st.decode_wall_s == pytest.approx(sum(s.dur for s in steps),
                                             rel=1e-12)
    assert CARD_S * len(steps) <= st.decode_launch_s <= st.decode_wall_s


@pytest.mark.parametrize("mode", ["paged", "slot", "wave"])
def test_counters_advance_with_tracing_off(model, mode):
    eng = _engine(model, mode)
    reqs = _requests(5)
    tracer = Tracer(enabled=False)
    old = set_tracer(tracer)
    try:
        # through the queue and step(), as an executor drives any engine
        # (a wave engine's serve() bypasses the queue)
        for r in reqs:
            eng.submit(r)
        while eng.has_work():
            eng.step()
    finally:
        set_tracer(old)
    st = eng.stats
    assert tracer.spans == []
    assert all(r.result is not None for r in reqs)
    assert 0 < st.decode_launch_s <= st.decode_wall_s
    assert st.admitted == len(reqs)
    assert 0 < st.queue_wait_s <= sum(r.started_at - r.enqueued_at
                                      for r in reqs)


@pytest.mark.parametrize("mode", ["paged", "slot"])
def test_queue_wait_is_admission_start_minus_enqueued(model, mode):
    """Seven requests through three rows: most wait for a row to free.
    Each is prefilled, and stamped ``started_at``, inside the admission
    that took it, whose start is where its queue wait ends."""
    eng = _engine(model, mode)
    reqs = _requests(7)
    admits = [s for s in _serve_traced(eng, reqs)
              if s.name == "engine.admit"]
    want, took = 0.0, set()
    for r in reqs:
        [a] = [a for a in admits if a.t0 <= r.started_at <= a.t1]
        want += a.t0 - r.enqueued_at
        took.add(id(a))
    assert len(took) > 1            # the last ones waited for a free row
    assert eng.stats.admitted == len(reqs)
    assert eng.stats.queue_wait_s == pytest.approx(want, rel=1e-12)
