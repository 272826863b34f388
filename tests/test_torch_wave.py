"""Port wave engine vs ``repro.serving.Engine``'s left-padded waves (CPU).

Families without per-row cache depths (moe) and sliding-window configs
are served by lock-step waves: prompts left-padded with ``eos_id``, one
prefill, decode steps at one shared length.  Both engines serve the same
requests on the same (perturbed, bridged) weights in fp32, on
granite-moe-1b-a400m's smoke config and on qwen3-8b's ``long_500k``
sliding-window variant (smoke: window 64) with prompts longer than the
window: greedy streams must be identical token for token, and so must
the engine stats and, stepped in lockstep behind ``EngineExecutor``, every
``load()`` snapshot; ``logprob_of`` must agree within 1e-5 relative.  The
backends the reference refuses for a wave engine (paged, speculative,
int8 pages, all of which need paged KV) raise its ``ValueError`` here too.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serving import Engine as JEngine
from repro.serving import EngineExecutor as JEngineExecutor
from repro.serving import GenRequest as JGenRequest
from repro_torch.configs import get_config
from repro_torch.serving import Engine, EngineExecutor, GenRequest
from test_torch_dense_variants import both_params

STAT_FIELDS = ("served", "prefill_tokens", "decode_tokens", "batches",
               "decode_steps", "peak_resident", "preempted")
CASES = {"moe": ("granite-moe-1b-a400m", None),
         "window": ("qwen3-8b", "long_500k")}


@pytest.fixture(scope="module", params=sorted(CASES))
def setup(request):
    torch.set_num_threads(2)
    arch, shape = CASES[request.param]
    cfg_j, cfg_t, pj, pt = both_params(arch, 2)
    if shape is not None:
        cfg_j = jax_get_config(arch, shape).smoke().replace(dtype="float32")
        cfg_t = get_config(arch, shape).smoke().replace(dtype="float32")
        assert cfg_t.sliding_window == cfg_j.sliding_window == 64
    return request.param, cfg_j, cfg_t, pj, pt


def _reqs(cls, seed, n, lo, hi, max_new_hi=9, eos=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        toks = rng.integers(2, 400, size=int(rng.integers(lo, hi + 1)))
        if eos is not None and i == 1:
            toks[-1] = eos               # an eos inside a prompt
        out.append(cls(rid=f"r{i}", tokens=toks.astype(np.int32),
                       max_new=int(rng.integers(1, max_new_hi + 1))))
    return out


def _prompt_range(name):
    # the window case's prompts run past its 64-position ring
    return (40, 100) if name == "window" else (5, 40)


@pytest.mark.parametrize("max_batch", [3, 4])
def test_greedy_streams_and_stats_match_reference(setup, max_batch):
    name, cfg_j, cfg_t, pj, pt = setup
    lo, hi = _prompt_range(name)
    ej = JEngine(cfg_j, pj, max_batch=max_batch, bucket=32)
    et = Engine(cfg_t, pt, max_batch=max_batch, bucket=32)
    assert not ej.slot_decode and not et.slot_decode
    rj = ej.serve(_reqs(JGenRequest, 7, 7, lo, hi, eos=cfg_j.eos_id))
    rt = et.serve(_reqs(GenRequest, 7, 7, lo, hi, eos=cfg_t.eos_id))
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(np.asarray(b.result),
                                      np.asarray(a.result), err_msg=a.rid)
        assert 1 <= len(b.result) <= b.max_new
        assert b.started_at <= b.first_token_at <= b.finished_at
    for f in STAT_FIELDS:
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    assert et.stats.batches == -(-7 // max_batch)
    assert not et.has_work()


def test_executor_load_matches_reference_in_lockstep(setup):
    """Both executors admit the same requests and are stepped together:
    each step serves one wave, and every ``load()`` snapshot, the active
    counts and the completion order must agree."""
    name, cfg_j, cfg_t, pj, pt = setup
    lo, hi = _prompt_range(name)
    xj = JEngineExecutor(JEngine(cfg_j, pj, max_batch=2, bucket=32))
    xt = EngineExecutor(Engine(cfg_t, pt, max_batch=2, bucket=32))
    done_j, done_t = [], []
    xj.bind(None, lambda r, st, ft: done_j.append(r.rid))
    xt.bind(None, lambda r, st, ft: done_t.append(r.rid))
    for a, b in zip(_reqs(JGenRequest, 11, 5, lo, hi),
                    _reqs(GenRequest, 11, 5, lo, hi)):
        assert xj.admit(a) and xt.admit(b)
    assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
    steps = 0
    while xj.has_work() or xt.has_work():
        assert xj.has_work() and xt.has_work()
        xj.step()
        xt.step()
        steps += 1
        assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
        assert xt.n_active == xj.n_active
    assert steps == 3 and done_t == done_j
    assert xt.estimate(24, 8) > 0 and xt.estimate(24, 8) != float("inf")


def test_logprob_of_matches_reference(setup):
    name, cfg_j, cfg_t, pj, pt = setup
    toks = np.random.default_rng(3).integers(
        2, 400, size=90 if name == "window" else 40).astype(np.int32)
    want = JEngine(cfg_j, pj, max_batch=2, bucket=32).logprob_of(toks)
    got = Engine(cfg_t, pt, max_batch=2, bucket=32).logprob_of(toks)
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)


def test_paged_backends_raise_as_the_reference_does(setup):
    """Paged, speculative and int8-page engines need paged KV, which a wave
    engine lacks: both packages raise the same ``ValueError``."""
    _, cfg_j, cfg_t, pj, pt = setup
    for kw_j, kw_t, cfg_jq, cfg_tq in (
            (dict(paged=True), dict(paged=True), cfg_j, cfg_t),
            (dict(paged=True, spec_draft=(cfg_j.draft(), pj)),
             dict(paged=True, spec_draft=(cfg_t.draft(), pt)), cfg_j, cfg_t),
            (dict(paged=True), dict(paged=True),
             cfg_j.replace(kv_quant=True), cfg_t.replace(kv_quant=True))):
        with pytest.raises(ValueError) as ej:
            JEngine(cfg_jq, pj, **kw_j)
        with pytest.raises(ValueError) as et:
            Engine(cfg_tq, pt, **kw_t)
        assert str(et.value) == str(ej.value)
