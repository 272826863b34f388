"""Port paged engine vs ``repro.serving.Engine(paged=True)`` (CPU, fp32).

Both engines serve the same requests on bridged weights: greedy token
streams must be identical, including when a small pool forces LIFO
preemption, and the executor's load snapshots must agree field by field
while both are stepped in lockstep.  Page accounting is reconciled after
every step.  Sampling at temperature > 0 cannot match ``jax.random``'s
bits and is held to the softmax by distribution.
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
from repro_torch.serving import Engine, EngineExecutor, GenRequest, sample


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _reqs(cls, seed, n, max_prompt=24, max_new_hi=10):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(5, max_prompt + 1))
        out.append(cls(rid=f"r{i}",
                       tokens=rng.integers(2, 400, size=plen).astype(np.int32),
                       max_new=int(rng.integers(2, max_new_hi + 1))))
    return out


def _by_rid(reqs):
    return {r.rid: np.asarray(r.result) for r in reqs}


STAT_FIELDS = ("served", "prefill_tokens", "decode_tokens", "batches",
               "decode_steps", "peak_resident", "preempted")


@pytest.mark.parametrize("kw,seed,n,max_new_hi", [
    (dict(max_batch=3, bucket=16, page_size=8), 5, 6, 10),
    # a pool too small for the load: LIFO preempt-and-requeue mid-decode
    (dict(max_batch=4, bucket=16, page_size=16, num_pages=4), 7, 5, 16),
])
def test_greedy_streams_match_reference(setup, kw, seed, n, max_new_hi):
    cfg_j, cfg_t, pj, pt = setup
    ej = JEngine(cfg_j, pj, paged=True, **kw)
    et = Engine(cfg_t, pt, paged=True, **kw)
    rj = ej.serve(_reqs(JGenRequest, seed, n, max_new_hi=max_new_hi))
    rt = _reqs(GenRequest, seed, n, max_new_hi=max_new_hi)
    for r in rt:
        et.submit(r)
    while et.has_work():
        et.step()
        et.debug_page_accounting()
    a, b = _by_rid(rj), _by_rid(rt)
    assert a.keys() == b.keys()
    for rid in a:
        np.testing.assert_array_equal(b[rid], a[rid], err_msg=rid)
    for f in STAT_FIELDS:
        assert getattr(et.stats, f) == getattr(ej.stats, f), f
    if "num_pages" in kw:
        assert et.stats.preempted > 0          # the tight pool actually bit
    assert et.load_snapshot()["pages_used"] == 0
    assert et.debug_page_accounting() == ej.debug_page_accounting()


def test_executor_load_matches_reference_in_lockstep(setup):
    cfg_j, cfg_t, pj, pt = setup
    kw = dict(max_batch=2, bucket=16, page_size=8, num_pages=6)
    xj = JEngineExecutor(JEngine(cfg_j, pj, paged=True, **kw),
                         gate_on_pages=True)
    xt = EngineExecutor(Engine(cfg_t, pt, paged=True, **kw),
                        gate_on_pages=True)
    done_j, done_t = [], []
    xj.bind(None, lambda r, st, ft: done_j.append(r.rid))
    xt.bind(None, lambda r, st, ft: done_t.append(r.rid))
    admitted = [(xj.admit(a), xt.admit(b)) for a, b in zip(
        _reqs(JGenRequest, 11, 5), _reqs(GenRequest, 11, 5))]
    assert all(a == b for a, b in admitted)
    assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
    while xj.has_work() or xt.has_work():
        assert xj.has_work() and xt.has_work()
        xj.step()
        xt.step()
        assert dataclasses.asdict(xt.load()) == dataclasses.asdict(xj.load())
        assert xt.n_active == xj.n_active
    assert done_t == done_j
    assert xt.estimate(24, 8) > 0 and xt.estimate(24, 8) != float("inf")


def test_unported_modes_name_their_roadmap_item(setup):
    """Every family constructs an engine: the vlm family a slot engine; a
    window config and the moe, hybrid, ssm and audio families wave engines
    (no slot decode); slot, speculative, int8 and
    prefix-cache engines construct, ``prefix_pin`` without the cache
    returns 0, and the KV handoff refuses the backends the reference
    refuses (slot, speculative, int8 pages) while an idle fp paged engine
    hands off nothing."""
    _, cfg_t, _, pt = setup
    Engine(cfg_t, pt, paged=True, prefix_cache=True)
    for paged in (False, True):
        Engine(cfg_t.replace(kv_quant=True), pt, paged=paged)
    assert Engine(cfg_t.replace(family="vlm"), pt).slot_decode
    for cfg in (cfg_t.replace(sliding_window=64), cfg_t.replace(family="moe"),
                cfg_t.replace(family="hybrid"), cfg_t.replace(family="ssm"),
                cfg_t.replace(family="audio")):
        assert not Engine(cfg, pt).slot_decode
    for eng in (Engine(cfg_t, pt), Engine(cfg_t, pt, paged=True),
                Engine(cfg_t, pt, paged=True, spec_draft=(cfg_t, pt)),
                Engine(cfg_t.replace(kv_quant=True), pt, paged=True)):
        if eng.paged and not eng.spec and not eng.cfg.kv_quant:
            assert eng.extract_handoffs() == []
        else:
            with pytest.raises(AssertionError):
                eng.extract_handoffs()
        assert eng.prefix_pin(GenRequest(
            rid="p", tokens=np.arange(2, 40, dtype=np.int32))) == 0


def test_greedy_masks_padded_vocab_and_takes_first_maximum():
    logits = torch.zeros((2, 1, 8))
    logits[0, 0, 6] = 5.0                 # padded entry: never chosen
    logits[0, 0, 2] = logits[0, 0, 4] = 1.0
    logits[1, 0, 3] = 2.0
    out = sample(None, logits, temperature=0.0, vocab_size=6)
    assert out.tolist() == [[2], [3]]


def test_temperature_sampling_follows_the_softmax():
    """Distribution check (bits cannot match jax.random): 20k draws at
    temperature 0.7 against the tempered softmax, 4-sigma bound per
    token; a greedy row in the same batch stays greedy."""
    rng = np.random.default_rng(0)
    base = torch.from_numpy(rng.standard_normal(6).astype(np.float32))
    n = 20_000
    logits = base.expand(n, 1, 6).clone()
    temps = torch.full((n,), 0.7)
    temps[0] = 0.0
    g = torch.Generator().manual_seed(1)
    out = sample(g, logits, temperature=temps, vocab_size=6)[:, 0]
    assert out[0].item() == int(torch.argmax(base))
    freq = torch.bincount(out[1:], minlength=6).double() / (n - 1)
    p = torch.softmax(base.double() / 0.7, dim=-1)
    sigma = torch.sqrt(p * (1 - p) / (n - 1))
    assert torch.all((freq - p).abs() < 4 * sigma + 1e-4), (freq, p)
