"""Port serving driver vs the reference driver, same seed, same weights.

``repro_torch.launch.serve.run`` on the CPU with weights bridged from
``jax.random`` must reproduce the reference scenario exactly: the
protocol's assignment of requests to nodes, the credit balances, and
every request's greedy tokens from the replay, on slot engines (the
driver's default), paged engines and speculative engines with the shared
``cfg.draft()`` model, on int8 KV pages with the paged and the
speculative engines, and on disaggregated prefill/decode pairs, whose
handoff counts and bytes must match too (the reference replay is
``repro.core.Network.run`` plus ``EngineExecutor``s,
``SpecEngineExecutor``s or ``DisaggEngineExecutor``s, as
``repro.launch.serve`` drives them with no flag, ``--paged``, ``--spec``,
``--kv-quant``, ``--spec --kv-quant`` and ``--disagg``).  The disagg and
spec runs are traced on both sides (``--trace``): the sim-clock spans
must be equal, and each request's wall-clock span names the same.
"""

import collections
import json
from typing import Dict, List

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import DuelParams, Network, Node, NodePolicy
from repro.models import registry as jregistry
from repro.obs import SIM, Tracer, set_tracer
from repro.serving import (DisaggEngineExecutor, Engine, EngineExecutor,
                           GenRequest, SpecEngineExecutor)
from repro.sim import make_profile
from repro.sim.workload import Request
from repro_torch.configs import get_config
from repro_torch.launch import serve
from repro_torch.models import bridge

NODES, REQUESTS, MAX_NEW, SEED, PROMPT = 2, 6, 6, 0, 24
DRAFT_SEED, SPEC_K = 10_000, 4
TRACED = ("spec", "disagg")          # runs made with --trace on both sides
# the port's wall spans inside a step, which the reference has not
PORT_STEP_SPANS = {"engine.sample", "engine.admit", "engine.pages",
                   "engine.decode.inputs", "engine.decode.launch",
                   "engine.decode.wait"}


def _jax_params(i, cfg):
    return jregistry.init(jax.random.PRNGKey(i), cfg)


def _reference_run(cfg, mode, trace) -> Dict:
    """The reference driver's scenario (``repro.launch.serve.main`` with
    no flag, ``--paged``, ``--spec`` or ``--disagg``, and ``--trace``),
    returning what it prints as data and the spans it records."""
    rng = np.random.default_rng(SEED)
    net = Network(mode="decentralized", seed=SEED,
                  duel=DuelParams(p_d=0.2, k_judges=1), init_balance=100.0)
    draft = None
    if mode == "spec":
        draft = (cfg.draft(), _jax_params(DRAFT_SEED, cfg.draft()))
    executors = {}
    for i in range(NODES):
        nid = f"node{i+1}"
        params = _jax_params(i, cfg)
        if mode == "disagg":
            executors[nid] = DisaggEngineExecutor(
                Engine(cfg, params, max_batch=4, bucket=32, seed=i,
                       paged=True),
                Engine(cfg, params, max_batch=4, bucket=32, seed=1000 + i,
                       paged=True))
        else:
            engine = Engine(cfg, params, max_batch=4, bucket=32, seed=i,
                            paged=mode != "slot", spec_draft=draft,
                            spec_k=SPEC_K)
            executors[nid] = (SpecEngineExecutor(engine) if mode == "spec"
                              else EngineExecutor(engine))
        executors[nid].owner = nid
        net.add_node(Node(nid, make_profile("qwen3-8b", "RTX3090", "sglang",
                                            quality=0.4 + 0.15 * i),
                          policy=NodePolicy(offload_util_threshold=0.15,
                                            offload_queue_threshold=0,
                                            target_utilization=0.9)))
    tracer = Tracer()
    old_tracer = set_tracer(tracer) if trace else None
    prompts = [rng.integers(2, cfg.vocab_size, size=PROMPT).astype(np.int32)
               for _ in range(REQUESTS)]
    m = net.run([Request(rid=f"r{i}", origin="node1", arrival=0.01 * i,
                         prompt_tokens=PROMPT, output_tokens=MAX_NEW,
                         slo_s=60.0) for i in range(REQUESTS)], until=600.0)
    by_exec: Dict[str, List[int]] = {}
    for c in m.completed:
        if not c.is_duel_extra:
            by_exec.setdefault(c.executor, []).append(int(c.rid[1:]))
    done: List[GenRequest] = []
    for nid, idxs in by_exec.items():
        ex = executors[nid]
        ex.bind(None, lambda r, st, ft: done.append(r))
        for i in idxs:
            ex.admit(GenRequest(rid=f"r{i}", tokens=prompts[i],
                                max_new=MAX_NEW))
    busy = {nid for nid in by_exec if executors[nid].has_work()}
    while busy:
        for nid in sorted(busy):
            executors[nid].step()
        busy = {nid for nid in busy if executors[nid].has_work()}
    if trace:
        set_tracer(old_tracer)
    return {"assigned": {nid: [f"r{i}" for i in idxs]
                         for nid, idxs in by_exec.items()},
            "balances": {n: net.ledger_balance(n) for n in net.nodes},
            "results": {r.rid: np.asarray(r.result) for r in done},
            "stats": {nid: executors[nid].engine_stats() for nid in by_exec},
            "slo_attainment": m.slo_attainment(),
            "spans": tracer.spans}


@pytest.fixture(scope="module", params=["paged", "slot", "spec",
                                        "paged-int8", "spec-int8", "disagg"])
def runs(request, tmp_path_factory):
    torch.set_num_threads(2)
    mode, _, quant = request.param.partition("-")
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(
        dtype="float32", kv_quant=bool(quant))
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32",
                                                   kv_quant=bool(quant))

    def params_fn(i, cfg, device):
        tree = jax.tree_util.tree_map(np.asarray, _jax_params(i, cfg_j))
        return bridge.params_from_jax(tree, cfg, device)

    def draft_params_fn(cfg, device):
        tree = jax.tree_util.tree_map(
            np.asarray, _jax_params(DRAFT_SEED, cfg_j.draft()))
        return bridge.params_from_jax(tree, cfg, device)

    trace = (str(tmp_path_factory.mktemp("trace") / "trace.json")
             if request.param in TRACED else None)
    port = serve.run(cfg_t, nodes=NODES, requests=REQUESTS, max_new=MAX_NEW,
                     seed=SEED, device="cpu", mode=mode, spec_k=SPEC_K,
                     params_fn=params_fn, draft_params_fn=draft_params_fn,
                     trace=trace, verbose=False)
    port["trace_path"] = trace
    return mode, _reference_run(cfg_j, mode, bool(trace)), port


def test_same_protocol_assignment_and_balances(runs):
    _, ref, port = runs
    assert port["assigned"] == ref["assigned"]
    assert port["balances"] == ref["balances"]
    assert port["slo_attainment"] == ref["slo_attainment"]
    assert sum(len(v) for v in port["assigned"].values()) == REQUESTS


def test_same_tokens_for_every_request(runs):
    mode, ref, port = runs
    assert port["results"].keys() == ref["results"].keys()
    for rid, toks in ref["results"].items():
        np.testing.assert_array_equal(port["results"][rid], toks,
                                      err_msg=rid)
    assert port["tokens"] == sum(len(t) for t in ref["results"].values())
    for nid, st in ref["stats"].items():
        got = port["stats"][nid]
        assert (got.decode_tokens, got.decode_steps, got.spec_drafted,
                got.spec_accepted) == (st.decode_tokens, st.decode_steps,
                                       st.spec_drafted, st.spec_accepted)
        assert (got.spec_steps > 0) == (mode == "spec")
        assert (got.handoffs, got.handoff_bytes) == (st.handoffs,
                                                     st.handoff_bytes)
        assert (got.handoffs > 0) == (mode == "disagg")


def test_traced_spans_equal_reference(runs):
    """With ``trace=``, the sim-clock spans equal the reference driver's,
    each request's wall-clock span names match, and the file is the
    Chrome trace of them; without it, nothing is recorded."""
    mode, ref, port = runs
    if port["trace_path"] is None:
        assert port["spans"] == [] and ref["spans"] == []
        return

    def sim(spans):
        return [(s.name, s.rid, s.who, s.t0, s.t1) for s in spans
                if s.clock == SIM]

    def wall_names(spans, only=None):
        out = collections.defaultdict(collections.Counter)
        for s in spans:
            if s.clock != SIM and (only is None or s.name in only):
                out[s.rid][s.name, s.who] += 1
        return out

    assert sim(port["spans"]) == sim(ref["spans"])
    assert len(sim(port["spans"])) > 5 * REQUESTS
    # the port names the parts of its step too (``serving/engine.py``'s
    # docstring); every name the reference records counts the same
    ref_names = {s.name for s in ref["spans"] if s.clock != SIM}
    assert wall_names(port["spans"], ref_names) == wall_names(ref["spans"])
    assert {s.name for s in port["spans"] if s.clock != SIM} - ref_names \
        == PORT_STEP_SPANS
    with open(port["trace_path"]) as f:
        payload = json.load(f)
    assert len(payload["traceEvents"]) > len(port["spans"])
    # the sim-side stages of each request add up to its simulated latency
    for rid, latency in port["latency"].items():
        total = sum(s.t1 - s.t0 for s in port["spans"]
                    if s.rid == rid and s.clock == SIM)
        assert abs(total - latency) <= 1e-9, rid
    if mode == "disagg":
        handoffs = sum(st.handoffs for st in port["stats"].values())
        assert sum(s.name == "disagg.handoff" for s in port["spans"]
                   if s.clock != SIM) == handoffs
