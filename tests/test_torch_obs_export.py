"""Port trace export (``repro_torch.obs.export``) vs ``repro.obs.export``.

The same spans, recorded through each package's ``Tracer``, must give the
same Chrome ``trace_event`` payload, the same per-request latency
breakdown and the same text report.  The spans come from hand-written
calls in both clock domains and from the same traced protocol sim run by
each package (four nodes, one of them on the disaggregated sim backend,
so the stream carries ``disagg.handoff`` spans nested in
``engine.decode``); those two sim runs must record equal spans first.
"""

import json

import pytest

from repro.core import DuelParams as JDuelParams
from repro.core import Network as JNetwork
from repro.core import Node as JNode
from repro.core import NodePolicy as JNodePolicy
from repro.obs import WALL as JWALL
from repro.obs import Tracer as JTracer
from repro.obs import breakdown_report as j_breakdown_report
from repro.obs import latency_breakdown as j_latency_breakdown
from repro.obs import set_tracer as j_set_tracer
from repro.obs import to_chrome_trace as j_to_chrome_trace
from repro.sim import DisaggTokenBucketExecutor as JDisaggBucket
from repro.sim import make_profile as j_make_profile
from repro.sim.workload import Request as JRequest
from repro_torch.core import DuelParams, Network, Node, NodePolicy
from repro_torch.obs import (_WALL, Tracer, breakdown_report, get_tracer,
                             latency_breakdown, set_tracer, to_chrome_trace,
                             write_chrome_trace)
from repro_torch.sim import DisaggTokenBucketExecutor, make_profile
from repro_torch.sim.workload import Request

JAX_SIDE = dict(Network=JNetwork, Node=JNode, NodePolicy=JNodePolicy,
                DuelParams=JDuelParams, Request=JRequest,
                Disagg=JDisaggBucket, make_profile=j_make_profile,
                Tracer=JTracer, set_tracer=j_set_tracer, WALL=JWALL)
PORT_SIDE = dict(Network=Network, Node=Node, NodePolicy=NodePolicy,
                 DuelParams=DuelParams, Request=Request,
                 Disagg=DisaggTokenBucketExecutor, make_profile=make_profile,
                 Tracer=Tracer, set_tracer=set_tracer, WALL=_WALL)


def _hand_spans(side):
    tr = side["Tracer"]()
    tr.span("route.decide", "r1", "n0", 0.0, 0.1, mode="gossip")
    tr.event("executor.admit", "r1", "n1", 0.1)
    tr.span("engine.decode", "r1", "n1", 0.1, 1.1)
    tr.span("engine.decode", "r2", "n0", 0.0, 5.0)
    tr.span("engine.decode_step", "", "node1", 100.0, 100.25,
            clock=side["WALL"], batch=2)
    tr.event("disagg.handoff", "r1", "node1", 100.5, clock=side["WALL"],
             bytes=147456, cached_tokens=0)
    return tr.spans


def _traced_sim(side, n_requests=12):
    """A small decentralized sim with the tracer live: duels and
    rebalancing off, every request hot on n0, n3 on the disaggregated
    backend."""
    net = side["Network"](mode="decentralized", seed=0,
                          duel=side["DuelParams"](p_d=0.0, k_judges=0),
                          init_balance=100.0)
    pol = side["NodePolicy"](accept_freq=1.0, offload_freq=1.0,
                             offload_queue_threshold=0,
                             offload_util_threshold=0.3)
    for i in range(4):
        factory = ((lambda node: side["Disagg"](node.profile))
                   if i == 3 else None)
        net.add_node(side["Node"](
            f"n{i}", side["make_profile"]("qwen3-8b", "RTX3090", "sglang",
                                          quality=0.5),
            policy=pol, executor_factory=factory))
    reqs = [side["Request"](rid=f"t{i:03d}", origin="n0", arrival=0.15 * i,
                            prompt_tokens=512 if i % 3 == 0 else 48,
                            output_tokens=16 if i % 3 == 0 else 96,
                            slo_s=120.0) for i in range(n_requests)]
    tr = side["Tracer"]()
    old = side["set_tracer"](tr)
    try:
        net.run(reqs, until=10_000.0, rebalance_interval=0.0)
    finally:
        side["set_tracer"](old)
    return tr.spans


def _fields(spans):
    return [(s.name, s.rid, s.who, s.t0, s.t1, s.clock, s.attrs)
            for s in spans]


@pytest.fixture(scope="module", params=["hand", "sim"])
def spans(request):
    make = _hand_spans if request.param == "hand" else _traced_sim
    ref, port = make(JAX_SIDE), make(PORT_SIDE)
    assert _fields(port) == _fields(ref)
    if request.param == "sim":
        names = {s.name for s in port}
        assert {"route.decide", "executor.queue", "engine.prefill",
                "engine.decode", "disagg.handoff"} <= names
    return ref, port


def test_chrome_payload_equals_reference(spans):
    ref, port = spans
    payload = to_chrome_trace(port)
    assert payload == j_to_chrome_trace(ref)
    procs = {e["args"]["name"] for e in payload["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert procs == {"sim-time", "wall-time"}


def test_latency_breakdown_equals_reference(spans):
    ref, port = spans
    assert latency_breakdown(port) == j_latency_breakdown(ref)


@pytest.mark.parametrize("limit", [0, 1, 3])
def test_breakdown_report_equals_reference(spans, limit):
    ref, port = spans
    text = breakdown_report(port, limit=limit)
    assert text == j_breakdown_report(ref, limit=limit)
    n = len(latency_breakdown(port))
    assert text.count(": total ") == (min(limit, n) if limit else n)


def test_write_chrome_trace_round_trips(spans, tmp_path):
    _, port = spans
    path = tmp_path / "trace.json"
    payload = write_chrome_trace(port, str(path))
    assert json.loads(path.read_text()) == payload
    assert get_tracer().enabled is False     # the process default untouched
