"""A whole run of a cell on the CPU at smoke size, past the look for a
card: its result is correct; and with the timed path broken underneath
(a token altered where it is sampled, the prefill's page writes lost, a
request served twice, a request served by another node than the protocol
assigned) ``correct`` comes out false."""

import time

import pytest
import torch

from portbench.harness import cell, serve
from portbench.tests import smoke

SEED = 2**31 + 1234
CELLS = {"cmdr-chat": ("command-r-plus-104b-l8", "chat"),
         "sc2-complete-hot": ("starcoder2-7b-2node", "complete-hot")}


def _run(workload, **mix):
    cfg_name, mix_name = CELLS[workload]
    spec = cell.spec_of(smoke.bench(), workload)
    return cell.run(spec, SEED, 1.5, False, torch.device("cpu"),
                    time.perf_counter(), dtype="float32",
                    cfg=smoke.config(cfg_name),
                    mix={**smoke.mix(mix_name), **mix})


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_sound_run_is_correct(workload):
    o = _run(workload)
    assert o.correct, o.checks
    assert o.attempted > 10 and o.failed == 0
    names = {e["name"] for e in cell.spec_of(smoke.bench(),
                                             workload).end_to_end}
    assert set(o.metrics) == names
    assert all(v["value"] > 0 for v in o.metrics.values())


def test_altered_token_is_not_correct(monkeypatch):
    from repro_torch.serving import engine
    real = engine.sample

    def altered(*a, **k):
        return (real(*a, **k) + 1) % 512

    monkeypatch.setattr(engine, "sample", altered)
    o = _run("cmdr-chat")
    assert not o.correct
    assert o.checks["max_gap_sd"]["value"] > o.checks["max_gap_sd"]["limit"]


def test_lost_page_writes_are_not_correct(monkeypatch):
    real = serve.build_nodes

    def broken(*a, **k):
        nodes = real(*a, **k)
        for n in nodes.values():
            n.engine._scatter_pages = lambda pools, kv, pages: pools
        return nodes

    monkeypatch.setattr(serve, "build_nodes", broken)
    o = _run("cmdr-chat")
    assert not o.correct
    assert o.checks["max_gap_sd"]["value"] > o.checks["max_gap_sd"]["limit"]


def test_request_served_twice_is_not_correct(monkeypatch):
    from repro_torch.serving import EngineExecutor
    real = EngineExecutor.step

    def twice(self):
        done = real(self)
        return done + [r for r in done if r.rid.startswith("window")]

    monkeypatch.setattr(EngineExecutor, "step", twice)
    o = _run("cmdr-chat")
    assert not o.correct and o.checks["served_twice"]["value"] > 0


def test_request_served_by_another_node_is_not_correct(monkeypatch):
    real = serve.Replay._admit

    def elsewhere(self, a):
        if a.phase != "window" or int(a.rid.split("-")[1]) % 3:
            return real(self, a)
        mine = self.assign[a.rid]
        other = next(n for n in self.nodes if n != mine)
        from repro_torch.serving import GenRequest
        req = GenRequest(rid=a.rid, tokens=self.prompts[a.rid],
                         max_new=a.output_len)
        self.nodes[mine].live[a.rid] = serve.Live(
            a, req, serve.Served(a.rid, a.at), mine)
        self.nodes[other].executor.admit(req)

    monkeypatch.setattr(serve.Replay, "_admit", elsewhere)
    # a misrouted request never finishes where the benchmark waits for it
    o = _run("sc2-complete-hot", drain_s=3.0)
    assert not o.correct and o.checks["misrouted"]["value"] > 0


def test_dispatch_follows_the_protocol_and_offloads_from_the_hot_node():
    from portbench.harness import traffic
    arr = traffic.schedule(smoke.mix("complete-hot", rate=8.0), 5.0)
    dep = smoke.config("starcoder2-7b-2node")["deployment"]
    assign, off = serve.dispatch(arr, dep, SEED)
    assert set(assign) == {a.rid for a in arr}
    assert all(a.origin == "node1" for a in arr)
    moved = [a.rid for a in arr if assign[a.rid] != a.origin]
    assert moved and all(off[r] for r in moved)
    again, _ = serve.dispatch(arr, dep, SEED)
    assert again == assign


def test_nodes_take_the_deployments_executor_and_engine_options():
    from portbench import families
    from repro_torch.serving import EngineExecutor
    cfg = smoke.config("starcoder2-7b-2node")
    dep = cfg["deployment"]
    dep["engine"] = dict(dep["engine"], max_batch=3, num_pages=40)
    fam = families.load(cfg["family"])
    m = fam.dims(cfg)
    params = cell.node_weights(fam, m, cfg, SEED, torch.device("cpu"),
                               "float32")
    nodes = serve.build_nodes(dep, fam.port_config(cfg, m, "float32"),
                              params)
    assert list(nodes) == dep["nodes"]
    for i, n in enumerate(nodes.values()):
        assert type(n.executor) is EngineExecutor and n.params is params[i]
        assert n.engine.max_batch == 3 and n.engine.paged
