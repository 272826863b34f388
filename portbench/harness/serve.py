"""The system under test and the open loop that drives it.

Each node is the port's executor over an ``Engine`` in the configuration's
dtype, both as the configuration's ``deployment`` names them.  Where a
cell has more than one node, the port's protocol (``core.Network`` with
the nodes, policy and profiles of the deployment's ``protocol``, as
``launch/serve.py``'s ``run`` builds them) runs over the whole arrival
schedule in set-up, and the replay sends each request to the node it assigned, at
the request's scheduled time: the program's own dispatch, decided ahead
and in simulated time.

The loop is open: at each scheduled arrival the benchmark calls ``admit``
on the request's node, and between arrivals it pumps every node's
``step()`` round-robin, as ``launch/serve.py`` does.  Every time is the
benchmark's own clock, read when a step returns: a request's first token
is seen at the return of the step that sampled it, and each step samples
one token for every request that is resident in it (a plain engine, not a
speculative one), which is how the benchmark counts the tokens sampled
inside the window.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field, fields
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

import numpy as np
import torch

from portbench.harness.stats import Served
from portbench.harness.traffic import Arrival

def dispatch(arrivals: Sequence[Arrival], dep: Dict, seed: int
             ) -> Tuple[Dict[str, str], Dict[str, bool]]:
    """The protocol's assignment (request id -> executing node) and which
    requests it offloaded away from their origin, with the network (and
    any further ``Network`` options under ``network``), nodes, profiles and
    policy of the deployment's ``protocol``; its random draws (duels,
    judges) from ``seed``.  One node takes all."""
    nodes = dep["nodes"]
    if len(nodes) == 1:
        return ({a.rid: nodes[0] for a in arrivals},
                {a.rid: False for a in arrivals})
    from repro_torch.core import DuelParams, Network, Node, NodePolicy
    from repro_torch.sim import make_profile
    from repro_torch.sim.workload import Request
    pr = dep["protocol"]
    net = Network(mode=pr["mode"], seed=seed,
                  duel=DuelParams(p_d=pr["duel_rate"],
                                  k_judges=pr["k_judges"]),
                  init_balance=pr["init_balance"],
                  **pr.get("network", {}))
    prof = pr["profile"]
    for nid, quality in zip(nodes, pr["quality"], strict=True):
        net.add_node(Node(nid, make_profile(prof["model"], prof["gpu"],
                                            prof["engine"], quality=quality),
                          policy=NodePolicy(**pr["policy"])))
    sim = [Request(rid=a.rid, origin=a.origin, arrival=a.at,
                   prompt_tokens=a.prompt_len, output_tokens=a.output_len,
                   slo_s=pr["slo_s"]) for a in arrivals]
    done = [c for c in net.run(sim, until=600.0).completed
            if not c.is_duel_extra]
    assign = {c.rid: c.executor for c in done}
    missing = [a.rid for a in arrivals if a.rid not in assign]
    if missing or len(done) != len(arrivals):
        raise RuntimeError(f"the protocol completed {len(done)} of "
                           f"{len(arrivals)} requests (missing {missing[:5]})")
    return assign, {c.rid: bool(c.delegated) for c in done}


@dataclass
class Live:
    """One request in flight: the program's request object and what the
    benchmark has seen of it."""
    arrival: Arrival
    req: object                   # repro_torch GenRequest
    seen: Served
    node: str
    admitted_at: Optional[float] = None
    first_step: Optional[int] = None
    prefilled_at: Optional[float] = None
    result: Optional[np.ndarray] = None


@dataclass
class NodeRun:
    nid: str
    params: Dict
    engine: object
    executor: object
    steps: int = 0
    live: Dict[str, Live] = field(default_factory=dict)
    resident: Set[str] = field(default_factory=set)


def build_nodes(dep: Dict, mc, params: Sequence[Dict]
                ) -> Dict[str, NodeRun]:
    """One engine behind an executor for each node of the deployment, node
    ``i`` serving ``params[i]``: the ``repro_torch.serving`` executor that
    ``dep["executor"]`` names over an ``Engine`` with ``dep["engine"]``'s
    options."""
    from repro_torch import serving
    executor = getattr(serving, dep["executor"])
    out: Dict[str, NodeRun] = {}
    for i, nid in enumerate(dep["nodes"]):
        eng = serving.Engine(mc, params[i], seed=i, **dep["engine"])
        ex = executor(eng)
        ex.owner = nid
        out[nid] = NodeRun(nid, params[i], eng, ex)
    return out


@dataclass
class Window:
    open_t: Optional[float] = None
    close_t: Optional[float] = None
    tokens: int = 0                 # sampled inside the window
    prefill_flops: float = 0.0
    decode_flops: float = 0.0
    stats_open: Optional[Dict[str, float]] = None
    stats_close: Optional[Dict[str, float]] = None
    backlog: Tuple[int, int] = (0, 0)   # requests in flight at open, close
    late_s: float = 0.0                 # the loop's worst admission delay

    @property
    def seconds(self) -> float:
        return self.close_t - self.open_t

    def inside(self) -> bool:
        return self.open_t is not None and self.close_t is None


def counters(nodes: Dict[str, NodeRun]) -> Dict[str, float]:
    """Every number of the engines' own ``EngineStats``, summed over the
    nodes."""
    stats = [n.engine.stats for n in nodes.values()]
    return {f.name: float(sum(getattr(st, f.name) for st in stats))
            for f in fields(stats[0])
            if isinstance(getattr(stats[0], f.name), (int, float))}


class Replay:
    """The open loop over one schedule.  ``on_phase`` (traced runs) is told
    of each phase the host enters, by name, with its start and end on the
    loop's clock; ``on_tick`` of the clock at each turn of the loop."""

    def __init__(self, nodes: Dict[str, NodeRun], arrivals: List[Arrival],
                 assign: Dict[str, str], prompts: Dict[str, np.ndarray],
                 warmup_s: float, seconds: float, drain_s: float,
                 flops, device: torch.device,
                 on_phase: Optional[Callable[[str, float, float], None]]
                 = None,
                 on_tick: Optional[Callable[[float], None]] = None) -> None:
        self.nodes = nodes
        self.arrivals = arrivals
        self.assign = assign
        self.prompts = prompts
        self.warmup_s, self.seconds, self.drain_s = warmup_s, seconds, drain_s
        self.flops = flops
        self.device = device
        self.on_phase = on_phase or (lambda *a: None)
        self.on_tick = on_tick or (lambda t: None)
        self.window = Window()
        self.done: Dict[str, Live] = {}
        self.misrouted = 0
        self.served_twice = 0
        self.t0 = 0.0
        self.end = 0.0

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def _admit(self, a: Arrival) -> None:
        from repro_torch.serving import GenRequest
        nid = self.assign[a.rid]
        node = self.nodes[nid]
        req = GenRequest(rid=a.rid, tokens=self.prompts[a.rid],
                         max_new=a.output_len)
        node.live[a.rid] = Live(a, req, Served(a.rid, a.at), nid,
                                admitted_at=self.now())
        if not node.executor.admit(req):
            raise RuntimeError(f"{nid} refused {a.rid}")

    def _observe(self, node: NodeRun, finished: Sequence, t: float) -> None:
        """After one step of ``node`` returned at ``t``."""
        idx = node.steps
        node.steps += 1
        in_window = self.window.inside()
        for rid, lv in node.live.items():
            r = lv.req
            if lv.prefilled_at is None and r.started_at > 0:
                lv.prefilled_at = t
                if in_window:
                    self.window.prefill_flops += self.flops.prefill_flops(
                        len(r.tokens))
            if lv.first_step is None and r.first_token_at > 0:
                lv.first_step = idx
                lv.seen.first = t
                node.resident.add(rid)
            elif lv.first_step is not None and r.first_token_at == 0:
                # preempted: its tokens are discarded and sampled again
                lv.first_step = None
                lv.seen.first = None
                lv.prefilled_at = None
                node.resident.discard(rid)
        sampled = len(node.resident)
        ended = set()
        for r in finished:
            lv = node.live.get(r.rid) or self.done.get(r.rid)
            if lv is None or lv.node != node.nid:
                self.misrouted += 1
                continue
            if r.rid in self.done or r.rid in ended:
                self.served_twice += 1
                continue
            lv.seen.finish = t
            lv.seen.tokens = idx - lv.first_step + 1
            lv.result = np.asarray(r.result)
            ended.add(r.rid)
        if in_window:
            self.window.tokens += sampled
            for rid in node.resident - ended:
                lv = node.live[rid]
                ctx = len(lv.req.tokens) + idx - lv.first_step + 1
                self.window.decode_flops += self.flops.decode_flops(ctx)
        for rid in ended:
            node.resident.discard(rid)
            self.done[rid] = node.live.pop(rid)

    def in_flight(self) -> int:
        return sum(len(n.live) for n in self.nodes.values())

    def window_requests(self) -> List[Live]:
        every = {**{r: lv for n in self.nodes.values()
                    for r, lv in n.live.items()}, **self.done}
        return [every[a.rid] for a in self.arrivals if a.phase == "window"
                if a.rid in every]

    def run(self) -> None:
        arr = self.arrivals
        n_win = sum(1 for a in arr if a.phase == "window")
        i = 0
        open_at = self.warmup_s
        close_at = self.warmup_s + self.seconds
        stop_at = close_at + self.drain_s
        phase = self.on_phase
        self.t0 = time.perf_counter()
        while True:
            t = self.now()
            if self.window.open_t is None and t >= open_at:
                self.window.open_t = t
                self.window.stats_open = counters(self.nodes)
                self.window.backlog = (self.in_flight(), 0)
            elif self.window.inside() and t >= close_at:
                self.window.close_t = t
                self.window.stats_close = counters(self.nodes)
                self.window.backlog = (self.window.backlog[0],
                                       self.in_flight())
            self.on_tick(t)
            if self.window.close_t is not None:
                left = n_win - sum(1 for lv in self.done.values()
                                   if lv.arrival.phase == "window")
                if left == 0 or t >= stop_at:
                    break
            if i < len(arr) and arr[i].at <= t:
                t_a = t
                while i < len(arr) and arr[i].at <= t:
                    if arr[i].phase == "window":
                        self.window.late_s = max(self.window.late_s,
                                                 t - arr[i].at)
                    self._admit(arr[i])
                    i += 1
                phase("admit", t_a, self.now())
            stepped = False
            for node in self.nodes.values():
                if not node.executor.has_work():
                    continue
                t_s = self.now()
                finished = node.executor.step()
                t_e = self.now()
                phase("step", t_s, t_e)
                self._observe(node, finished, t_e)
                phase("observe", t_e, self.now())
                stepped = True
            if not stepped:
                t_w = self.now()
                nxt = arr[i].at if i < len(arr) else t_w + 1e-3
                time.sleep(max(0.0, min(nxt - t_w, 1e-3)))
                phase("wait", t_w, self.now())
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.end = self.now()
