"""A WWW.Serve node (paper Figure 2).

Each node bundles the five managers:

* **Request Manager** — local + delegated queues, admission timestamps.
* **Policy Manager**  — ``NodePolicy`` decisions (offload / accept / priority).
* **Ledger Manager**  — either a shared ledger handle or a local CreditChain.
* **Model Manager**   — a pluggable ``Executor`` backend (DESIGN.md §6.1).
  Inside the event-loop simulation this is the continuous-batching
  ``TokenBucketExecutor`` (default).  The real ``EngineExecutor``
  implements the same contract but runs in wall-clock time on
  ``GenRequest`` payloads, so it is pumped by the serving driver
  (``repro_torch.launch.serve``) rather than scheduled by the sim loop.
* **Communication Manager** — message send via the network bus (latency
  injected by the event loop; ZeroMQ ROUTER in the paper).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, TYPE_CHECKING

import numpy as np

from repro_torch.core.gossip import PeerView
from repro_torch.core.policy import NodePolicy
from repro_torch.obs import get_tracer
from repro_torch.sim.executor import Executor, TokenBucketExecutor
from repro_torch.sim.servicemodel import BackendProfile
from repro_torch.sim.workload import Request

if TYPE_CHECKING:
    from repro_torch.core.network import Network


@dataclass
class QueuedRequest:
    req: Request
    enqueue_time: float
    delegated: bool
    origin_node: str              # who the response must be returned to
    duel_id: Optional[str] = None # set if this execution is part of a duel
    started_at: Optional[float] = None      # executor admission time
    first_token_at: Optional[float] = None  # prefill done, first decode token
    queued_at: Optional[float] = None       # arrival at the LAST hop's queue
                                            # (enqueue_time is preserved
                                            # across delegation/bounces, so
                                            # the trace plane needs its own
                                            # last-hop stamp)


class Node:
    def __init__(self, node_id: str, profile: BackendProfile,
                 policy: Optional[NodePolicy] = None,
                 quality: Optional[float] = None,
                 executor_factory: Optional[Callable[["Node"], Executor]] = None,
                 view_cap: Optional[int] = None,
                 ) -> None:
        self.id = node_id
        self.profile = profile
        self.policy = policy or NodePolicy()
        self.quality = profile.quality if quality is None else quality
        self.secret = node_id.encode() + b"-secret"
        self.view = PeerView(node_id, addr=f"tcp://{node_id}:5555",
                             view_cap=view_cap)
        self.online = True

        # Request Manager state
        self.local_queue: List[QueuedRequest] = []
        self.delegated_queue: List[QueuedRequest] = []

        # Model Manager: the executor is bound when the node joins a network
        # (it needs the network's clock)
        self._executor_factory = executor_factory or (
            lambda node: TokenBucketExecutor(node.profile))
        self.executor: Optional[Executor] = None

        # stats
        self.served_total = 0
        self.served_delegated = 0
        self.duel_wins = 0
        self.duel_losses = 0

        self.network: Optional["Network"] = None  # set on Network.add_node

    def bind_executor(self, loop) -> None:
        self.executor = self._executor_factory(self)
        self.executor.owner = self.id       # trace span identity
        self.executor.bind(loop, self._on_exec_complete)

    def publish_digest(self, now: float) -> None:
        """Heartbeat with a fresh load digest piggybacked on the membership
        record (DESIGN.md §6.2-gossip)."""
        digest = self.executor.digest(now) if self.executor is not None else None
        self.view.heartbeat(now, digest=digest)

    # ------------------------------------------------------------------ utils
    @property
    def n_active(self) -> int:
        return self.executor.n_active if self.executor is not None else 0

    @property
    def queue_len(self) -> int:
        return len(self.local_queue) + len(self.delegated_queue)

    def utilization(self) -> float:
        return self.executor.load().active_streams / max(
            1, self.profile.saturation)

    def balance(self) -> float:
        return self.network.ledger_balance(self.id)

    # --------------------------------------------------------------- requests
    def submit(self, req: Request) -> None:
        """User submits a request to this node (paper Fig 9, Step 1)."""
        assert self.network is not None
        if not self.online:
            # user traffic to an offline node is re-targeted by the network
            self.network.resubmit_elsewhere(req)
            return
        net, rng = self.network, self.network.rng
        # Step 2: local vs offload decision (Policy Manager)
        if (net.mode == "decentralized"
                and self.policy.wants_offload(self.queue_len, self.n_active,
                                              self.profile.saturation,
                                              self.balance(), rng)):
            if net.try_offload(self, req):
                return
        tr = get_tracer()
        if tr.enabled:
            tr.span("route.decide", req.rid, self.id, req.arrival,
                    net.loop.now, mode=net.mode, outcome="local")
        self.enqueue(QueuedRequest(req, net.loop.now, delegated=False,
                                   origin_node=self.id))

    def enqueue(self, qr: QueuedRequest) -> None:
        if not self.online:
            # delegation/duel deliveries race with churn: the message was in
            # flight when this node went offline, so bounce it back to the
            # network instead of re-stranding it in a drained queue
            self.network.on_queued_dropped(self, qr)
            return
        qr.queued_at = self.network.loop.now
        (self.delegated_queue if qr.delegated else self.local_queue).append(qr)
        self._maybe_start()

    def _pop_next(self) -> Optional[QueuedRequest]:
        if self.policy.prioritize_local:
            for q in (self.local_queue, self.delegated_queue):
                if q:
                    return q.pop(0)
            return None
        both = self.local_queue + self.delegated_queue
        if not both:
            return None
        qr = min(both, key=lambda x: x.enqueue_time)
        (self.local_queue if not qr.delegated else self.delegated_queue).remove(qr)
        return qr

    def _maybe_start(self) -> None:
        while self.online and self.queue_len > 0:
            qr = self._pop_next()
            if qr is None:
                break
            if not self.executor.admit(qr):
                # KV headroom exhausted: put it back at the head of its queue
                # and retry when a completion frees budget
                q = self.delegated_queue if qr.delegated else self.local_queue
                q.insert(0, qr)
                break
            tr = get_tracer()
            if tr.enabled:
                now = self.network.loop.now
                t0 = qr.queued_at if qr.queued_at is not None \
                    else qr.enqueue_time
                tr.span("executor.queue", qr.req.rid, self.id, t0, now,
                        delegated=qr.delegated)
                tr.event("executor.admit", qr.req.rid, self.id, now,
                         active=self.executor.n_active)

    def _on_exec_complete(self, qr: QueuedRequest, started_at: float,
                          first_token_at: float) -> None:
        qr.started_at = started_at
        qr.first_token_at = first_token_at
        self.served_total += 1
        if qr.delegated:
            self.served_delegated += 1
        self.network.on_request_finished(self, qr)
        self._maybe_start()

    # ------------------------------------------------------------------ churn
    def go_offline(self) -> None:
        self.online = False
        self.view.set_offline(self.network.loop.now)
        # in-flight streams drain to completion, but queued (not yet started)
        # requests would otherwise be stranded until this node happens to
        # rejoin — hand them back to the network (paper Fig 5 churn)
        stranded = self.local_queue + self.delegated_queue
        self.local_queue, self.delegated_queue = [], []
        for qr in stranded:
            self.network.on_queued_dropped(self, qr)

    def go_online(self) -> None:
        self.online = True
        self.view.heartbeat(self.network.loop.now)
        self.network.resync_chain(self.id)   # catch up on missed blocks
        self._maybe_start()
