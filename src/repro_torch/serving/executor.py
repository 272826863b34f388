"""The real-engine backend behind the Executor contract (DESIGN.md §6.1).

Port of ``repro.serving.executor``: ``EngineExecutor`` puts one PyTorch
``Engine`` (slot or paged), ``SpecEngineExecutor`` a speculative one and
``DisaggEngineExecutor`` a prefill engine and a decode engine joined by
page-granular KV handoff behind the same four-method contract as the
simulated backends (see ``repro_torch.sim.executor``): ``admit(item) -> bool``,
``load() -> ExecutorLoad``, ``estimate(prompt, output) -> seconds`` and
``bind(loop, on_complete)``, the callback receiving ``(item, started_at,
first_token_at)``.  There is no ambient event loop: the engine runs in
wall-clock time, so callers pump ``step()`` or ``drain()`` themselves.
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional

from repro_torch.obs import _WALL, get_tracer, wall_now
from repro_torch.serving.engine import (Engine, EngineStats, GenRequest,
                                        KVHandoff)
from repro_torch.sim.executor import (Executor, ExecutorLoad, paged_admit_ok,
                                      pages_for, spec_expected_tokens)


def _pending_gate(snap: Dict[str, int], item: GenRequest,
                  max_pending_tokens: Optional[int]) -> bool:
    """Admission backpressure: True when the queued-but-unstarted token
    backlog (plus this request) still fits ``max_pending_tokens`` (None =
    unbounded; an empty queue always admits)."""
    if max_pending_tokens is None:
        return True
    pending = snap["queued_prompt_tokens"] + snap["queued_new_tokens"]
    return (snap["queued_streams"] == 0
            or pending + len(item.tokens) + item.max_new
            <= max_pending_tokens)


class EngineExecutor(Executor):
    def __init__(self, engine: Engine,
                 max_pending_tokens: Optional[int] = None,
                 gate_on_pages: bool = False) -> None:
        self.engine = engine
        # admission bound: queued-but-unstarted work the executor will hold
        # before pushing back on the caller (None = unbounded)
        self.max_pending_tokens = max_pending_tokens
        # paged engines only: push back at admit() time with the same
        # page-granularity rule the engine applies at prefill time
        # (paged_admit_ok), so a caller that respects admit() sees the
        # simulated executor's notion of "full"
        self.gate_on_pages = gate_on_pages
        self._loop = None
        self._on_complete = None

    # ------------------------------------------------------------- interface
    @property
    def owner(self) -> str:   # type: ignore[override]
        """Trace identity forwards to the engine: its wall spans carry the
        node id the Node binds onto this executor."""
        return self.engine.owner

    @owner.setter
    def owner(self, v: str) -> None:
        self.engine.owner = v

    @property
    def n_active(self) -> int:
        return self.engine.active_slots()

    def admit(self, item: GenRequest) -> bool:
        if self.gate_on_pages or self.max_pending_tokens is not None:
            snap = self.engine.load_snapshot()
            if self.gate_on_pages and self.engine.paged:
                resident = snap["active_streams"] + snap["queued_streams"] > 0
                if not paged_admit_ok(snap["free_pages"], len(item.tokens),
                                      snap["page_size"], resident=resident):
                    return False
            if not _pending_gate(snap, item, self.max_pending_tokens):
                return False
        self.engine.submit(item)
        return True

    def load(self) -> ExecutorLoad:
        snap = self.engine.load_snapshot()
        return ExecutorLoad(
            active_streams=snap["active_streams"],
            queued_streams=snap["queued_streams"],
            pending_prefill_tokens=snap["queued_prompt_tokens"],
            pending_decode_tokens=(snap["pending_decode_tokens"]
                                   + snap["queued_new_tokens"]),
            kv_used=snap["kv_used"],
            kv_budget=snap["kv_budget"],
            pages_used=snap["pages_used"],
            pages_total=snap["pages_total"],
            cache_hit_rate=float(snap["prefix_hit_rate"]),
            resident_prefixes=tuple(snap["resident_prefixes"]))

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        """Expected service seconds from the engine's measured prefill and
        decode throughput (device-synchronised wall time inside the
        respective calls, so admission/sampling overhead does not skew the
        rates)."""
        st = self.engine.stats
        if st.decode_tokens == 0 or st.decode_wall_s <= 0:
            return float("inf")      # no calibration data yet: probe-unknown
        t = output_tokens / (st.decode_tokens / st.decode_wall_s)
        if st.prefill_tokens > 0 and st.prefill_wall_s > 0:
            t += prompt_tokens / (st.prefill_tokens / st.prefill_wall_s)
        return t

    # ---------------------------------------------------------------- driving
    def has_work(self) -> bool:
        return self.engine.has_work()

    def engine_stats(self) -> EngineStats:
        return self.engine.stats

    def step(self) -> List[GenRequest]:
        finished = self.engine.step()
        for r in finished:
            if self._on_complete is not None:
                self._on_complete(r, r.started_at, r.first_token_at)
        return finished

    def drain(self) -> List[GenRequest]:
        done: List[GenRequest] = []
        while self.engine.has_work():
            done.extend(self.step())
        return done


class SpecEngineExecutor(EngineExecutor):
    """Speculative decoding behind the Executor contract (DESIGN.md
    §6.1-spec): an ``EngineExecutor`` over a spec-enabled paged ``Engine``.
    Admission, paging and driving are inherited; ``load()`` adds
    ``expected_tokens_per_step`` from the engine's online acceptance-rate
    EMA, and ``estimate()`` charges the measured draft wall time beside the
    target's verify wall."""

    def __init__(self, engine: Engine,
                 max_pending_tokens: Optional[int] = None,
                 gate_on_pages: bool = False) -> None:
        if not engine.spec:
            raise ValueError("SpecEngineExecutor requires a spec-enabled "
                             "engine (Engine(spec_draft=..., spec_k=...))")
        super().__init__(engine, max_pending_tokens, gate_on_pages)

    def expected_tokens_per_step(self) -> float:
        return spec_expected_tokens(self.engine.spec_alpha,
                                    self.engine.spec_k)

    def load(self) -> ExecutorLoad:
        return replace(super().load(),
                       expected_tokens_per_step=self.expected_tokens_per_step())

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        """Emitted tokens over the target's verify wall PLUS the draft's
        wall, so a draft that does not pay for itself shows in routing."""
        st = self.engine.stats
        wall = st.decode_wall_s + st.draft_wall_s
        if st.decode_tokens == 0 or wall <= 0:
            return float("inf")      # no calibration data yet: probe-unknown
        t = output_tokens / (st.decode_tokens / wall)
        if st.prefill_tokens > 0 and st.prefill_wall_s > 0:
            t += prompt_tokens / (st.prefill_tokens / st.prefill_wall_s)
        return t


class DisaggEngineExecutor(Executor):
    """Disaggregated prefill/decode over two paged engines (DESIGN.md
    §6.1-disagg).

    The **prefill engine** admits queued requests, prefills them, samples
    each one's first token (disagg serves TTFT from the prefill side) and
    decodes it once so its KV is in pages; each such row then leaves as a
    ``KVHandoff``, a copy of its pages and next-token logits, freeing the
    prefill pool for the next prompts.  Handoffs land FIFO on the **decode
    engine** (``Engine.accept_handoff``), which writes the pages into its
    own pool and resumes decoding where the prefill engine stopped, so
    greedy outputs equal a colocated ``Engine(paged=True)``'s.

    Admission reserves the prompt's pages against the *decode* pool with
    ``paged_admit_ok``, the rule the simulated
    ``DisaggTokenBucketExecutor`` applies, so both make the same decisions
    on the same page budget.  Decode-side preemptions go back through the
    prefill engine for a recomputed handoff.

    Both engines run on one device and one stream: a handoff's copies are
    queued before any later write to the prefill engine's released pages.
    A second stream would need an event between the gather and the reuse.
    """

    def __init__(self, prefill_engine: Engine, decode_engine: Engine,
                 max_pending_tokens: Optional[int] = None) -> None:
        if not (prefill_engine.paged and decode_engine.paged):
            raise ValueError("disaggregation requires two paged engines")
        if prefill_engine.page_size != decode_engine.page_size:
            raise ValueError("prefill/decode page_size mismatch")
        self.prefill = prefill_engine
        self.decode = decode_engine
        self.page_size = decode_engine.page_size
        self.max_pending_tokens = max_pending_tokens
        self._pending: List[KVHandoff] = []      # extracted, not yet landed
        self._reserved: Dict[str, int] = {}      # rid -> decode pages held
        self._loop = None
        self._on_complete = None

    # ------------------------------------------------------------- interface
    @property
    def owner(self) -> str:   # type: ignore[override]
        return self.prefill.owner

    @owner.setter
    def owner(self, v: str) -> None:
        # both phase engines speak for the same node in traces
        self.prefill.owner = v
        self.decode.owner = v

    @property
    def n_active(self) -> int:
        return self.prefill.active_slots() + self.decode.active_slots()

    def admit(self, item: GenRequest) -> bool:
        snap = self.decode.load_snapshot()
        free_eff = snap["free_pages"] - sum(self._reserved.values())
        resident = (snap["active_streams"] + snap["queued_streams"] > 0
                    or bool(self._reserved))
        if not paged_admit_ok(free_eff, len(item.tokens), self.page_size,
                              resident=resident):
            return False
        if self.max_pending_tokens is not None and not _pending_gate(
                self.prefill.load_snapshot(), item, self.max_pending_tokens):
            return False
        self._reserved[item.rid] = pages_for(len(item.tokens), self.page_size)
        self.prefill.submit(item)
        return True

    def load(self) -> ExecutorLoad:
        ps = self.prefill.load_snapshot()
        ds = self.decode.load_snapshot()
        return ExecutorLoad(
            active_streams=ps["active_streams"] + ds["active_streams"],
            queued_streams=ps["queued_streams"] + ds["queued_streams"],
            pending_prefill_tokens=ps["queued_prompt_tokens"],
            pending_decode_tokens=(
                ds["pending_decode_tokens"] + ds["queued_new_tokens"]
                + ps["pending_decode_tokens"] + ps["queued_new_tokens"]
                + sum(h.req.max_new - len(h.out) for h in self._pending)),
            kv_used=ds["kv_used"], kv_budget=ds["kv_budget"],
            pages_used=ds["pages_used"], pages_total=ds["pages_total"],
            prefill_kv_used=ps["kv_used"], prefill_kv_budget=ps["kv_budget"],
            transfer_inflight=len(self._pending),
            handoff_bytes=self.prefill.stats.handoff_bytes,
            # the decode pool is where KV lives long-term, so its cache is
            # what affinity routing should chase (DESIGN.md §6.1-prefix)
            cache_hit_rate=float(ds["prefix_hit_rate"]),
            resident_prefixes=tuple(ds["resident_prefixes"]))

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        """Phase-split estimate: the prompt at the prefill engine's measured
        prefill rate, the output at the decode engine's measured decode
        rate."""
        dst = self.decode.stats
        if dst.decode_tokens == 0 or dst.decode_wall_s <= 0:
            return float("inf")      # no calibration data yet: probe-unknown
        t = output_tokens / (dst.decode_tokens / dst.decode_wall_s)
        pst = self.prefill.stats
        if pst.prefill_tokens > 0 and pst.prefill_wall_s > 0:
            t += prompt_tokens / (pst.prefill_tokens / pst.prefill_wall_s)
        return t

    # ---------------------------------------------------------------- driving
    def has_work(self) -> bool:
        return (self.prefill.has_work() or self.decode.has_work()
                or bool(self._pending))

    def engine_stats(self) -> EngineStats:
        """Both engines' counters summed (peaks maxed), the view the
        serving driver prints; a handoff counts once, though both ends
        count it."""
        a, b = self.prefill.stats, self.decode.stats
        return replace(
            EngineStats(**{f: getattr(a, f) + getattr(b, f)
                           for f in EngineStats.__dataclass_fields__}),
            peak_resident=max(a.peak_resident, b.peak_resident),
            handoffs=a.handoffs, handoff_bytes=a.handoff_bytes)

    def step(self) -> List[GenRequest]:
        """One disaggregated iteration: step the prefill engine, extract its
        handoffs, step the decode engine, land the handoffs, and send
        decode-side preemptions back to the prefill side.  The extracted
        copies are queued on the device before the decode step and the
        landed rows join the next iteration's batch."""
        finished: List[GenRequest] = []
        if self.prefill.has_work():
            finished.extend(self.prefill.step())   # may finish on prefill
        # the decode engine's prefix_pin says which leading pages it holds
        # cached: pinned against eviction, not gathered, not counted
        handoffs = self.prefill.extract_handoffs(self.decode.prefix_pin)
        if handoffs:
            tr = get_tracer()
            if tr.enabled:
                t = wall_now()
                for h in handoffs:
                    tr.event("disagg.handoff", h.req.rid, self.owner, t,
                             clock=_WALL, bytes=h.kv_bytes,
                             cached_tokens=h.cached_tokens)
        self._pending.extend(handoffs)
        if self.decode.has_work():
            finished.extend(self.decode.step())
        while self._pending and self.decode.accept_handoff(self._pending[0]):
            h = self._pending.pop(0)
            self._reserved.pop(h.req.rid, None)    # reservation -> real pages
        # decode-pool preemptions recompute via the prefill side, with the
        # decode pages they will need again re-reserved; reversed because
        # requeue() head-inserts, and the oldest victim must end up first
        for r in reversed(self.decode.take_queued()):
            self._reserved[r.rid] = pages_for(len(r.tokens), self.page_size)
            self.prefill.requeue(r)
        for r in finished:
            self._reserved.pop(r.rid, None)        # incl. finished-on-prefill
            if self._on_complete is not None:
                self._on_complete(r, r.started_at, r.first_token_at)
        return finished

    def drain(self) -> List[GenRequest]:
        done: List[GenRequest] = []
        while self.has_work():
            done.extend(self.step())
        return done
