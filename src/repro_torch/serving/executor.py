"""The real-engine backend behind the Executor contract (DESIGN.md §6.1).

Port of ``repro.serving.executor``: ``EngineExecutor`` puts one PyTorch
``Engine`` (slot or paged) and ``SpecEngineExecutor`` a speculative one
behind the same four-method contract as the simulated backends (see
``repro_torch.sim.executor``): ``admit(item) -> bool``,
``load() -> ExecutorLoad``, ``estimate(prompt, output) -> seconds`` and
``bind(loop, on_complete)``, the callback receiving ``(item, started_at,
first_token_at)``.  There is no ambient event loop: the engine runs in
wall-clock time, so callers pump ``step()`` or ``drain()`` themselves.

The disaggregated executor comes with the KV handoff (ROADMAP Queue A
item 5).
"""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional

from repro_torch.serving.engine import Engine, EngineStats, GenRequest
from repro_torch.sim.executor import (Executor, ExecutorLoad, paged_admit_ok,
                                      spec_expected_tokens)


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
