"""Pluggable request-execution backends (the node's Model Manager core).

The paper's nodes run vLLM/SGLang-style continuous-batching engines, so the
latency a request sees depends on the *time-varying* batch it shares the
accelerator with — not on a share frozen at admission.  This module defines
the Executor contract every backend implements (DESIGN.md §6.1).

The Executor contract
---------------------

An ``Executor`` is what a Node's Model Manager holds instead of an analytic
service-time formula:

* ``admit(item) -> bool``   — start executing ``item`` now if KV headroom
                              allows; ``False`` means "try again after a
                              completion" (the caller keeps it queued).
* ``load() -> ExecutorLoad``— point-in-time occupancy snapshot (streams,
                              remaining tokens per phase, KV/page budgets)
                              used by routing, probing, and rebalancing.
* ``estimate(p, o) -> s``   — expected service seconds for a hypothetical
                              (prompt, output) request admitted now.
* ``bind(loop, on_complete)``— attach the driving clock (an ``EventLoop``,
                              or ``None`` for wall-clock backends) and a
                              completion callback; the callback receives
                              ``(item, started_at, first_token_at)`` so the
                              caller can derive queue wait and TTFT.

Minimal usage example (simulated backend on a bare event loop)::

    from repro_torch.sim import EventLoop, TokenBucketExecutor, make_profile

    loop, done = EventLoop(), []
    ex = TokenBucketExecutor(make_profile())
    ex.bind(loop, lambda item, started, first_tok: done.append(item))
    assert ex.admit(queued_request)      # False = KV headroom exhausted
    loop.run()                           # event-driven progress -> callback
    ex.load().kv_headroom                # snapshot for routing/probing

Backends in this module:

* ``TokenBucketExecutor``       — simulated continuous batching: token-level
  prefill then decode progress integrated piecewise-linearly by the
  ``EventLoop``, decode share recomputed on every membership change,
  admission gated by a KV *token* budget rather than a stream count.  At
  steady state (constant occupancy) it reproduces the analytic
  ``BackendProfile.service_time`` exactly; under bursts and churn,
  in-flight requests slow down and speed up as the batch shifts.  With
  ``page_size`` set, admission switches to the page-granularity rule
  shared with the real paged engine (``paged_admit_ok``): prompt pages
  must fit the free pool, decode pages accrue with generation progress.
  The sim does not model preemption — transient over-occupancy simply
  shows up as zero page headroom.  With ``prefix_cache`` additionally
  set, admission consults the shared hit rule (``prefix_hit_pages``,
  DESIGN.md §6.1-prefix): a request whose ``prefix_id`` is resident in
  the node's prefix LRU skips that many pages of prefill work, and the
  load snapshot reports ``cache_hit_rate``/``resident_prefixes`` so
  dispatch can route toward warm caches.
* ``SpecTokenBucketExecutor``  — simulated speculative decoding (DESIGN.md
  §6.1-spec): same admission as the plain bucket, but decode throughput is
  scaled by the analytic acceptance model
  ``spec_expected_tokens(alpha, k) / (1 + overhead)`` and the load
  snapshot reports ``expected_tokens_per_step`` so dispatch can route
  decode-heavy traffic toward speculation-enabled nodes.
* ``DisaggTokenBucketExecutor`` — simulated disaggregated prefill/decode
  (DESIGN.md §6.1-disagg): a prefill-only and a decode-only token bucket
  joined by an explicit KV-transfer cost model
  (``bytes = prompt_len * kv_bytes_per_token``, latency charged before
  decode admission).  Admission reserves the prompt's decode-side pages
  so every accepted transfer can eventually land.

The real-engine counterparts (``EngineExecutor``, ``SpecEngineExecutor``
and ``DisaggEngineExecutor`` over the PyTorch ``Engine``) live in
``repro_torch.serving.executor``.

This module is the port's own copy of ``repro.sim.executor``: it imports
nothing of ``repro``, and ``tests/test_torch_imports.py`` pins its
predicates equal to the reference.

This module (plus ``servicemodel``) is the only sanctioned caller of
``BackendProfile.service_time`` — a grep-guard in ``tests/test_compat.py``
keeps frozen-share scheduling from creeping back in.
"""

from __future__ import annotations

import math
import zlib
from abc import ABC, abstractmethod
from collections import OrderedDict
from dataclasses import dataclass, replace
from typing import Any, Callable, List, Optional, Tuple

from repro_torch.obs import get_tracer
from repro_torch.sim.events import EventLoop
from repro_torch.sim.servicemodel import (_DIGEST_STALENESS_TAU_S,
                                          _KV_BYTES_PER_TOKEN,
                                          _KV_TOKENS_PER_STREAM,
                                          _PREFIX_FINGERPRINT_K,
                                          _PREFIX_HIT_EMA_BETA, _SPEC_ALPHA0,
                                          _SPEC_K, _SPEC_OVERHEAD,
                                          _TRANSFER_BASE_S,
                                          _TRANSFER_BYTES_PER_S,
                                          BackendProfile)

# completion callback: (item, started_at, first_token_at) in sim/wall time
CompletionFn = Callable[[Any, float, float], None]

# token-progress slack absorbing float error in rate*dt integration: 1e-6
# tokens is ~1e-8 s of decode — far below any latency we report
_EPS = 1e-6


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def pages_for(tokens: int, page_size: int) -> int:
    """KV pages needed to hold ``tokens`` (every sequence owns >= 1 page)."""
    return max(1, -(-int(tokens) // int(page_size)))


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def paged_admit_ok(free_pages: int, prompt_tokens: int, page_size: int,
                   resident: bool) -> bool:
    """THE paged admission rule, shared by the simulated and real backends
    (DESIGN.md §6.1, paged backend): a request is admitted when its
    *prompt* pages fit the free pool — its decode pages are claimed one at
    a time as it generates (preempt-and-requeue reclaims them under
    pressure).  An empty backend always admits one request so oversized
    prompts cannot deadlock the queue.
    """
    return (not resident) or pages_for(prompt_tokens, page_size) <= free_pages


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def quantized_pages(num_pages: int, quantized: bool) -> int:
    """THE quantized-pool capacity rule, shared by the simulated and real
    backends (DESIGN.md §6.1-paged): int8 KV pages are half the bytes of
    fp pages, so the same HBM budget holds **2x the pages** — admission and
    preemption already meter pages, so capacity doubles with no further
    rule changes.  ``num_pages`` is the fp-page count of the budget; the
    scale pages ride in a parallel pool whose footprint (1/head_dim of the
    values) is treated as overhead, not metered capacity.
    """
    return int(num_pages) * 2 if quantized else int(num_pages)


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def prefix_hit_pages(prompt_tokens: int, page_size: int,
                     matched_tokens: int) -> int:
    """THE prefix-cache hit rule, shared by the simulated and real backends
    (DESIGN.md §6.1-prefix): a page-aligned hash-chain lookup that matched
    ``matched_tokens`` of the prompt reuses that many *full* pages from the
    cache.  The prompt's final page is always recomputed — its fresh forward
    is what produces the first-token logits — so hits are capped at
    ``pages_for(prompt) - 1`` and the recomputed suffix is never empty.
    Partial pages never share (copy-on-write happens at page granularity:
    a mid-page divergence is simply a hash miss at that chain depth).
    """
    ps = max(1, int(page_size))
    full = max(0, int(matched_tokens)) // ps
    return max(0, min(full, pages_for(prompt_tokens, ps) - 1))


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def prefix_fingerprint_id(prefix_id: str) -> int:
    """Stable 32-bit identity of a named shared prefix — what a
    ``LoadDigest.resident_prefixes`` fingerprint carries and what
    cache-affinity dispatch (DESIGN.md §6.1-prefix) compares a request's
    ``prefix_id`` against; kept checksum-cheap because routing computes it
    per dispatch decision."""
    return zlib.crc32(str(prefix_id).encode("utf-8"))


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def spec_expected_tokens(alpha: float, k: int) -> float:
    """THE speculative-decoding acceptance model, shared by the simulated
    and real backends (DESIGN.md §6.1-spec): with per-token draft
    acceptance rate ``alpha`` and ``k`` draft tokens per verify step, the
    expected tokens emitted per target forward is the truncated geometric
    sum ``(1 - alpha^(k+1)) / (1 - alpha)`` — between 1 (every draft
    rejected: only the pending token survives) and ``k + 1`` (every draft
    accepted plus the bonus correction).
    """
    a = min(max(float(alpha), 0.0), 1.0)
    k = max(0, int(k))
    if a >= 1.0:
        return float(k + 1)
    return (1.0 - a ** (k + 1)) / (1.0 - a)


@dataclass(frozen=True)
class ExecutorLoad:
    """Point-in-time snapshot of an executor's occupancy.

    ``active_streams`` are requests holding compute now; ``queued_streams``
    are admitted but waiting for a slot (real engine only).  Token counts
    are *remaining* work; ``kv_used``/``kv_budget`` express KV-memory
    pressure in tokens.  Paged backends additionally report page-pool
    occupancy (``pages_total`` stays 0 for contiguous backends).

    Disaggregated backends (DESIGN.md §6.1-disagg) split the budgets by
    phase: ``kv_used``/``kv_budget``/``pages_*`` track the *decode* pool
    (where KV lives long-term), ``prefill_kv_used``/``prefill_kv_budget``
    the prefill pool, and ``transfer_inflight`` counts streams handed off
    but not yet decode-admitted.  Colocated backends leave
    ``prefill_kv_budget`` at 0, so ``prefill_headroom`` and
    ``decode_headroom`` both collapse to ``kv_headroom`` — phase-aware
    dispatch (``Network._phase_pressure``) reads the two headrooms without
    caring which backend produced them.
    """

    active_streams: int
    queued_streams: int
    pending_prefill_tokens: int
    pending_decode_tokens: int
    kv_used: int
    kv_budget: int
    pages_used: int = 0
    pages_total: int = 0
    prefill_kv_used: int = 0
    prefill_kv_budget: int = 0   # 0 = colocated: both phases share kv_budget
    transfer_inflight: int = 0   # disagg: handed off, not yet decode-admitted
    handoff_bytes: int = 0       # disagg: cumulative KV bytes handed off
    # speculative backends (DESIGN.md §6.1-spec): expected tokens emitted
    # per target decode step, (1 - alpha^(k+1)) / (1 - alpha) for draft
    # acceptance rate alpha and depth k.  1.0 for non-speculative backends,
    # so dispatch can divide decode pressure by it unconditionally.
    expected_tokens_per_step: float = 1.0
    # prefix-caching backends (DESIGN.md §6.1-prefix): EMA of the fraction
    # of admitted prompt tokens served from the page cache, plus a
    # fingerprint of up to _PREFIX_FINGERPRINT_K resident prefix identities
    # (prefix_fingerprint_id values, most recently touched first) so
    # cache-affinity dispatch can break near-ties toward the node already
    # holding a request's prefix.  0.0/() for cache-less backends.
    cache_hit_rate: float = 0.0
    resident_prefixes: Tuple[int, ...] = ()

    @property
    def kv_headroom(self) -> float:
        """Free fraction of the KV budget, in [0, 1]."""
        if self.kv_budget <= 0:
            return 1.0
        return max(0.0, 1.0 - self.kv_used / self.kv_budget)

    @property
    def page_headroom(self) -> float:
        """Free fraction of the KV page pool, in [0, 1] (1.0 = unpaged)."""
        if self.pages_total <= 0:
            return 1.0
        return max(0.0, 1.0 - self.pages_used / self.pages_total)

    @property
    def prefill_headroom(self) -> float:
        """Free fraction of the prefill-phase KV budget, in [0, 1].

        Colocated backends share one pool across phases, so this equals
        ``kv_headroom``; disaggregated backends report their dedicated
        prefill pool."""
        if self.prefill_kv_budget <= 0:
            return self.kv_headroom
        return max(0.0, 1.0 - self.prefill_kv_used / self.prefill_kv_budget)

    @property
    def decode_headroom(self) -> float:
        """Free fraction of the decode-phase KV budget, in [0, 1]
        (``kv_used``/``kv_budget`` track the decode pool for disaggregated
        backends, the shared pool for colocated ones)."""
        return self.kv_headroom


@dataclass(frozen=True)
class LoadDigest:
    """Compact, gossip-borne summary of an ``ExecutorLoad`` snapshot
    (DESIGN.md §6.2-gossip).

    This is what a node publishes about itself on every gossip round: just
    enough for a *remote* router to rank it — the two phase headrooms, the
    phase backlogs, the speculative speedup factor, the cumulative handoff
    byte counter (so observers can learn transfer rates from deltas), and
    the origin timestamp ``t`` that staleness discounting keys on.  It is
    deliberately a projection, not the full ``ExecutorLoad``: budgets and
    page counts stay node-local.

    Construction is confined to the executor layer — build digests via
    ``Executor.digest()`` / ``make_load_digest`` (enforced by the
    ``layering/digest-construction`` rule in ``repro.analysis``).
    """

    t: float                       # origin sim-time the snapshot was taken
    prefill_headroom: float
    decode_headroom: float
    pending_prefill_tokens: int
    pending_decode_tokens: int
    expected_tokens_per_step: float
    handoff_bytes: int
    # prefix caching (DESIGN.md §6.1-prefix): the hit-rate EMA and the
    # resident-prefix fingerprint travel with every digest, so a remote
    # router knows where a request's prefix is already warm without any
    # extra gossip traffic (the digest already piggybacks on heartbeats).
    cache_hit_rate: float = 0.0
    resident_prefixes: Tuple[int, ...] = ()


def make_load_digest(load: ExecutorLoad, now: float) -> LoadDigest:
    """Project an ``ExecutorLoad`` snapshot into its gossip digest."""
    # repro: allow[layering/digest-construction] the port's own copy of repro.sim/obs
    return LoadDigest(
        t=float(now),
        prefill_headroom=load.prefill_headroom,
        decode_headroom=load.decode_headroom,
        pending_prefill_tokens=load.pending_prefill_tokens,
        pending_decode_tokens=load.pending_decode_tokens,
        expected_tokens_per_step=load.expected_tokens_per_step,
        handoff_bytes=load.handoff_bytes,
        cache_hit_rate=load.cache_hit_rate,
        resident_prefixes=load.resident_prefixes,
    )


# repro: allow[twin-drift/shared-name] the port's own copy of repro.sim; tests/test_torch_imports.py pins it equal
def digest_staleness_weight(age_s: float,
                            tau_s: float = _DIGEST_STALENESS_TAU_S) -> float:
    """THE staleness-discount rule, shared by routing and its sim twin
    (DESIGN.md §6.2-gossip): a digest of age ``age_s`` is trusted with
    weight ``exp(-age / tau)``; the pressure a router infers from it
    regresses toward the neutral prior as the weight decays, so a
    seconds-old digest still steers dispatch while a minutes-old one is
    as good as no information.
    """
    return math.exp(-max(0.0, float(age_s)) / float(tau_s))


class Executor(ABC):
    """Backend-agnostic execution contract held by a Node's Model Manager."""

    # trace identity: who emitted a span (DESIGN.md §Observability).  Set
    # by the owning Node at bind time; standalone executors keep "".
    owner: str = ""

    def digest(self, now: float) -> LoadDigest:
        """Gossip digest of the current load snapshot (DESIGN.md
        §6.2-gossip); the only sanctioned way to build a ``LoadDigest``
        outside this module."""
        return make_load_digest(self.load(), now)

    def bind(self, loop: Optional[EventLoop], on_complete: CompletionFn) -> None:
        """Attach the driving clock and the completion callback."""
        self._loop = loop
        self._on_complete = on_complete

    @property
    @abstractmethod
    def n_active(self) -> int:
        """Number of streams currently holding compute."""

    @abstractmethod
    def admit(self, item: Any) -> bool:
        """Start executing ``item`` if KV headroom allows; False = try later."""

    @abstractmethod
    def load(self) -> ExecutorLoad:
        """Snapshot of current occupancy (routing / probing / rebalance)."""

    @abstractmethod
    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        """Expected service seconds for a hypothetical request admitted now."""


class _Stream:
    """One in-flight request inside the TokenBucketExecutor."""

    __slots__ = ("item", "prompt_left", "output_left", "prompt_total",
                 "output_total", "kv_tokens", "decoding", "started_at",
                 "first_token_at")

    def __init__(self, item: Any, prompt: int, output: int, now: float,
                 cached_tokens: int = 0) -> None:
        self.item = item
        self.prompt_total = max(1, prompt)
        self.output_total = max(1, output)
        # prefix-cache hits (DESIGN.md §6.1-prefix) skip prefill *work* for
        # the cached pages; the stream still holds its full prompt's pages
        # (tokens_held charges prompt_total), so only latency changes.
        self.prompt_left = float(max(1, self.prompt_total - cached_tokens))
        self.output_left = float(self.output_total)
        self.kv_tokens = self.prompt_total + self.output_total
        self.decoding = False
        self.started_at = now
        self.first_token_at: Optional[float] = None

    def tokens_held(self) -> int:
        """KV tokens this stream physically occupies right now (prompt plus
        decoded-so-far) — what a paged pool charges, vs the reserved
        ``kv_tokens`` a contiguous allocation charges up front."""
        if not self.decoding:
            return self.prompt_total
        decoded = self.output_total - max(0.0, self.output_left)
        return self.prompt_total + int(decoded)


class TokenBucketExecutor(Executor):
    """Simulated continuous batching: exact event-driven token integration.

    Between membership changes every stream progresses linearly (prefill at
    ``prefill_tps`` unshared, decode at ``decode_tps / share`` with
    ``share = max(1, n_active / saturation)``), so it suffices to advance
    all streams to ``now`` and re-derive the next phase boundary whenever
    the batch changes — no fixed tick quantum, no drift.
    """

    def __init__(self, profile: BackendProfile,
                 page_size: Optional[int] = None,
                 kv_quant: bool = False,
                 prefix_cache: bool = False) -> None:
        self.profile = profile
        self.kv_budget = int(getattr(profile, "kv_token_budget", 0)
                             or profile.max_concurrency * _KV_TOKENS_PER_STREAM)
        # page-granularity admission mode: the same KV budget expressed as a
        # pool of fixed-size pages, admitted on *prompt* pages only
        # (paged_admit_ok) — decode pages accrue as streams generate, so
        # admission matches the real paged engine's notion of "full".
        # ``kv_quant`` applies the shared quantized-pool capacity rule
        # (quantized_pages): int8 pages double the pool the same HBM holds,
        # exactly as Engine(paged=True, kv_quant) does.
        self.page_size = page_size
        self.kv_quant = bool(kv_quant)
        self.pages_total = (quantized_pages(self.kv_budget // page_size,
                                            self.kv_quant)
                            if page_size else 0)
        # cross-request prefix caching twin (DESIGN.md §6.1-prefix): the sim
        # models the *latency* effect — a request whose ``prefix_id`` is
        # resident skips ``prefix_hit_pages`` pages of prefill work — plus
        # the hit-rate EMA and resident-prefix fingerprint that routing
        # reads.  Page-pool *sharing* itself is not modeled: holdings stay
        # fully charged, so admission is conservative vs the real engine.
        # The cache is the fingerprint: an LRU of at most
        # _PREFIX_FINGERPRINT_K prefix ids -> shared-prefix token length.
        self.prefix_cache = bool(prefix_cache) and page_size is not None
        self._prefix_lru: "OrderedDict[str, int]" = OrderedDict()
        self.prefix_hit_rate = 0.0
        self.prefix_hit_tokens = 0
        self.prefix_lookup_tokens = 0
        self._streams: List[_Stream] = []
        self._last_t = 0.0
        self._pending_ev = None
        self._loop: Optional[EventLoop] = None
        self._on_complete: Optional[CompletionFn] = None

    # ------------------------------------------------------------- interface
    @property
    def n_active(self) -> int:
        return len(self._streams)

    def _pages_used(self) -> int:
        return sum(pages_for(s.tokens_held(), self.page_size)
                   for s in self._streams)

    def admit(self, item: Any) -> bool:
        qr = item
        if self.page_size:
            self._advance()          # page holdings grow with decode progress
            free = self.pages_total - self._pages_used()
            if not paged_admit_ok(free, qr.req.prompt_tokens, self.page_size,
                                  resident=bool(self._streams)):
                return False
        else:
            kv = max(1, qr.req.prompt_tokens) + max(1, qr.req.output_tokens)
            used = sum(s.kv_tokens for s in self._streams)
            # token-budget admission; an empty backend always takes one
            # request so oversized prompts cannot deadlock the queue
            if self._streams and used + kv > self.kv_budget:
                return False
        self._advance()
        cached = self._prefix_lookup(qr.req) if self.prefix_cache else 0
        self._streams.append(_Stream(qr, qr.req.prompt_tokens,
                                     qr.req.output_tokens, self._loop.now,
                                     cached_tokens=cached))
        self._reschedule()
        return True

    def _prefix_lookup(self, req: Any) -> int:
        """Sim twin of the engine's hash-chain lookup (DESIGN.md
        §6.1-prefix): cached tokens for ``req``, updating the LRU, the
        hit-rate EMA, and the cumulative hit/lookup token counters."""
        prompt = max(1, int(req.prompt_tokens))
        pid = getattr(req, "prefix_id", None)
        cached = 0
        if pid is not None:
            shared = max(0, int(getattr(req, "prefix_tokens", 0)))
            matched = min(self._prefix_lru.get(pid, 0), shared)
            cached = prefix_hit_pages(prompt, self.page_size,
                                      matched) * self.page_size
            # after this prefill the request's own shared prefix is resident
            self._prefix_lru[pid] = max(self._prefix_lru.get(pid, 0), shared)
            self._prefix_lru.move_to_end(pid)
            while len(self._prefix_lru) > _PREFIX_FINGERPRINT_K:
                self._prefix_lru.popitem(last=False)
        self.prefix_lookup_tokens += prompt
        self.prefix_hit_tokens += cached
        self.prefix_hit_rate += _PREFIX_HIT_EMA_BETA * (cached / prompt
                                                       - self.prefix_hit_rate)
        return cached

    def load(self) -> ExecutorLoad:
        self._advance()
        if self.page_size:
            pages_used = self._pages_used()
            kv_used = pages_used * self.page_size
            kv_budget = self.pages_total * self.page_size
        else:
            pages_used = 0
            kv_used = sum(s.kv_tokens for s in self._streams)
            kv_budget = self.kv_budget
        return ExecutorLoad(
            active_streams=len(self._streams),
            queued_streams=0,
            pending_prefill_tokens=int(sum(s.prompt_left
                                           for s in self._streams
                                           if not s.decoding)),
            pending_decode_tokens=int(sum(s.output_left
                                          for s in self._streams)),
            kv_used=kv_used,
            kv_budget=kv_budget,
            pages_used=pages_used,
            pages_total=self.pages_total,
            cache_hit_rate=self.prefix_hit_rate if self.prefix_cache else 0.0,
            resident_prefixes=tuple(
                prefix_fingerprint_id(pid)
                for pid in reversed(self._prefix_lru))
            if self.prefix_cache else ())

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        # repro: allow[layering/service-time] the port's own copy of repro.sim/obs
        return self.profile.service_time(prompt_tokens, output_tokens,
                                         len(self._streams) + 1)

    # -------------------------------------------------------------- dynamics
    def _decode_rate(self) -> float:
        share = max(1.0, len(self._streams) / self.profile.saturation)
        return self.profile.decode_tps / share

    def _rate(self, s: _Stream, decode_rate: float) -> float:
        return decode_rate if s.decoding else self.profile.prefill_tps

    def _advance(self) -> None:
        """Integrate token progress from the last update to ``now``."""
        now = self._loop.now
        dt = now - self._last_t
        self._last_t = now
        if dt <= 0.0 or not self._streams:
            return
        dec = self._decode_rate()
        for s in self._streams:
            if s.decoding:
                s.output_left -= dec * dt
            else:
                s.prompt_left -= self.profile.prefill_tps * dt

    def _reschedule(self) -> None:
        """Re-derive the earliest phase boundary and point one event at it.

        Called after every membership change; also flips streams whose
        boundary is (numerically) now, firing completions.
        """
        done: List[_Stream] = []
        for s in self._streams:
            if not s.decoding and s.prompt_left <= _EPS:
                s.decoding = True
                s.prompt_left = 0.0
                s.first_token_at = self._loop.now
            if s.decoding and s.output_left <= _EPS:
                done.append(s)
        if done:
            for s in done:
                self._streams.remove(s)
        if self._pending_ev is not None:
            self._loop.cancel(self._pending_ev)
            self._pending_ev = None
        if self._streams:
            dec = self._decode_rate()
            dt = min((s.output_left if s.decoding else s.prompt_left)
                     / self._rate(s, dec) for s in self._streams)
            self._pending_ev = self._loop.schedule(max(0.0, dt),
                                                   self._on_boundary)
        # completions fire after the reschedule: the callback may re-enter
        # admit() (node pulls the next queued request) and reschedule again
        for s in done:
            ft = s.first_token_at if s.first_token_at is not None \
                else self._loop.now
            tr = get_tracer()
            if tr.enabled:
                rid = getattr(getattr(s.item, "req", None), "rid", "")
                tr.span("engine.prefill", rid, self.owner, s.started_at, ft,
                        prompt_tokens=s.prompt_total)
                tr.span("engine.decode", rid, self.owner, ft,
                        self._loop.now, output_tokens=s.output_total)
            self._on_complete(s.item, s.started_at, ft)

    def _on_boundary(self) -> None:
        self._pending_ev = None
        self._advance()
        self._reschedule()


class SpecTokenBucketExecutor(TokenBucketExecutor):
    """Simulated speculative-decoding backend (DESIGN.md §6.1-spec).

    Identical to ``TokenBucketExecutor`` in admission (same KV token/page
    budgets: speculation changes how fast decode *drains*, not how much KV
    a resident stream holds), but decode throughput is scaled by the
    analytic acceptance model: each target forward verifies ``spec_k``
    draft tokens and emits ``spec_expected_tokens(alpha, k)`` tokens in
    expectation, at ``1 + spec_overhead`` times the cost of a plain decode
    step (the draft forwards).  Net per-stream decode rate::

        decode_tps * spec_expected_tokens(alpha, k) / (1 + overhead) / share

    ``spec_alpha`` defaults to the same ``_SPEC_ALPHA0`` constant that seeds
    the real engine's online EMA, so a freshly booted sim node and a
    freshly booted ``SpecEngineExecutor`` report the same
    ``expected_tokens_per_step`` and make identical admission decisions
    (agreement test in ``tests/test_spec.py``).
    """

    def __init__(self, profile: BackendProfile,
                 page_size: Optional[int] = None, *,
                 spec_k: int = _SPEC_K, spec_alpha: float = _SPEC_ALPHA0,
                 spec_overhead: float = _SPEC_OVERHEAD) -> None:
        super().__init__(profile, page_size)
        self.spec_k = int(spec_k)
        self.spec_alpha = float(spec_alpha)
        self.spec_overhead = float(spec_overhead)

    def expected_tokens_per_step(self) -> float:
        return spec_expected_tokens(self.spec_alpha, self.spec_k)

    def _speedup(self) -> float:
        """Net decode-throughput multiplier (> 1 when speculation pays)."""
        return self.expected_tokens_per_step() / (1.0 + self.spec_overhead)

    def _decode_rate(self) -> float:
        return super()._decode_rate() * self._speedup()

    def load(self) -> ExecutorLoad:
        return replace(super().load(),
                       expected_tokens_per_step=self.expected_tokens_per_step())

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        # repro: allow[layering/service-time] the port's own copy of repro.sim/obs
        return self.profile.service_time(prompt_tokens,
                                         output_tokens / self._speedup(),
                                         len(self._streams) + 1)


class DisaggTokenBucketExecutor(Executor):
    """Simulated disaggregated prefill/decode backend (DESIGN.md §6.1-disagg).

    A prefill-only and a decode-only token bucket joined by an explicit
    KV-transfer cost model.  A request moves through four stages:

    1. **prefill** — prompt tokens at ``prefill_profile.prefill_tps``
       (unshared, like the colocated backend); its prompt's KV occupies the
       *prefill* pool.  The first output token is emitted by the prefill
       side the instant prefill finishes (``first_token_at``), mirroring
       the real ``DisaggEngineExecutor``.
    2. **transfer** — the populated KV leaves the prefill pool (the copy
       frees it) and crosses the wire:
       ``transfer_s = transfer_base_s + prompt_len * kv_bytes_per_token /
       transfer_bytes_per_s``.
    3. **handoff queue** — landed transfers wait FIFO for decode-side
       admission (head-of-line blocking keeps sim and engine agreement
       deterministic).
    4. **decode** — output tokens at ``profile.decode_tps / share`` with
       the share recomputed on every decode-membership change, exactly as
       in ``TokenBucketExecutor``.

    Admission gates on **both** pools: the prompt's pages (tokens) must fit
    the free prefill pool next to the prompts currently prefilling, and its
    decode-side pages must fit the decode pool after subtracting the
    reservations of every earlier-admitted stream still staging (prefill /
    transfer / handoff) — so every accepted transfer can eventually land
    (DistServe-style decode-capacity reservation).  With ``page_size`` set
    both gates use ``paged_admit_ok``, the same rule the real engines
    apply, so sim and engine admission decisions agree on identical
    budgets.

    Like the colocated ``TokenBucketExecutor``, the sim does not model
    decode-side preemption: landing charges prompt pages only, and a
    stream's page holdings then grow with decode progress, so the decode
    pool can transiently over-occupy under pressure where the real engine
    would preempt — that shows up as zero decode headroom (clamped), not
    as an error.
    """

    def __init__(self, profile: BackendProfile,
                 prefill_profile: Optional[BackendProfile] = None, *,
                 page_size: Optional[int] = None,
                 kv_bytes_per_token: int = _KV_BYTES_PER_TOKEN,
                 transfer_bytes_per_s: float = _TRANSFER_BYTES_PER_S,
                 transfer_base_s: float = _TRANSFER_BASE_S) -> None:
        self.profile = profile                       # decode side
        self.prefill_profile = prefill_profile or profile
        self.decode_budget = int(getattr(profile, "kv_token_budget", 0)
                                 or profile.max_concurrency
                                 * _KV_TOKENS_PER_STREAM)
        self.prefill_budget = int(
            getattr(self.prefill_profile, "kv_token_budget", 0)
            or self.prefill_profile.max_concurrency * _KV_TOKENS_PER_STREAM)
        self.page_size = page_size
        self.decode_pages_total = (self.decode_budget // page_size
                                   if page_size else 0)
        self.prefill_pages_total = (self.prefill_budget // page_size
                                    if page_size else 0)
        self.kv_bytes_per_token = kv_bytes_per_token
        self.transfer_bytes_per_s = transfer_bytes_per_s
        self.transfer_base_s = transfer_base_s
        self._prefill: List[_Stream] = []
        self._transfers: List[_Stream] = []    # on the wire
        self._handoffs: List[_Stream] = []     # landed, awaiting admission
        self._decode: List[_Stream] = []
        self._handoff_bytes = 0                # cumulative KV bytes on the wire
        self._last_t = 0.0
        self._pending_ev = None
        self._loop: Optional[EventLoop] = None
        self._on_complete: Optional[CompletionFn] = None

    def transfer_s(self, prompt_tokens: int) -> float:
        """Wire time for one handoff: base cost + KV bytes over the link."""
        return (self.transfer_base_s + max(1, prompt_tokens)
                * self.kv_bytes_per_token / self.transfer_bytes_per_s)

    # ------------------------------------------------------------- interface
    @property
    def n_active(self) -> int:
        return len(self._prefill) + len(self._decode)

    def _staging(self) -> List[_Stream]:
        """Streams admitted but not yet decoding — they hold decode-side
        reservations (prompt pages) so their transfer can always land."""
        return self._prefill + self._transfers + self._handoffs

    def _decode_pages_used(self) -> int:
        return sum(pages_for(s.tokens_held(), self.page_size)
                   for s in self._decode)

    def _prefill_pages_used(self) -> int:
        return sum(pages_for(s.prompt_total, self.page_size)
                   for s in self._prefill)

    def admit(self, item: Any) -> bool:
        qr = item
        self._advance()
        p, o = qr.req.prompt_tokens, qr.req.output_tokens
        staging = self._staging()
        if self.page_size:
            pre_free = self.prefill_pages_total - self._prefill_pages_used()
            if not paged_admit_ok(pre_free, p, self.page_size,
                                  resident=bool(self._prefill)):
                return False
            reserved = sum(pages_for(s.prompt_total, self.page_size)
                           for s in staging)
            free_eff = (self.decode_pages_total - self._decode_pages_used()
                        - reserved)
            if not paged_admit_ok(free_eff, p, self.page_size,
                                  resident=bool(self._decode)
                                  or bool(staging)):
                return False
        else:
            pre_used = sum(s.prompt_total for s in self._prefill)
            if self._prefill and pre_used + max(1, p) > self.prefill_budget:
                return False
            kv = max(1, p) + max(1, o)
            used = sum(s.kv_tokens for s in self._decode)
            reserved = sum(s.kv_tokens for s in staging)
            if ((self._decode or staging)
                    and used + reserved + kv > self.decode_budget):
                return False
        self._prefill.append(_Stream(qr, p, o, self._loop.now))
        self._reschedule()
        return True

    def load(self) -> ExecutorLoad:
        self._advance()
        wire = self._transfers + self._handoffs
        if self.page_size:
            pre_used = self._prefill_pages_used() * self.page_size
            pre_budget = self.prefill_pages_total * self.page_size
            pages_used = self._decode_pages_used()
            kv_used = pages_used * self.page_size
            kv_budget = self.decode_pages_total * self.page_size
        else:
            pre_used = sum(s.prompt_total for s in self._prefill)
            pre_budget = self.prefill_budget
            pages_used = 0
            kv_used = sum(s.kv_tokens for s in self._decode)
            kv_budget = self.decode_budget
        return ExecutorLoad(
            active_streams=len(self._prefill) + len(self._decode),
            queued_streams=0,
            pending_prefill_tokens=int(sum(s.prompt_left
                                           for s in self._prefill)),
            pending_decode_tokens=int(sum(s.output_left for s in self._decode)
                                      + sum(s.output_total for s in wire)),
            kv_used=kv_used,
            kv_budget=kv_budget,
            pages_used=pages_used,
            pages_total=self.decode_pages_total,
            prefill_kv_used=pre_used,
            prefill_kv_budget=pre_budget,
            transfer_inflight=len(wire),
            handoff_bytes=self._handoff_bytes)

    def estimate(self, prompt_tokens: int, output_tokens: int) -> float:
        share = max(1.0, (len(self._decode) + 1) / self.profile.saturation)
        return (prompt_tokens / self.prefill_profile.prefill_tps
                + self.transfer_s(prompt_tokens)
                + output_tokens / (self.profile.decode_tps / share))

    # -------------------------------------------------------------- dynamics
    def _decode_rate(self) -> float:
        share = max(1.0, len(self._decode) / self.profile.saturation)
        return self.profile.decode_tps / share

    def _advance(self) -> None:
        now = self._loop.now
        dt = now - self._last_t
        self._last_t = now
        if dt <= 0.0:
            return
        for s in self._prefill:
            s.prompt_left -= self.prefill_profile.prefill_tps * dt
        if self._decode:
            dec = self._decode_rate()
            for s in self._decode:
                s.output_left -= dec * dt

    def _admit_decode(self) -> None:
        """Land waiting handoffs FIFO while the decode pool takes them."""
        moved = False
        while self._handoffs:
            s = self._handoffs[0]
            if self.page_size:
                free = self.decode_pages_total - self._decode_pages_used()
                if not paged_admit_ok(free, s.prompt_total, self.page_size,
                                      resident=bool(self._decode)):
                    break
            else:
                used = sum(d.kv_tokens for d in self._decode)
                if self._decode and used + s.kv_tokens > self.decode_budget:
                    break
            self._handoffs.pop(0)
            s.decoding = True
            self._decode.append(s)
            moved = True
        if moved:
            self._reschedule()

    def _on_transfer_landed(self, s: _Stream) -> None:
        self._advance()
        self._transfers.remove(s)
        self._handoffs.append(s)
        tr = get_tracer()
        if tr.enabled:
            # the wire leg: transfer starts the instant prefill finishes
            # (first_token_at) and lands now (DESIGN.md §Observability)
            rid = getattr(getattr(s.item, "req", None), "rid", "")
            tr.span("disagg.handoff", rid, self.owner,
                    s.first_token_at if s.first_token_at is not None
                    else self._loop.now,
                    self._loop.now,
                    bytes=max(1, s.prompt_total) * self.kv_bytes_per_token)
        self._admit_decode()

    def _reschedule(self) -> None:
        """Flip phase boundaries that are (numerically) due, then point one
        event at the earliest remaining boundary.  Mirrors
        ``TokenBucketExecutor._reschedule``; the extra boundary here is
        prefill completion, which emits the first token and starts the
        KV transfer (the copy frees the prefill pool)."""
        now = self._loop.now
        handed = [s for s in self._prefill if s.prompt_left <= _EPS]
        for s in handed:
            self._prefill.remove(s)
            s.prompt_left = 0.0
            s.first_token_at = now
            self._transfers.append(s)
            self._handoff_bytes += (max(1, s.prompt_total)
                                    * self.kv_bytes_per_token)
            self._loop.schedule(self.transfer_s(s.prompt_total),
                                lambda s=s: self._on_transfer_landed(s))
        done = [s for s in self._decode if s.output_left <= _EPS]
        for s in done:
            self._decode.remove(s)
        if self._pending_ev is not None:
            self._loop.cancel(self._pending_ev)
            self._pending_ev = None
        dts = [s.prompt_left / self.prefill_profile.prefill_tps
               for s in self._prefill]
        if self._decode:
            dec = self._decode_rate()
            dts += [s.output_left / dec for s in self._decode]
        if dts:
            self._pending_ev = self._loop.schedule(max(0.0, min(dts)),
                                                   self._on_boundary)
        if done:
            # freed decode capacity lands waiting handoffs before the
            # completion callbacks re-enter admit() (node queue refill)
            self._admit_decode()
            for s in done:
                ft = s.first_token_at if s.first_token_at is not None \
                    else now
                tr = get_tracer()
                if tr.enabled:
                    rid = getattr(getattr(s.item, "req", None), "rid", "")
                    tr.span("engine.prefill", rid, self.owner,
                            s.started_at, ft, prompt_tokens=s.prompt_total)
                    # covers wire + handoff queue + decode (the nested
                    # disagg.handoff span shows the wire leg)
                    tr.span("engine.decode", rid, self.owner, ft, now,
                            output_tokens=s.output_total, stage="disagg")
                self._on_complete(s.item, s.started_at, ft)

    def _on_boundary(self) -> None:
        self._pending_ev = None
        self._advance()
        self._reschedule()
