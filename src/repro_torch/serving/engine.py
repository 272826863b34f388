"""A small batched serving engine on PyTorch -- the node's Model Manager
backend.

Port of ``repro.serving.engine`` in its modes:

* **slot** (``paged=False``, the default; DESIGN.md §6.1): a persistent
  decode cache of ``max_batch`` row slots, each resident sequence decoding
  at its own depth.  After every decode step finished sequences leave and
  queued requests are prefilled into the freed slots (``continuous=False``
  refills only when the batch is empty: wave batching).  Admission reserves
  ``pad(prompt) + pad(max_new)`` cache positions per request.
* **paged** (``paged=True``; DESIGN.md §6.1, paged backend): a fixed pool of
  page-sized KV blocks with a per-sequence block table, grown one page at a
  time during decode.  Admission charges a request's *prompt* pages only,
  finished sequences return their pages to the pool, and when the pool
  runs out mid-decode the most recently admitted sequence is preempted --
  its pages reclaimed, its request requeued at the head of the queue for a
  greedy-deterministic restart.
* **speculative** (``paged=True, spec_draft=(cfg, params)``; DESIGN.md
  §6.1-spec): a small same-tokenizer draft model, decoding on its own slot
  cache, proposes ``spec_k`` tokens greedily; the target verifies the
  pending token and the drafts in ONE paged verify forward and emits the
  longest draft prefix matching its own greedy choices.  Greedy-only.
* **prefix cache** (``paged=True, prefix_cache=True``; DESIGN.md
  §6.1-prefix): every full prompt page is content-addressed by a
  page-aligned crc32 hash chain and carries a holder refcount; a prompt
  whose head is already resident shares those pages and computes only
  its uncached suffix, in ONE paged verify forward against them (the warm
  prefill).  A divergence mid-page is a chain miss (copy-on-write at page
  granularity).  Released cached pages go *cold*: still addressable,
  evicted least recently used first, only when the free list is empty.

Each mode takes int8 KV (``cfg.kv_quant``; DESIGN.md §6.1-paged): slot
caches and page pools hold int8 K/V with bf16 per-(token, head) scales,
quantized on write.  A paged engine's pool then holds twice the pages of
the same budget (``quantized_pages``, the rule the simulator shares), and
one free list covers the K/V pages and their scale pages.  A speculative
engine's draft keeps fp caches (``cfg.draft()`` turns int8 off).

Prompts are right-padded, which causal attention keeps inert, so a
request's greedy output does not depend on what it is batched with: the
port's greedy streams equal the reference engine's token for token on the
same weights, in every mode.

A paged engine is also either end of a disaggregated pair (DESIGN.md
§6.1-disagg, ``DisaggEngineExecutor``): ``extract_handoffs`` pops each
prefilled row as a ``KVHandoff`` (copies of its pages and its next-token
logits) and ``accept_handoff`` lands one in this engine's own pool.

Families without per-row cache depths (moe, hybrid, ssm, audio) and
sliding-window configs run the reference's **left-padded lock-step waves**
instead (``_generate_wave``, entered from ``serve`` and ``step``): up to
``max_batch`` prompts left-padded with ``eos_id``, one prefill, then
decode steps at one shared cache length until every row is done (an
xLSTM's pads run through its recurrence, as in the reference).  Such an
engine refuses ``paged=True`` (and so the speculative, prefix-cache and
disaggregated backends) with the reference's ``ValueError``.  The wave
prefill passes the prompts' tokens alone, as the reference's does, so an
audio engine constructs but its first wave raises
``KeyError('encoder_embeds')`` where the reference's raises it.

Wall times are measured by ``Tracer.wall`` blocks that end in a device
synchronisation, because they feed ``EngineStats`` and so
``EngineExecutor.estimate``.  Unlike the reference, whose arrays are
immutable, the slot cache, the draft cache and the page pools are updated
in place.

Beyond the reference's spans, a step names its own parts, so that every
stretch of host time in it has a cause: ``engine.sample`` (sampling, the
token readback, appending and retiring rows), ``engine.admit`` (an
admission that finds a queued request, ``engine.prefill`` inside it),
``engine.pages`` (the decode write pages), and inside
``engine.decode_step`` and ``engine.spec_verify`` three children that
cover it: ``engine.decode.inputs`` (the block table and lengths on the
device), ``engine.decode.launch`` (the family's step, which only enqueues
on a card) and ``engine.decode.wait`` (the closing synchronisation).

On the card a paged, non-speculative engine replays its decode step as
the family's CUDA graphs (``dense.PagedDecodeGraphs``): the dense pieces
between the layers' paged attentions, which launch eagerly between the
replays.  They are captured once over the engine's pools, before the
first decode step's span opens, and again only if the pools are
reallocated; ``engine.decode.inputs`` then also stages the step's inputs
into the graphs' static ones, and ``EngineStats.decode_graph_steps``
counts the steps served by replay.  Off the card, and where the family
keeps the step eager (M-RoPE), the same pieces run eagerly.
"""

from __future__ import annotations

import zlib
from collections import OrderedDict
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs import _WALL, get_tracer, wall_now
from repro_torch.serving.sampling import masked_logits, sample
from repro_torch.sim.executor import (paged_admit_ok, pages_for,
                                      prefix_hit_pages, quantized_pages)
from repro_torch.sim.servicemodel import (_PREFIX_FINGERPRINT_K,
                                          _PREFIX_HIT_EMA_BETA, _SPEC_ALPHA0,
                                          _SPEC_EMA_BETA, _SPEC_K)


def _greedy_tokens(logits: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """Greedy token at every position of ``logits`` (..., V), padded vocab
    masked: the same masking and argmax as ``sample`` at temperature 0, so
    speculative verification reproduces non-speculative greedy choices."""
    return torch.argmax(masked_logits(logits, vocab_size), dim=-1)


@dataclass
class GenRequest:
    rid: str
    tokens: np.ndarray            # (S,) prompt token ids
    max_new: int = 32
    temperature: float = 0.0
    result: Optional[np.ndarray] = None
    # engine metrics (wall-clock)
    enqueued_at: float = 0.0
    started_at: float = 0.0       # admitted into a slot (prefill)
    first_token_at: float = 0.0   # first output token sampled
    finished_at: float = 0.0


@dataclass
class EngineStats:
    served: int = 0
    prefill_tokens: int = 0
    decode_tokens: int = 0
    batches: int = 0              # prefill batches
    decode_steps: int = 0         # batched decode_step invocations
    prefill_wall_s: float = 0.0   # wall time inside prefill calls
    decode_wall_s: float = 0.0    # wall time inside decode_step calls
    # host time enqueuing those calls (engine.decode.launch): near
    # decode_wall_s, the host paces the step
    decode_launch_s: float = 0.0
    # paged decode steps served by replaying the step's CUDA graphs
    decode_graph_steps: int = 0
    queue_wait_s: float = 0.0     # admission start - enqueued_at, summed
    admitted: int = 0             # requests taken from the queue to prefill
    peak_resident: int = 0        # max concurrently resident sequences
    preempted: int = 0            # paged: preempt-and-requeue events
    handoffs: int = 0             # disagg: KV handoffs extracted/accepted
    handoff_bytes: int = 0        # disagg: valid KV bytes handed off
    # speculative decoding: decode_tokens counts EMITTED tokens and
    # decode_wall_s the target's verify walls, so decode_tokens /
    # decode_wall_s is the effective target decode rate; the draft's own
    # cost is draft_wall_s
    spec_steps: int = 0           # verify forwards (each checks spec_k drafts)
    spec_drafted: int = 0         # draft tokens proposed
    spec_accepted: int = 0        # draft tokens matching the target's greedy
    draft_wall_s: float = 0.0     # wall time inside draft prefill/decode
    verify_wall_s: float = 0.0    # wall time inside the verify forward


@dataclass
class KVHandoff:
    """A prefilled request leaving a disaggregated prefill engine
    (DESIGN.md §6.1-disagg): its populated KV pages, the tokens it has
    already sampled (the prefill side emits the first token), and the
    next-token logits the decode side resumes from.  ``k``, ``v`` and
    ``logits`` are copies, never views: the prefill engine releases the
    row's pages and reuses its logits row at once, and writes both in
    place; the decode engine writes the pages into its own pool under
    fresh page numbers (``Engine.accept_handoff``)."""

    req: GenRequest
    out: List[int]                # tokens sampled on the prefill side (>= 1)
    length: int                   # valid KV tokens: prompt + len(out)
    k: torch.Tensor               # (L, n_pages, page, Hkv, dh)
    v: torch.Tensor
    logits: torch.Tensor          # (1, V) next-token logits
    page_size: int
    # prefix tokens the DECODE side already holds cached and pinned
    # (DESIGN.md §6.1-prefix): those pages are not gathered into k/v and
    # their bytes never cross the wire.  Always a page multiple.
    cached_tokens: int = 0

    @property
    def kv_bytes(self) -> int:
        """Bytes of *valid* KV crossing the wire, what the simulator's
        transfer model charges: ``2 L (length - cached_tokens) Hkv dh``
        elements."""
        n_layers, _, _, n_kv, dh = self.k.shape
        return (2 * n_layers * (self.length - self.cached_tokens)
                * n_kv * dh * self.k.element_size())


class _Slot:
    """One resident sequence: its request and sampled tokens."""

    __slots__ = ("req", "out")

    def __init__(self, req: GenRequest) -> None:
        self.req = req
        self.out: List[int] = []


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Engine:
    """Continuous batching over the PyTorch dense model (slot, paged or
    speculative), or left-padded lock-step waves for the moe, hybrid, ssm
    and audio families and window configs (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 bucket: int = 64, seed: int = 0,
                 capacity: Optional[int] = None,
                 continuous: bool = True,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_draft: Optional[Tuple[ModelConfig, Dict]] = None,
                 spec_k: int = _SPEC_K) -> None:
        fam = registry.get_family(cfg)
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.continuous = continuous
        self.device = params["embed"].device
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.stats = EngineStats()
        # trace span identity (DESIGN.md §Observability): the owning
        # executor forwards the node id the Node binds onto it
        self.owner = ""
        self.eos_id = cfg.eos_id
        # right-padding is only inert with a full cache: a sliding-window
        # ring keeps the last `window` positions of the PADDED sequence, so
        # trailing pads would evict real in-window KV.  Window configs, and
        # families without per-row cache depths, take the left-padded
        # lock-step wave path (``_generate_wave``)
        self.slot_decode = fam.slot_decode and cfg.sliding_window is None
        self._prefill = fam.prefill
        self._decode = fam.decode_step

        self._queue: List[GenRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * max_batch
        self._lengths = np.zeros(max_batch, np.int64)   # per-row cache depth
        self._logits: Optional[torch.Tensor] = None
        # slot mode: the persistent (L, max_batch, C, Hkv, dh) cache
        self._cache: Optional[Dict] = None
        self._capacity = int(capacity or 0)

        self.paged = bool(paged)
        self.page_size = int(page_size)
        if self.paged:
            if not (self.slot_decode and fam.paged_decode is not None):
                raise ValueError(
                    "paged KV requires a paged-capable slot-decode family "
                    "(dense/vlm with full attention)")
            self._decode_paged = fam.paged_decode
            self._scatter_pages = fam.prefill_to_pages
            self._init_pools = fam.init_paged_pools
            # the page pool: page 0 is scratch, pages 1.. are usable
            usable = (int(num_pages) if num_pages is not None
                      else max_batch * pages_for(2 * bucket, self.page_size))
            # int8 KV pages: the same budget holds twice the pages (the
            # capacity rule the simulator shares); one free list covers the
            # K/V pages and their scale pages
            self._pool_pages = quantized_pages(usable, cfg.kv_quant) + 1
            self._kv: Optional[Dict] = None             # lazy device alloc
            # the decode step's graphs over ``_kv``, captured at the first
            # decode step on the card (``_decode_graphs``)
            self._build_graphs = fam.paged_decode_graphs
            self._graphs = None
            self._free: List[int] = list(range(1, self._pool_pages))
            self._held: List[List[int]] = [[] for _ in range(max_batch)]
            self._maxp = max(1, pages_for(2 * bucket, self.page_size))
            self._tables = np.zeros((max_batch, self._maxp), np.int32)
            # admission order, for LIFO preemption under pool pressure
            self._admit_order = np.zeros(max_batch, np.int64)
            self._admit_seq = 0
            # prefix cache (DESIGN.md §6.1-prefix): content-addressed pages.
            # The maps exist, empty, on every paged engine so the page
            # accounting is uniform; only ``prefix_cache=True`` fills them.
            self._hash_to_page: Dict[int, int] = {}   # chain hash -> page
            self._page_to_hash: Dict[int, int] = {}   # page -> chain hash
            self._holders: Dict[int, int] = {}        # page -> holder count
            # cached pages without a holder, least recently released first:
            # evicted only when the free list is empty
            self._evictable: "OrderedDict[int, None]" = OrderedDict()
            # depth-1 chain hashes by recency: the resident-prefix
            # fingerprint load snapshots advertise
            self._prefix_heads: "OrderedDict[int, None]" = OrderedDict()
            # request id -> pages claimed for a KV handoff on the wire
            self._pins: Dict[str, List[int]] = {}
            self.prefix_hit_rate = 0.0
            self.prefix_hit_tokens = 0
            self.prefix_lookup_tokens = 0

        # speculative decoding (DESIGN.md §6.1-spec)
        self.spec = spec_draft is not None
        self.spec_k = int(spec_k) if self.spec else 0
        if self.spec:
            if not self.paged:
                raise ValueError("speculative decoding requires paged=True "
                                 "(the verify step targets the page pools)")
            if fam.paged_verify is None:
                raise ValueError("family has no paged_verify capability")
            if self.spec_k < 1:
                raise ValueError("spec_k must be >= 1")
            draft_cfg, draft_params = spec_draft
            dfam = registry.get_family(draft_cfg)
            if not (dfam.slot_decode and draft_cfg.sliding_window is None):
                raise ValueError("draft model must support slot decode "
                                 "with full attention")
            if (draft_cfg.vocab_size != cfg.vocab_size
                    or draft_cfg.eos_id != cfg.eos_id):
                raise ValueError("draft and target must share the tokenizer "
                                 "(vocab_size / eos_id)")
            self.spec_draft_cfg = draft_cfg
            self.spec_draft_params = draft_params
            self._verify = fam.paged_verify
            self._draft_prefill = dfam.prefill
            self._draft_decode = dfam.decode_step
            # draft slot cache: contiguous per-row-depth KV mirrored to the
            # target's slots (re-prefilled from scratch after preemption)
            self._draft_cache: Optional[Dict] = None
            self._draft_lengths = np.zeros(max_batch, np.int64)
            self._draft_capacity = 0
            # online per-token acceptance-rate EMA, seeded from the sim's
            # prior so sim and engine agree until observations move it
            self.spec_alpha = _SPEC_ALPHA0
            # spec_accept_hist[a]: verify steps that accepted a of spec_k
            self.spec_accept_hist = [0] * (self.spec_k + 1)

        self.prefix_cache = bool(prefix_cache)
        if self.prefix_cache:
            if not self.paged:
                raise ValueError("prefix caching requires paged=True "
                                 "(it shares pool pages across requests)")
            if fam.paged_verify is None:
                raise ValueError(
                    "prefix caching needs a paged_verify-capable family: "
                    "the cached-suffix prefill is a multi-token verify")
            # the warm prefill runs the verify forward over the uncached
            # suffix, attending the shared pages through the block table
            self._verify = fam.paged_verify

    def _pad_bucket(self, n: int) -> int:
        b = self.bucket
        return max(b, (n + b - 1) // b * b)

    def _required(self, r: GenRequest) -> int:
        """Worst-case cache tokens a request may touch.  A speculative
        verify writes up to ``spec_k`` positions past the pending token,
        and those writes need mapped pages too."""
        extra = self.spec_k if self.spec else 0
        return (self._pad_bucket(len(r.tokens))
                + self._pad_bucket(r.max_new) + extra)

    def _draft_required(self, r: GenRequest) -> int:
        """Draft-cache capacity for ``r``: the page-rounded prefill width
        plus room to decode the pending token and ``spec_k`` drafts at
        positions up to ``prompt + max_new - 2 + spec_k``."""
        plen = (-(-self._pad_bucket(len(r.tokens)) // self.page_size)
                * self.page_size)
        return plen + self._pad_bucket(r.max_new + self.spec_k)

    # ------------------------------------------------------------- interface
    def submit(self, r: GenRequest) -> None:
        if self.spec and r.temperature > 0.0:
            raise ValueError(
                "the speculative engine is greedy-only: draft acceptance "
                "compares argmax choices")
        r.enqueued_at = wall_now()
        self._queue.append(r)

    def requeue(self, r: GenRequest) -> None:
        """Put a preempted/rerouted request back at the head of the queue
        WITHOUT re-stamping ``enqueued_at``, so its queue wait keeps
        counting from the original submission."""
        self._queue.insert(0, r)

    def take_queued(self) -> List[GenRequest]:
        """Drain and return the queue: the disaggregated executor pulls a
        decode engine's preempted requests back out this way, since
        handoffs never pass through the decode engine's own queue."""
        q, self._queue = self._queue, []
        return q

    def has_work(self) -> bool:
        return bool(self._queue) or any(s is not None for s in self._slots)

    def active_slots(self) -> int:
        return sum(1 for s in self._slots if s is not None)

    def load_snapshot(self) -> Dict[str, object]:
        """Occupancy counts for Executor.load() -- the sanctioned external
        view of the slot/queue/page-pool bookkeeping (token counts are
        *remaining* work)."""
        active = [(i, s) for i, s in enumerate(self._slots) if s is not None]
        snap = dict(
            active_streams=len(active),
            queued_streams=len(self._queue),
            queued_prompt_tokens=sum(len(r.tokens) for r in self._queue),
            queued_new_tokens=sum(r.max_new for r in self._queue),
            pending_decode_tokens=sum(s.req.max_new - len(s.out)
                                      for _, s in active),
            pages_used=0, pages_total=0, free_pages=0, page_size=0,
            cached_pages=0, prefix_hit_rate=0.0, resident_prefixes=())
        if self.paged:
            usable = self._pool_pages - 1
            cold = len(self._evictable)
            used = usable - len(self._free) - cold
            snap.update(
                pages_used=used, pages_total=usable,
                # cold cached pages are evicted on demand, so admission
                # counts them as free
                free_pages=len(self._free) + cold, page_size=self.page_size,
                # paged KV charges pages actually held, not reservations
                kv_used=used * self.page_size,
                kv_budget=usable * self.page_size,
                cached_pages=cold, prefix_hit_rate=self.prefix_hit_rate,
                resident_prefixes=tuple(reversed(self._prefix_heads))
                [:_PREFIX_FINGERPRINT_K])
        else:
            snap.update(
                kv_used=int(sum(self._lengths[i] + s.req.max_new - len(s.out)
                                for i, s in active)),
                kv_budget=self.max_batch * max(self._capacity, 1))
        return snap

    def serve(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Submit ``reqs`` and pump steps until the engine drains (a wave
        engine serves them in waves of ``max_batch``, without the queue)."""
        if not self.slot_decode:
            return self._serve_wave(reqs)
        for r in reqs:
            self.submit(r)
        while self.has_work():
            self.step()
        return reqs

    def generate_batch(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Serve up to ``max_batch`` requests together; returns them
        completed."""
        assert len(reqs) <= self.max_batch
        return self.serve(reqs)

    def logprob_of(self, tokens: np.ndarray) -> float:
        """Sequence log-likelihood under this engine's model: the sum over
        positions 1.. of each token's log-probability given the tokens
        before it, from one full-sequence forward (``apply_logits``) with
        the log-softmax in float32 over the padded vocabulary, as the
        reference computes it.  The real-engine duel judges use it
        (DESIGN.md §6.2)."""
        t = torch.as_tensor(np.asarray(tokens), device=self.device)[None]
        logits = registry.apply_logits(self.params, self.cfg,
                                       {"tokens": t[:, :-1]})
        lp = torch.log_softmax(logits.float(), dim=-1)
        gold = torch.gather(lp, -1, t[:, 1:, None].long())
        return float(gold.sum())

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        """Take queued requests into free slots and prefill them, in one
        ``engine.admit`` span whenever the queue holds a request."""
        if not self._queue:
            return
        with get_tracer().wall("engine.admit", who=self.owner,
                               queued=len(self._queue)) as sp:
            if self.paged:
                self._admit_paged(sp.t0)
            else:
                self._admit_slots(sp.t0)

    def _count_admitted(self, reqs: List[GenRequest], t0: float) -> None:
        """Queue wait of requests leaving the queue for a prefill, at an
        admission that started at ``t0``."""
        for r in reqs:
            self.stats.queue_wait_s += t0 - r.enqueued_at
        self.stats.admitted += len(reqs)

    def _admit_slots(self, t0: float) -> None:
        resident = any(s is not None for s in self._slots)
        if not self.continuous and resident:
            return                     # wave batching: refill only when empty
        if resident and any(self._required(r) > self._capacity
                            for r in self._queue):
            # a queued request needs a bigger cache, which is only
            # reallocated while nothing is resident: stop backfilling so the
            # batch drains and the growth branch below runs
            return
        if not resident:
            needed = max(self._required(r)
                         for r in self._queue[:self.max_batch])
            if self._cache is None or needed > self._capacity:
                self._capacity = max(self._capacity, needed)
                self._cache = None
                self._logits = None
        free = [i for i, s in enumerate(self._slots) if s is None]
        take: List[Tuple[int, GenRequest]] = []
        rest: List[GenRequest] = []
        for r in self._queue:
            # requests the current cache cannot hold wait for the next idle
            # point, when capacity can grow
            if free and self._required(r) <= self._capacity:
                take.append((free.pop(0), r))
            else:
                rest.append(r)
        self._queue = rest
        if take:
            self._count_admitted([r for _, r in take], t0)
            self._prefill_into(take)

    def _prompt_batch(self, take: List[Tuple[int, GenRequest]], plen: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Right-padded (pads inert) prompt tokens (n, plen) and each row's
        last real position, on the engine's device."""
        toks = np.full((len(take), plen), self.eos_id, np.int64)
        last = np.zeros(len(take), np.int64)
        for j, (_, r) in enumerate(take):
            toks[j, : len(r.tokens)] = r.tokens
            last[j] = len(r.tokens) - 1
        return (torch.from_numpy(toks).to(self.device),
                torch.from_numpy(last).to(self.device))

    def _prefill_into(self, take: List[Tuple[int, GenRequest]]) -> None:
        """Slot mode: prefill the admitted rows and copy their KV into their
        rows of the persistent cache, in place."""
        n = len(take)
        plen = self._pad_bucket(max(len(r.tokens) for _, r in take))
        toks, last = self._prompt_batch(take, plen)
        dev = self.device
        with get_tracer().wall("engine.prefill", who=self.owner,
                               rows=n, tokens=plen * n) as sp:
            logits, cache = self._prefill(self.params, self.cfg, toks,
                                          capacity=self._capacity,
                                          last_positions=last)
            _sync(dev)
        self.stats.prefill_wall_s += sp.dt
        self.stats.prefill_tokens += plen * n
        self.stats.batches += 1
        rows = torch.tensor([i for i, _ in take], device=dev)
        if self._cache is None:
            self._cache = {
                n_: torch.zeros((a.shape[0], self.max_batch) + a.shape[2:],
                                dtype=a.dtype, device=dev)
                for n_, a in cache.items() if n_ != "length"}
            self._logits = torch.zeros(
                (self.max_batch, 1, logits.shape[-1]), dtype=logits.dtype,
                device=dev)
        for n_, a in self._cache.items():
            a.index_copy_(1, rows, cache[n_])
        self._logits[rows] = logits
        now = wall_now()
        for i, r in take:
            r.started_at = now
            self._slots[i] = _Slot(r)
            self._lengths[i] = len(r.tokens)
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       self.active_slots())

    # -------------------------------------------------------- paged admission
    def _pages(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def _admit_paged(self, t0: float) -> None:
        resident = any(s is not None for s in self._slots)
        if not self.continuous and resident:
            return                     # wave batching: refill only when empty
        usable = self._pool_pages - 1
        if resident and any(self._pages(self._required(r)) > usable
                            or (self.spec and self._draft_required(r)
                                > self._draft_capacity)
                            for r in self._queue):
            # a queued request cannot fit the pool (or the draft cache) even
            # alone; stop backfilling so the batch drains and the growth
            # branch runs
            return
        if not resident:
            # grow the pool while nothing is resident, so any single
            # admitted request can always run to completion -- this is what
            # makes LIFO preemption livelock-free.  Growth reallocates every
            # page, so it forgets the prefix cache, and waits while pins
            # hold page content.
            needed = max(self._pages(self._required(r))
                         for r in self._queue[:self.max_batch])
            if (self._kv is None or needed > usable) and not self._pins:
                self._pool_pages = max(self._pool_pages, needed + 1)
                usable = self._pool_pages - 1
                self._kv = None
                self._graphs = None
                self._logits = None
                self._free = list(range(1, self._pool_pages))
                self._flush_prefix_cache()
            if self.spec:
                # the draft cache grows at the same idle points
                dneeded = max(self._draft_required(r)
                              for r in self._queue[:self.max_batch])
                if self._draft_cache is None \
                        or dneeded > self._draft_capacity:
                    self._draft_capacity = max(self._draft_capacity, dneeded)
                    self._draft_cache = None
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        # cold cached pages are evictable on demand, so they count as free,
        # but a cold page a taken request will share stops being evictable
        # (it revives to one holder), so it costs headroom exactly once
        free_now = len(self._free) + len(self._evictable)
        cold_reserved: set = set()
        take: List[Tuple[int, GenRequest]] = []
        rest: List[GenRequest] = []
        taking = resident
        for r in self._queue:
            hit_pages = (self._prefix_lookup_pages(r.tokens)
                         if self.prefix_cache else [])
            cold_cost = sum(1 for pg in hit_pages
                            if pg in self._evictable
                            and pg not in cold_reserved)
            suffix_tokens = len(r.tokens) - len(hit_pages) * self.page_size
            need = self._pages(suffix_tokens)
            if (free_slots and need + cold_cost <= free_now
                    and self._pages(self._required(r)) <= usable
                    and (not self.spec
                         or self._draft_required(r) <= self._draft_capacity)
                    and paged_admit_ok(free_now - cold_cost, suffix_tokens,
                                       self.page_size, resident=taking)):
                take.append((free_slots.pop(0), r))
                free_now -= need + cold_cost
                cold_reserved.update(pg for pg in hit_pages
                                     if pg in self._evictable)
                taking = True
            else:
                rest.append(r)
        self._queue = rest
        if take:
            self._count_admitted([r for _, r in take], t0)
            self._grow_tables(max(self._pages(self._required(r))
                                  for _, r in take))
            self._prefill_paged(take)

    def _grow_tables(self, maxp: int) -> None:
        if maxp <= self._maxp:
            return
        wider = np.zeros((self.max_batch, maxp), np.int32)
        wider[:, : self._maxp] = self._tables
        self._tables = wider
        self._maxp = maxp

    def _table_width(self, lookahead: int = 1) -> int:
        """Logical-page width the block table needs this step: every
        resident row's allocated pages, plus the page its next ``lookahead``
        writes reach (a riding-along row whose prompt exactly fills its
        pages writes into the next, unallocated logical page, and without
        that column the clamped lookup would alias slot 0 of its own last
        real page).  Rounded up to a power of two, capped at the table."""
        need = 1
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            last_write = int(self._lengths[i]) + lookahead - 1
            need = max(need, len(self._held[i]),
                       last_write // self.page_size + 1)
        w = 1
        while w < need:
            w *= 2
        return min(w, self._maxp)

    def _prefill_paged(self, take: List[Tuple[int, GenRequest]]) -> None:
        """Claim the admitted rows' prompt pages, then prefill them (and the
        draft's cache rows, speculative mode).  Rows without a cached
        prefix take the cold path (right-padded prefill, then a page
        scatter); with the prefix cache, rows whose prompt head is resident
        share those pages and compute only the uncached suffix (the warm
        path)."""
        ps = self.page_size
        # every acquire happens before any register: rows admitted in one
        # batch never share each other's fresh pages, which a warm row
        # would otherwise attend while another row still writes them
        shared: Dict[int, List[int]] = {}
        for i, r in take:
            shared[i] = (self._prefix_acquire(np.asarray(r.tokens, np.int32))
                         if self.prefix_cache else [])
        for i, r in take:
            hits = len(shared[i])
            fresh = [self._claim_page()
                     for _ in range(self._pages(len(r.tokens)) - hits)]
            if self.prefix_cache:
                self._prefix_register(np.asarray(r.tokens, np.int32), hits,
                                      fresh)
            pages = shared[i] + fresh
            self._held[i] = pages
            self._tables[i, :] = 0
            self._tables[i, : len(pages)] = pages
            self._slots[i] = _Slot(r)
            self._lengths[i] = len(r.tokens)
            self._admit_order[i] = self._admit_seq
            self._admit_seq += 1
        cold = [(i, r) for i, r in take if not shared[i]]
        warm = [(i, r) for i, r in take if shared[i]]
        if cold:
            self._prefill_cold(cold)
        if warm:
            self._prefill_warm(warm, {i: len(shared[i]) for i, _ in warm})
        now = wall_now()                # started_at: stamped after prefill
        for _, r in take:
            r.started_at = now
        self.stats.batches += 1
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       self.active_slots())
        if self.prefix_cache:
            for i, r in take:
                cached = len(shared[i]) * ps
                p = max(1, len(r.tokens))
                self.prefix_lookup_tokens += p
                self.prefix_hit_tokens += cached
                self.prefix_hit_rate += _PREFIX_HIT_EMA_BETA * (
                    cached / p - self.prefix_hit_rate)
        if self.spec:
            self._spec_prefill_draft(take)

    def _paged_plen(self, take: List[Tuple[int, GenRequest]]) -> int:
        """Prefill width of a paged batch: the bucket, rounded up to a page
        multiple."""
        plen = self._pad_bucket(max(len(r.tokens) for _, r in take))
        return -(-plen // self.page_size) * self.page_size

    def _prefill_cold(self, cold: List[Tuple[int, GenRequest]]) -> None:
        """Right-padded prompt prefill, then scatter the contiguous KV into
        the rows' already-allocated pool pages (pad-tail pages alias the
        scratch page 0, which per-row lengths keep inert)."""
        n = len(cold)
        plen = self._paged_plen(cold)
        toks, last = self._prompt_batch(cold, plen)
        phys = np.zeros((n, plen // self.page_size), np.int64)
        for j, (i, _) in enumerate(cold):
            phys[j, : len(self._held[i])] = self._held[i]
        dev = self.device
        with get_tracer().wall("engine.prefill", who=self.owner, path="cold",
                               rows=n, tokens=plen * n) as sp:
            logits, cache = self._prefill(self.params, self.cfg, toks,
                                          capacity=plen, last_positions=last)
            _sync(dev)
        self.stats.prefill_wall_s += sp.dt
        self.stats.prefill_tokens += plen * n
        if self._kv is None:
            self._kv = self._init_pools(self.cfg, self._pool_pages,
                                        self.page_size,
                                        dtype=self.params["embed"].dtype,
                                        device=dev)
            self._logits = torch.zeros(
                (self.max_batch, 1, logits.shape[-1]), dtype=logits.dtype,
                device=dev)
        self._scatter_pages(self._kv, cache, torch.from_numpy(phys).to(dev))
        rows = torch.tensor([i for i, _ in cold], device=dev)
        self._logits[rows] = logits

    def _prefill_warm(self, warm: List[Tuple[int, GenRequest]],
                      hits: Dict[int, int]) -> None:
        """Cached-suffix prefill (DESIGN.md §6.1-prefix): warm rows enter
        with their length set to their cached token count, and ONE verify
        forward over every row computes the uncached suffixes (K = the
        longest, rounded up to a page) attending the shared prefix pages.
        Other rows ride along as in a speculative verify: their writes
        land past their valid length or on the scratch page, and their
        carried logits are kept."""
        ps = self.page_size
        assert self._kv is not None     # a chain hit implies an earlier prefill
        suf_lens = {i: len(r.tokens) - hits[i] * ps for i, r in warm}
        width = -(-max(suf_lens.values()) // ps) * ps   # page-rounded K
        toks = np.full((self.max_batch, width), self.eos_id, np.int64)
        for i, r in warm:
            toks[i, : suf_lens[i]] = np.asarray(r.tokens[hits[i] * ps:])
            self._lengths[i] = hits[i] * ps   # valid tokens: the cached prefix
        # every row writes at lengths + j for j < K: the table must be wide
        # enough that each of those lookups finds the row's own page or a
        # zero entry (the scratch page), never clamps back onto a page --
        # the pools are written in place, and a shared page must stay as
        # the cold forward left it
        need_w = max((int(self._lengths[i]) + width - 1) // ps + 1
                     for i, s in enumerate(self._slots) if s is not None)
        self._grow_tables(need_w)
        dev = self.device
        with get_tracer().wall("engine.prefill", who=self.owner, path="warm",
                               rows=len(warm), tokens=width * len(warm),
                               cached_pages=sum(hits.values())) as sp:
            vlogits, _ = self._verify(self.params, self.cfg,
                                      self._paged_cache(width),
                                      torch.from_numpy(toks).to(dev))
            _sync(dev)
        self.stats.prefill_wall_s += sp.dt
        self.stats.prefill_tokens += width * len(warm)
        rows = torch.tensor([i for i, _ in warm], device=dev)
        pos = torch.tensor([suf_lens[i] - 1 for i, _ in warm], device=dev)
        self._logits[rows] = vlogits[rows, pos][:, None]
        for i, r in warm:
            self._lengths[i] = len(r.tokens)

    # ------------------------------------------------ prefix cache internals
    # (DESIGN.md §6.1-prefix): content-addressed pages with holder counts;
    # the free list, the cold (evictable) set and the held pages partition
    # the pool.
    def _chain_hashes(self, tokens: np.ndarray) -> List[int]:
        """Cumulative page-aligned content hashes over the prompt's full
        pages, ``h_i = crc32(page_i, h_{i-1})``: two prompts share pages
        exactly up to their first differing page."""
        arr = np.ascontiguousarray(np.asarray(tokens, np.int32))
        ps = self.page_size
        out: List[int] = []
        h = 0
        for i in range(len(arr) // ps):
            h = zlib.crc32(arr[i * ps:(i + 1) * ps].tobytes(), h)
            out.append(h)
        return out

    def _prefix_match(self, tokens: np.ndarray) -> List[int]:
        """The chain hashes of the cached pages a prompt would reuse:
        the resident head of its chain, capped by the shared hit rule."""
        hashes = self._chain_hashes(tokens)
        matched = 0
        for h in hashes:
            if h not in self._hash_to_page:
                break
            matched += 1
        hits = prefix_hit_pages(len(tokens), self.page_size,
                                matched * self.page_size)
        return hashes[:hits]

    def _prefix_lookup_pages(self, tokens: np.ndarray) -> List[int]:
        """Dry chain walk: the cached pages a prompt would reuse (no holder
        counts move; ``_prefix_acquire`` claims them at prefill)."""
        return [self._hash_to_page[h] for h in self._prefix_match(tokens)]

    def _prefix_acquire(self, tokens: np.ndarray) -> List[int]:
        """Claim the cached prefix pages of a row about to prefill: add a
        holder to each (reviving cold pages out of the eviction order) and
        return them in chain order."""
        hashes = self._prefix_match(tokens)
        pages: List[int] = []
        for h in hashes:
            pg = self._hash_to_page[h]
            self._evictable.pop(pg, None)
            self._holders[pg] = self._holders.get(pg, 0) + 1
            pages.append(pg)
        if pages and hashes[0] in self._prefix_heads:
            self._prefix_heads.move_to_end(hashes[0])
        return pages

    def _prefix_register(self, tokens: np.ndarray, hits: int,
                         fresh: List[int]) -> None:
        """Enter a row's freshly computed FULL prompt pages into the chain.
        A partial tail page stays private (decode keeps writing into it),
        as does a page whose hash another page already holds (the first
        writer wins)."""
        hashes = self._chain_hashes(tokens)
        if hits and hashes[0] in self._prefix_heads:
            self._prefix_heads.move_to_end(hashes[0])
        for j in range(hits, len(hashes)):
            h, pg = hashes[j], fresh[j - hits]
            if h in self._hash_to_page or pg in self._page_to_hash:
                continue
            self._hash_to_page[h] = pg
            self._page_to_hash[pg] = h
            if j == 0:
                self._prefix_heads[h] = None
                self._prefix_heads.move_to_end(h)

    def _claim_page(self) -> int:
        """One page for a row to hold: the free list first, else evict the
        least recently released cold page (cold pages have no holder)."""
        if self._free:
            pg = self._free.pop()
        else:
            pg, _ = self._evictable.popitem(last=False)
            h = self._page_to_hash.pop(pg, None)
            if h is not None:
                self._hash_to_page.pop(h, None)
                self._prefix_heads.pop(h, None)
        if self.prefix_cache:
            self._holders[pg] = 1
        return pg

    def _drop_page(self, pg: int) -> None:
        """One holder lets go of a page.  A page of the chain goes cold at
        zero holders (still addressable, evictable), any other page back to
        the free list; pages without a holder count (prefix cache off) go
        straight to the free list."""
        ref = self._holders.get(pg)
        if ref is None:
            self._free.append(pg)
            return
        if ref > 1:
            self._holders[pg] = ref - 1
            return
        del self._holders[pg]
        if pg in self._page_to_hash:
            self._evictable[pg] = None       # the most recently released end
        else:
            self._free.append(pg)

    def _flush_prefix_cache(self) -> None:
        """A reallocated pool holds no content: forget the chain and the
        cold set (the caller resets the free list)."""
        for state in (self._hash_to_page, self._page_to_hash, self._holders,
                      self._evictable, self._prefix_heads):
            state.clear()

    def _spec_prefill_draft(self, take: List[Tuple[int, GenRequest]]) -> None:
        """Run the draft's prefill over the same right-padded prompts and
        copy its KV into the rows of the draft's slot cache.  The draft's
        prompt logits are discarded: drafting starts by feeding the pending
        token."""
        toks, last = self._prompt_batch(take, self._paged_plen(take))
        dev = self.device
        with get_tracer().wall("engine.spec_draft", who=self.owner,
                               path="prefill", rows=len(take)) as sp:
            _, dcache = self._draft_prefill(
                self.spec_draft_params, self.spec_draft_cfg, toks,
                capacity=self._draft_capacity, last_positions=last)
            _sync(dev)
        self.stats.draft_wall_s += sp.dt
        if self._draft_cache is None:
            self._draft_cache = {
                n_: torch.zeros((a.shape[0], self.max_batch) + a.shape[2:],
                                dtype=a.dtype, device=dev)
                for n_, a in dcache.items() if n_ != "length"}
        rows = torch.tensor([i for i, _ in take], device=dev)
        for n_, a in self._draft_cache.items():
            a.index_copy_(1, rows, dcache[n_])
        for i, r in take:
            self._draft_lengths[i] = len(r.tokens)

    # ------------------------------------------ disaggregated KV handoff
    def prefix_pin(self, req: GenRequest) -> int:
        """Decode-side cache consultation for a KV handoff (DESIGN.md
        §6.1-prefix): claim the cached pages of ``req``'s prompt now, so
        they cannot be evicted while the handoff is on the wire, keep them
        under the request id, and return the cached token count.  Returns
        0 when caching is off, the pool is unallocated, the request is
        already pinned, or it would force a pool growth (which would strand
        the pin)."""
        if (not self.prefix_cache or self._kv is None
                or req.rid in self._pins
                or self._pages(self._required(req)) > self._pool_pages - 1):
            return 0
        pages = self._prefix_acquire(np.asarray(req.tokens, np.int32))
        p = max(1, len(req.tokens))
        cached = len(pages) * self.page_size
        self.prefix_lookup_tokens += p
        self.prefix_hit_tokens += cached
        self.prefix_hit_rate += _PREFIX_HIT_EMA_BETA * (
            cached / p - self.prefix_hit_rate)
        if not pages:
            return 0
        self._pins[req.rid] = pages
        return cached

    def _assert_handoff_backend(self) -> None:
        assert self.paged, "KV handoff requires the paged backend"
        assert not self.spec, "KV handoff and speculative decoding are " \
            "separate backends (the draft cache does not travel)"
        assert not self.cfg.kv_quant, "KV handoff carries fp pages only " \
            "(quantized scale pools do not travel; DESIGN.md §6.1-paged)"

    def extract_handoffs(self, cached_tokens_fn: Optional[
            Callable[[GenRequest], int]] = None) -> List[KVHandoff]:
        """Disaggregated prefill side: pop every resident row that has
        sampled at least one token as a ``KVHandoff`` and release its
        pages.  Driven after each ``step()``: a freshly admitted row
        samples its first token and decodes it within that step, so no row
        stays here for two steps.

        The page gather (``pool[:, idx]``) and the logits ``clone()`` are
        copies queued on the device's one stream before any later write
        to the released pages or the logits row, so the prefill engine
        may reuse both at once.

        ``cached_tokens_fn`` is the decode side's ``prefix_pin`` (DESIGN.md
        §6.1-prefix): the prompt tokens the decode engine already holds
        cached and pinned, a page multiple.  Those leading pages are not
        gathered, and neither end counts their bytes."""
        self._assert_handoff_backend()
        out: List[KVHandoff] = []
        for i, s in enumerate(self._slots):
            if s is None or not s.out:
                continue
            cached = int(cached_tokens_fn(s.req)) if cached_tokens_fn else 0
            pages = torch.tensor(self._held[i][cached // self.page_size:],
                                 dtype=torch.long, device=self.device)
            h = KVHandoff(
                req=s.req, out=list(s.out), length=int(self._lengths[i]),
                k=self._kv["k_pool"][:, pages],
                v=self._kv["v_pool"][:, pages],
                logits=self._logits[i].clone(), page_size=self.page_size,
                cached_tokens=cached)
            self._release_pages(i)
            self._slots[i] = None
            self._lengths[i] = 0
            self.stats.handoffs += 1
            self.stats.handoff_bytes += h.kv_bytes
            out.append(h)
        return out

    def accept_handoff(self, h: KVHandoff) -> bool:
        """Disaggregated decode side: claim pages for a handed-off request,
        write its KV into this engine's pool in place, and install it in a
        free slot with its logits, so decode resumes where the prefill
        engine stopped and greedy outputs equal a colocated paged
        engine's.  Returns False (the caller retries after a completion)
        when no slot or not enough pages are free; the request's pin, if
        any, is kept until it lands."""
        assert h.page_size == self.page_size
        self._assert_handoff_backend()
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        if not free_slots:
            return False
        usable = self._pool_pages - 1
        worst = self._pages(self._required(h.req))
        if not any(s is not None for s in self._slots):
            # grow the pool while nothing is resident, as _admit_paged
            # does, so any single handoff can run to completion; deferred
            # while pins hold page content, since growth reallocates every
            # page and forgets the prefix cache
            if (self._kv is None or worst > usable) and not self._pins:
                self._pool_pages = max(self._pool_pages, worst + 1)
                usable = self._pool_pages - 1
                self._kv = None
                self._graphs = None
                self._logits = None
                self._free = list(range(1, self._pool_pages))
                self._flush_prefix_cache()
        if worst > usable:
            return False               # can never fit: wait for drain+growth
        pinned = self._pins.get(h.req.rid, [])
        assert len(pinned) * self.page_size == h.cached_tokens, \
            "handoff was sliced against a pin this engine no longer holds"
        need = self._pages(h.length)
        fresh_need = need - len(pinned)
        if fresh_need > len(self._free) + len(self._evictable):
            return False               # keep the pin; caller retries
        self._pins.pop(h.req.rid, None)
        dev = self.device
        if self._kv is None:
            self._kv = self._init_pools(self.cfg, self._pool_pages,
                                        self.page_size,
                                        dtype=self.params["embed"].dtype,
                                        device=dev)
            self._logits = torch.zeros(
                (self.max_batch, 1, h.logits.shape[-1]),
                dtype=h.logits.dtype, device=dev)
        i = free_slots[0]
        fresh = [self._claim_page() for _ in range(fresh_need)]
        if fresh:
            phys = torch.tensor(fresh, dtype=torch.long, device=dev)
            self._kv["k_pool"].index_copy_(1, phys, h.k[:, :fresh_need])
            self._kv["v_pool"].index_copy_(1, phys, h.v[:, :fresh_need])
        pages = pinned + fresh
        if self.prefix_cache:
            # the landed full prompt pages are valid content now: register
            # them so later requests and handoffs can share them
            self._prefix_register(np.asarray(h.req.tokens, np.int32),
                                  len(pinned), fresh)
        self._grow_tables(max(need, worst))
        self._held[i] = pages
        self._tables[i, :] = 0
        self._tables[i, :need] = pages
        slot = _Slot(h.req)
        slot.out = list(h.out)
        self._slots[i] = slot
        self._lengths[i] = h.length
        self._admit_order[i] = self._admit_seq
        self._admit_seq += 1
        self._logits[i] = h.logits
        self.stats.handoffs += 1
        self.stats.handoff_bytes += h.kv_bytes
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       self.active_slots())
        return True

    # ----------------------------------------------------- page pool dynamics
    def _release_pages(self, i: int) -> None:
        for pg in self._held[i]:
            self._drop_page(pg)
        self._held[i] = []
        self._tables[i, :] = 0

    def debug_page_accounting(self) -> Dict[str, int]:
        """Reconcile the free list, the cold set, the holder counts and the
        rows' and pins' holdings: every usable page is exactly one of free,
        cold or held; a shared page counts once; each page's holder count
        equals its holders."""
        assert self.paged
        usable = self._pool_pages - 1
        free = set(self._free)
        cold = set(self._evictable)
        held: Dict[int, int] = {}
        for pages in list(self._held) + list(self._pins.values()):
            for pg in pages:
                held[pg] = held.get(pg, 0) + 1
        assert len(free) == len(self._free), "free list has duplicates"
        assert not free & cold, "page both free and cold-cached"
        assert not free & set(held), "page both free and row-held"
        assert not cold & set(held), "page both cold and row-held"
        for pg, n in held.items():
            ref = self._holders.get(pg)
            if ref is not None:
                assert ref == n, f"page {pg}: holder count {ref} != {n}"
            else:
                assert n == 1, f"untracked page {pg} shared by {n} holders"
        every = free | cold | set(held)
        assert every <= set(range(1, usable + 1)), "page id out of range"
        assert len(free) + len(cold) + len(held) == usable, (
            f"page leak/double-free: {len(free)} free + {len(cold)} cold + "
            f"{len(held)} held != {usable} usable")
        return {"free": len(free), "cold": len(cold), "held": len(held)}

    def _preempt(self, i: int) -> None:
        """Reclaim row ``i``'s pages and requeue its request at the head of
        the queue (recompute preemption: generated tokens are discarded;
        the greedy restart reproduces them).  The admission clocks of the
        aborted attempt are reset with them."""
        r = self._slots[i].req
        r.result = None
        r.started_at = 0.0
        r.first_token_at = 0.0
        self._release_pages(i)
        self._slots[i] = None
        self._lengths[i] = 0
        if self.spec:
            # the draft row is re-prefilled from scratch on re-admission
            self._draft_lengths[i] = 0
        self._queue.insert(0, r)
        self.stats.preempted += 1
        tr = get_tracer()
        if tr.enabled:
            tr.event("executor.preempt", r.rid, self.owner, wall_now(),
                     clock=_WALL, row=i)

    def _ensure_decode_pages(self, survivors: List[int],
                             lookahead: int = 1) -> List[int]:
        """Allocate pages covering each surviving row's next ``lookahead``
        write positions (1 for decode, ``spec_k + 1`` for a verify).  Under
        pool pressure the most recently admitted resident is preempted
        until a page frees; oldest rows are served first, so the oldest
        admission always makes progress and the loop terminates."""
        with get_tracer().wall("engine.pages", who=self.owner,
                               rows=len(survivors)):
            for i in sorted(survivors, key=lambda i: self._admit_order[i]):
                while (self._slots[i] is not None
                       and (self._lengths[i] + lookahead - 1)
                       // self.page_size >= len(self._held[i])):
                    if self._free or self._evictable:
                        pg = self._claim_page()
                        self._held[i].append(pg)
                        idx = len(self._held[i]) - 1
                        self._grow_tables(idx + 1)
                        self._tables[i, idx] = pg
                    else:
                        victims = [j for j, s in enumerate(self._slots)
                                   if s is not None]
                        self._preempt(max(
                            victims, key=lambda j: self._admit_order[j]))
        return [i for i in survivors if self._slots[i] is not None]

    def _decode_graphs(self):
        """The paged decode step's graphs over the current pools, captured
        when the step finds none (the pools' growth drops them with the
        old pools, which they write into); None where the family keeps
        the step eager (off the card, under M-RoPE)."""
        if self._graphs is None and self._build_graphs is not None:
            self._graphs = self._build_graphs(self.params, self.cfg,
                                              self._kv, self.max_batch)
        return self._graphs

    def _paged_cache(self, lookahead: int) -> Dict:
        """The pools with this step's block table (trimmed to the width the
        next ``lookahead`` writes need) and lengths, on the device."""
        w = self._table_width(lookahead)
        dev = self.device
        return {**self._kv,
                "block_tables": torch.from_numpy(np.ascontiguousarray(
                    self._tables[:, :w])).to(dev),
                "lengths": torch.from_numpy(
                    self._lengths.astype(np.int32)).to(dev)}

    # ------------------------------------------------------------ decode step
    def _append_token(self, i: int, t: int, now: float,
                      finished: List[GenRequest]) -> bool:
        """Append one emitted token to row ``i``, retiring the row on EOS
        or budget exhaustion (EOS is dropped from the result unless it is
        the only token).  Shared by the plain step and the speculative
        acceptance loop.  Returns True while the row survives."""
        slot = self._slots[i]
        slot.out.append(t)
        if len(slot.out) == 1:
            slot.req.first_token_at = now
        hit_eos = t == self.eos_id
        if hit_eos or len(slot.out) >= slot.req.max_new:
            row = slot.out[:-1] if hit_eos and len(slot.out) > 1 \
                else slot.out
            slot.req.result = np.asarray(row, np.int32)
            slot.req.finished_at = now
            finished.append(slot.req)
            self._slots[i] = None
            if self.paged:
                self._release_pages(i)         # pages return to the pool
            self.stats.served += 1
            return False
        return True

    def _sample_resident(self, resident: List[int], finished: List[GenRequest]
                         ) -> Tuple[torch.Tensor, np.ndarray, List[int]]:
        """Sample the next token of every resident row from its carried
        logits and append it; returns the tokens (device and host) and the
        rows that survive."""
        with get_tracer().wall("engine.sample", who=self.owner,
                               rows=len(resident)):
            temps_np = np.zeros(self.max_batch, np.float32)
            for i in resident:
                temps_np[i] = self._slots[i].req.temperature
            temps = (0.0 if (temps_np <= 0.0).all()
                     else torch.from_numpy(temps_np).to(self.device))
            cur = sample(self.generator, self._logits, temperature=temps,
                         vocab_size=self.cfg.vocab_size)
            cur_np = cur[:, 0].cpu().numpy()
            now = wall_now()
            survivors = [i for i in resident
                         if self._append_token(i, int(cur_np[i]), now,
                                               finished)]
        return cur, cur_np, survivors

    def _launch_and_wait(self, fn: Callable, *args):
        """``fn(*args)``, the family's decode or verify step, inside
        ``engine.decode.launch`` (on a card it only enqueues), then the
        wait for the card inside ``engine.decode.wait``; the launch's time
        goes to ``EngineStats.decode_launch_s``."""
        tr = get_tracer()
        with tr.wall("engine.decode.launch", who=self.owner) as sp:
            out = fn(*args)
        with tr.wall("engine.decode.wait", who=self.owner):
            _sync(self.device)
        self.stats.decode_launch_s += sp.dt
        return out

    def step(self) -> List[GenRequest]:
        """One engine iteration: sample a token for every resident sequence,
        retire finished ones, prefill admissions into freed slots, then run
        one batched decode step for the sequences that continue.  A wave
        engine serves the next ``max_batch`` queued requests to the end."""
        if not self.slot_decode:
            return self._step_wave()
        if self.spec:
            return self._step_spec()
        self._admit()
        resident = [i for i, s in enumerate(self._slots) if s is not None]
        if not resident:
            return []
        # 1. sample the next token of every resident row from its logits
        finished: List[GenRequest] = []
        cur, _, survivors = self._sample_resident(resident, finished)
        # 2. admit queued work into freed slots between decode steps
        if self.continuous and finished:
            self._admit()
        # 2b. paged: claim this step's write page per survivor, preempting
        #     the most recent admissions if the pool is exhausted
        if self.paged and survivors:
            survivors = self._ensure_decode_pages(survivors)
        # 3. one batched decode step advances the surviving rows; rows that
        #    are empty or just prefilled ride along (static batch shape) --
        #    their write lands at their own depth and is overwritten by
        #    their first real decode, and their logits are kept
        if survivors:
            dev = self.device
            tr = get_tracer()
            graphs = self._decode_graphs() if self.paged else None
            with tr.wall("engine.decode_step", who=self.owner,
                         batch=len(survivors)) as spn:
                with tr.wall("engine.decode.inputs", who=self.owner):
                    if self.paged:
                        cache = self._paged_cache(1)
                    else:
                        cache = {**self._cache, "length": torch.from_numpy(
                            self._lengths.astype(np.int32)).to(dev)}
                    if graphs is not None:
                        staged = graphs.stage(cur, cache["block_tables"],
                                              cache["lengths"])
                if graphs is not None:
                    logits = self._launch_and_wait(
                        graphs.launch, cache["block_tables"],
                        staged["attend"])
                    self.stats.decode_graph_steps += 1
                else:
                    logits, _ = self._launch_and_wait(
                        self._decode_paged if self.paged else self._decode,
                        self.params, self.cfg, cache, cur)
            self.stats.decode_wall_s += spn.dt
            keep = torch.tensor(survivors, device=dev)
            self._logits[keep] = logits[keep]
            self._lengths[survivors] += 1
            self.stats.decode_tokens += len(survivors)
            self.stats.decode_steps += 1
        return finished

    # ------------------------------------------------- speculative decoding
    def _step_spec(self) -> List[GenRequest]:
        """One speculative iteration (DESIGN.md §6.1-spec): the pending
        token is sampled from the carried logits as in the plain step; the
        draft proposes ``spec_k`` tokens greedily and ONE target verify
        forward scores pending + drafts.  The longest draft prefix that
        matches the target's own greedy choices is emitted; the verify
        logits after the last accepted token become the carried logits, so
        the next iteration emits the correction.  Every emitted token is the
        target's argmax over the same prefix as plain decode."""
        self._admit()
        resident = [i for i, s in enumerate(self._slots) if s is not None]
        if not resident:
            return []
        finished: List[GenRequest] = []
        cur, cur_np, survivors = self._sample_resident(resident, finished)
        # freshly prefilled rows ride along this verify and join the next
        if self.continuous and finished:
            self._admit()
        if survivors:
            survivors = self._ensure_decode_pages(survivors,
                                                  lookahead=self.spec_k + 1)
        if not survivors:
            return finished
        k = self.spec_k
        dev = self.device
        dcfg = self.spec_draft_cfg
        # draft k tokens greedily, feeding the pending token first; the
        # draft rows advance in lock-step with the target's (riding rows
        # write garbage at their stale depth, overwritten before use)
        drafts = np.zeros((self.max_batch, k), np.int64)
        tok = cur
        with get_tracer().wall("engine.spec_draft", who=self.owner,
                               k=k, batch=len(survivors)) as dsp:
            for j in range(k + 1):
                dcache = {**self._draft_cache,
                          "length": torch.from_numpy(
                              (self._draft_lengths + j).astype(np.int32)
                          ).to(dev)}
                dlogits, _ = self._draft_decode(self.spec_draft_params, dcfg,
                                                dcache, tok)
                if j == k:
                    # the extra forward lands the last draft's KV at n + k:
                    # each proposing forward writes its INPUT token only
                    break
                tok = _greedy_tokens(dlogits[:, -1], dcfg.vocab_size)[:, None]
                drafts[:, j] = tok[:, 0].cpu().numpy()
            _sync(dev)
        self.stats.draft_wall_s += dsp.dt
        self.stats.spec_drafted += k * len(survivors)
        # verify pending + drafts in ONE target forward; rejected drafts'
        # KV lands past the valid length and is overwritten by the next one
        toks = torch.from_numpy(
            np.concatenate([cur_np[:, None], drafts], axis=1)).to(dev)
        tr = get_tracer()
        with tr.wall("engine.spec_verify", who=self.owner,
                     k=k, batch=len(survivors)) as vsp:
            with tr.wall("engine.decode.inputs", who=self.owner):
                cache = self._paged_cache(k + 1)
            vlogits, _ = self._launch_and_wait(self._verify, self.params,
                                               self.cfg, cache, toks)
        self.stats.decode_wall_s += vsp.dt
        self.stats.verify_wall_s += vsp.dt
        tgt = _greedy_tokens(vlogits, self.cfg.vocab_size).cpu().numpy()
        # per row: accept the longest matching draft prefix, emit it under
        # the usual EOS/budget rules, advance over pending + accepted only
        now = wall_now()
        rows: List[int] = []
        pos: List[int] = []
        accepts: List[int] = []
        for i in survivors:
            a = 0
            while a < k and drafts[i, a] == tgt[i, a]:
                a += 1
            self.spec_accept_hist[a] += 1
            self.stats.spec_accepted += a
            accepts.append(a)
            appended = 0
            alive = True
            for j in range(a):
                appended += 1
                if not self._append_token(i, int(drafts[i, j]), now,
                                          finished):
                    alive = False
                    break
            # tokens fed to a target forward count as decode tokens, as in
            # the plain step: a request's final token never feeds one
            self.stats.decode_tokens += appended + (1 if alive else 0)
            if alive:
                self._lengths[i] += 1 + a
                self._draft_lengths[i] = self._lengths[i]
                rows.append(i)
                pos.append(a)       # carry the logits after the last accepted
        # one EMA update per verify step, over the step's mean acceptance
        obs = sum(accepts) / (k * len(accepts))
        self.spec_alpha += _SPEC_EMA_BETA * (obs - self.spec_alpha)
        if rows:
            ridx = torch.tensor(rows, device=dev)
            self._logits[ridx] = vlogits[ridx, torch.tensor(pos, device=dev)
                                         ][:, None]
        self.stats.decode_steps += 1
        self.stats.spec_steps += 1
        return finished

    # ------------------------------------------------- left-padded waves
    def _step_wave(self) -> List[GenRequest]:
        if not self._queue:
            return []
        wave, self._queue = (self._queue[:self.max_batch],
                             self._queue[self.max_batch:])
        self._count_admitted(wave, wall_now())
        return self._generate_wave(wave)

    def _serve_wave(self, reqs: List[GenRequest]) -> List[GenRequest]:
        out: List[GenRequest] = []
        for i in range(0, len(reqs), self.max_batch):
            out.extend(self._generate_wave(reqs[i: i + self.max_batch]))
        return out

    def _generate_wave(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Left-padded lock-step decode, for families without per-row
        cache depths and for window configs: the prompts are left-padded
        with ``eos_id`` to ``pad(max prompt)`` (the pads are attended, in
        an MoE layer take expert capacity and in an xLSTM run through the
        recurrence, as in the reference), the
        cache holds ``plen + pad(max_new)`` positions, and every row decodes
        at one shared depth until each is done (EOS or budget).  A result
        ends at its first EOS, keeping at least one token."""
        assert len(reqs) <= self.max_batch
        n = len(reqs)
        plen = self._pad_bucket(max(len(r.tokens) for r in reqs))
        max_new = max(r.max_new for r in reqs)
        toks = np.full((n, plen), self.eos_id, np.int64)
        for i, r in enumerate(reqs):
            toks[i, plen - len(r.tokens):] = r.tokens     # left-pad
        cap = plen + self._pad_bucket(max_new)
        dev = self.device
        with get_tracer().wall("engine.prefill", who=self.owner, path="wave",
                               rows=n, tokens=plen * n) as sp:
            logits, cache = self._prefill(self.params, self.cfg,
                                          torch.from_numpy(toks).to(dev),
                                          capacity=cap)
            _sync(dev)
        self.stats.prefill_wall_s += sp.dt
        self.stats.prefill_tokens += plen * n
        self.stats.batches += 1
        started = wall_now()
        for r in reqs:
            r.started_at = started

        out = np.zeros((n, max_new), np.int32)
        done = np.zeros(n, bool)
        temps_np = np.array([r.temperature for r in reqs], np.float32)
        # all-greedy waves keep sample()'s scalar path
        temps = (0.0 if (temps_np <= 0.0).all()
                 else torch.from_numpy(temps_np).to(dev))
        budgets = np.array([r.max_new for r in reqs])
        for step in range(max_new):
            cur = sample(self.generator, logits, temperature=temps,
                         vocab_size=self.cfg.vocab_size)
            out[:, step] = cur[:, 0].cpu().numpy()
            if step == 0:
                now = wall_now()
                for r in reqs:
                    r.first_token_at = now
            done |= out[:, step] == self.eos_id
            done |= step + 1 >= budgets
            if done.all():
                break
            with get_tracer().wall("engine.decode_step", who=self.owner,
                                   batch=int((~done).sum())) as sp:
                logits, cache = self._launch_and_wait(
                    self._decode, self.params, self.cfg, cache, cur)
            self.stats.decode_wall_s += sp.dt
            self.stats.decode_tokens += int((~done).sum())
            self.stats.decode_steps += 1
        for i, r in enumerate(reqs):
            row = out[i, :r.max_new]
            hit = row == self.eos_id
            end = int(np.argmax(hit)) if hit.any() else r.max_new
            r.result = row[:max(end, 1)]
            r.finished_at = wall_now()
        self.stats.served += n
        return reqs
