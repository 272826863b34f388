"""A small batched serving engine on PyTorch -- the node's Model Manager
backend.

Port of ``repro.serving.engine`` in its three modes:

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

Prompts are right-padded, which causal attention keeps inert, so a
request's greedy output does not depend on what it is batched with: the
port's greedy streams equal the reference engine's token for token on the
same weights, in every mode.

Not ported yet, each raising ``NotImplementedError`` that names its ROADMAP
item: the prefix cache, the disaggregated KV handoff and int8 KV (Queue A
item 5), and families without slot decode, which the reference serves by
left-padded wave batching (Queue A item 7).

Wall times are measured by ``Tracer.wall`` blocks that end in a device
synchronisation, because they feed ``EngineStats`` and so
``EngineExecutor.estimate``.  Unlike the reference, whose arrays are
immutable, the slot cache, the draft cache and the page pools are updated
in place.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs import _WALL, get_registry, get_tracer, wall_now
from repro_torch.serving.sampling import masked_logits, sample
from repro_torch.sim.executor import paged_admit_ok, pages_for
from repro_torch.sim.servicemodel import (_SPEC_ALPHA0, _SPEC_EMA_BETA,
                                          _SPEC_K)


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
    peak_resident: int = 0        # max concurrently resident sequences
    preempted: int = 0            # paged: preempt-and-requeue events
    # speculative decoding: decode_tokens counts EMITTED tokens and
    # decode_wall_s the target's verify walls, so decode_tokens /
    # decode_wall_s is the effective target decode rate; the draft's own
    # cost is draft_wall_s
    spec_steps: int = 0           # verify forwards (each checks spec_k drafts)
    spec_drafted: int = 0         # draft tokens proposed
    spec_accepted: int = 0        # draft tokens matching the target's greedy
    draft_wall_s: float = 0.0     # wall time inside draft prefill/decode
    verify_wall_s: float = 0.0    # wall time inside the verify forward


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
    """Continuous batching over the PyTorch dense model: slot, paged or
    speculative (see the module docstring)."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 bucket: int = 64, seed: int = 0,
                 capacity: Optional[int] = None,
                 continuous: bool = True,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_draft: Optional[Tuple[ModelConfig, Dict]] = None,
                 spec_k: int = _SPEC_K) -> None:
        if prefix_cache:
            raise NotImplementedError(
                "prefix caching: ROADMAP Queue A item 5 (its warm prefill "
                "runs the paged verify kernel, which is ported)")
        if cfg.kv_quant:
            raise NotImplementedError(
                "int8 KV: ROADMAP Queue A item 5 (Queue B rows 2q and 3q)")
        fam = registry.get_family(cfg)
        # right-padding is only inert with a full cache: a sliding-window
        # ring keeps the last `window` positions of the PADDED sequence, so
        # the reference serves window configs by left-padded wave batching
        if not (fam.slot_decode and cfg.sliding_window is None):
            if paged:
                raise ValueError("paged KV requires full attention (the "
                                 "ring cache of a window config is "
                                 "slot-mode only)")
            raise NotImplementedError(
                f"{cfg.name}: left-padded wave batching (families without "
                f"slot decode, sliding-window configs) is ROADMAP Queue A "
                f"item 7")
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
            self._decode_paged = fam.paged_decode
            self._scatter_pages = fam.prefill_to_pages
            self._init_pools = fam.init_paged_pools
            # the page pool: page 0 is scratch, pages 1.. are usable
            self._pool_pages = (int(num_pages) if num_pages is not None
                                else max_batch * pages_for(
                                    2 * bucket, self.page_size)) + 1
            self._kv: Optional[Dict] = None             # lazy device alloc
            self._free: List[int] = list(range(1, self._pool_pages))
            self._held: List[List[int]] = [[] for _ in range(max_batch)]
            self._maxp = max(1, pages_for(2 * bucket, self.page_size))
            self._tables = np.zeros((max_batch, self._maxp), np.int32)
            # admission order, for LIFO preemption under pool pressure
            self._admit_order = np.zeros(max_batch, np.int64)
            self._admit_seq = 0

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
            used = usable - len(self._free)
            snap.update(
                pages_used=used, pages_total=usable,
                free_pages=len(self._free), page_size=self.page_size,
                # paged KV charges pages actually held, not reservations
                kv_used=used * self.page_size,
                kv_budget=usable * self.page_size)
        else:
            snap.update(
                kv_used=int(sum(self._lengths[i] + s.req.max_new - len(s.out)
                                for i, s in active)),
                kv_budget=self.max_batch * max(self._capacity, 1))
        return snap

    def serve(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Submit ``reqs`` and pump steps until the engine drains."""
        for r in reqs:
            self.submit(r)
        while self.has_work():
            self.step()
        return reqs

    # ------------------------------------------------------------- admission
    def _admit(self) -> None:
        if self.paged:
            self._admit_paged()
            return
        if not self._queue:
            return
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

    def _admit_paged(self) -> None:
        if not self._queue:
            return
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
            # makes LIFO preemption livelock-free
            needed = max(self._pages(self._required(r))
                         for r in self._queue[:self.max_batch])
            if self._kv is None or needed > usable:
                self._pool_pages = max(self._pool_pages, needed + 1)
                usable = self._pool_pages - 1
                self._kv = None
                self._logits = None
                self._free = list(range(1, self._pool_pages))
            if self.spec:
                # the draft cache grows at the same idle points
                dneeded = max(self._draft_required(r)
                              for r in self._queue[:self.max_batch])
                if self._draft_cache is None \
                        or dneeded > self._draft_capacity:
                    self._draft_capacity = max(self._draft_capacity, dneeded)
                    self._draft_cache = None
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        free_now = len(self._free)
        take: List[Tuple[int, GenRequest]] = []
        rest: List[GenRequest] = []
        taking = resident
        for r in self._queue:
            need = self._pages(len(r.tokens))
            if (free_slots and need <= free_now
                    and self._pages(self._required(r)) <= usable
                    and (not self.spec
                         or self._draft_required(r) <= self._draft_capacity)
                    and paged_admit_ok(free_now, len(r.tokens),
                                       self.page_size, resident=taking)):
                take.append((free_slots.pop(0), r))
                free_now -= need
                taking = True
            else:
                rest.append(r)
        self._queue = rest
        if take:
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
        draft's cache rows, speculative mode)."""
        for i, r in take:
            pages = [self._free.pop()
                     for _ in range(self._pages(len(r.tokens)))]
            self._held[i] = pages
            self._tables[i, :] = 0
            self._tables[i, : len(pages)] = pages
            self._slots[i] = _Slot(r)
            self._lengths[i] = len(r.tokens)
            self._admit_order[i] = self._admit_seq
            self._admit_seq += 1
        self._prefill_cold(take)
        now = wall_now()                # started_at: stamped after prefill
        for _, r in take:
            r.started_at = now
        self.stats.batches += 1
        self.stats.peak_resident = max(self.stats.peak_resident,
                                       self.active_slots())
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
        raise NotImplementedError("prefix caching: ROADMAP Queue A item 5")

    def extract_handoffs(self, cached_tokens_fn=None):
        raise NotImplementedError(
            "disaggregated KV handoff: ROADMAP Queue A item 5")

    def accept_handoff(self, h) -> bool:
        raise NotImplementedError(
            "disaggregated KV handoff: ROADMAP Queue A item 5")

    # ----------------------------------------------------- page pool dynamics
    def _release_pages(self, i: int) -> None:
        self._free.extend(self._held[i])
        self._held[i] = []
        self._tables[i, :] = 0

    def debug_page_accounting(self) -> Dict[str, int]:
        """Reconcile the free list with the rows' holdings: every usable
        page is exactly one of free or held by exactly one row."""
        assert self.paged
        usable = self._pool_pages - 1
        free = set(self._free)
        held: Dict[int, int] = {}
        for pages in self._held:
            for pg in pages:
                held[pg] = held.get(pg, 0) + 1
        assert len(free) == len(self._free), "free list has duplicates"
        assert not free & set(held), "page both free and row-held"
        shared = [pg for pg, n in held.items() if n > 1]
        assert not shared, f"pages held by several rows: {shared}"
        assert free | set(held) <= set(range(1, usable + 1)), \
            "page id out of range"
        assert len(free) + len(held) == usable, (
            f"page leak/double-free: {len(free)} free + {len(held)} held "
            f"!= {usable} usable")
        return {"free": len(free), "cold": 0, "held": len(held)}

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
        get_registry().counter("engine.preempted").inc()
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
        for i in sorted(survivors, key=lambda i: self._admit_order[i]):
            while (self._slots[i] is not None
                   and (self._lengths[i] + lookahead - 1) // self.page_size
                   >= len(self._held[i])):
                if self._free:
                    pg = self._free.pop()
                    self._held[i].append(pg)
                    idx = len(self._held[i]) - 1
                    self._grow_tables(idx + 1)
                    self._tables[i, idx] = pg
                else:
                    victims = [j for j, s in enumerate(self._slots)
                               if s is not None]
                    self._preempt(max(victims,
                                      key=lambda j: self._admit_order[j]))
        return [i for i in survivors if self._slots[i] is not None]

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
                     if self._append_token(i, int(cur_np[i]), now, finished)]
        return cur, cur_np, survivors

    def step(self) -> List[GenRequest]:
        """One engine iteration: sample a token for every resident sequence,
        retire finished ones, prefill admissions into freed slots, then run
        one batched decode step for the sequences that continue."""
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
            with get_tracer().wall("engine.decode_step", who=self.owner,
                                   batch=len(survivors)) as spn:
                if self.paged:
                    logits, _ = self._decode_paged(
                        self.params, self.cfg, self._paged_cache(1), cur)
                else:
                    cache = {**self._cache, "length": torch.from_numpy(
                        self._lengths.astype(np.int32)).to(dev)}
                    logits, _ = self._decode(self.params, self.cfg, cache,
                                             cur)
                _sync(dev)
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
        with get_tracer().wall("engine.spec_verify", who=self.owner,
                               k=k, batch=len(survivors)) as vsp:
            vlogits, _ = self._verify(self.params, self.cfg,
                                      self._paged_cache(k + 1), toks)
            _sync(dev)
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
