"""A small batched serving engine on PyTorch -- the node's Model Manager
backend, paged mode.

Port of ``repro.serving.engine`` with ``paged=True`` (DESIGN.md §6.1,
paged backend): a fixed pool of page-sized KV blocks with a per-sequence
block table, grown one page at a time during decode.  Admission charges a
request's *prompt* pages only, finished sequences return their pages to
the pool, and when the pool runs out mid-decode the most recently admitted
sequence is preempted -- its pages reclaimed, its request requeued at the
head of the queue for a greedy-deterministic restart.  Prompts are
right-padded, which causal attention keeps inert, so a request's greedy
output does not depend on what it is batched with: the port's greedy
streams equal the reference engine's token for token on the same weights.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: the slot engine (``paged=False``; Queue B row 4, the
``flash_decode`` kernel), the prefix cache and speculative decoding
(Queue A item 5, with the ``spec_verify`` kernel of Queue B row 3), the
disaggregated KV handoff and int8 pages (Queue A item 5).

Wall times are measured by ``Tracer.wall`` blocks that end in a device
synchronisation, because they feed ``EngineStats`` and so
``EngineExecutor.estimate``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs import _WALL, get_registry, get_tracer, wall_now
from repro_torch.serving.sampling import sample
from repro_torch.sim.executor import paged_admit_ok, pages_for


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
    """Paged continuous batching over the PyTorch dense model."""

    def __init__(self, cfg: ModelConfig, params, *, max_batch: int = 8,
                 bucket: int = 64, seed: int = 0,
                 paged: bool = False, page_size: int = 16,
                 num_pages: Optional[int] = None,
                 prefix_cache: bool = False,
                 spec_draft: Optional[Tuple[ModelConfig, Dict]] = None
                 ) -> None:
        if not paged:
            raise NotImplementedError(
                "the slot engine waits for the flash_decode port (ROADMAP "
                "Queue B row 4); pass paged=True")
        if prefix_cache:
            raise NotImplementedError(
                "prefix caching: ROADMAP Queue A item 5 (its warm prefill "
                "needs the spec_verify kernel, Queue B row 3)")
        if spec_draft is not None:
            raise NotImplementedError(
                "speculative decoding: ROADMAP Queue A item 5 (with the "
                "spec_verify kernel, Queue B row 3)")
        if cfg.kv_quant:
            raise NotImplementedError("int8 KV pages: ROADMAP Queue B row 2q")
        if cfg.sliding_window is not None:
            raise ValueError("paged KV requires full attention (the ring "
                             "cache of a window config is slot-mode only)")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.bucket = bucket
        self.device = params["embed"].device
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.stats = EngineStats()
        # trace span identity (DESIGN.md §Observability): the owning
        # executor forwards the node id the Node binds onto it
        self.owner = ""
        self.eos_id = cfg.eos_id
        self.paged = True
        self.page_size = int(page_size)
        fam = registry.get_family(cfg)
        self._prefill = fam.prefill
        self._decode_paged = fam.paged_decode
        self._scatter_pages = fam.prefill_to_pages
        self._init_pools = fam.init_paged_pools

        self._queue: List[GenRequest] = []
        self._slots: List[Optional[_Slot]] = [None] * max_batch
        self._lengths = np.zeros(max_batch, np.int64)   # per-row cache depth
        self._logits: Optional[torch.Tensor] = None

        # the page pool: page 0 is scratch, pages 1.. are usable
        self._pool_pages = (int(num_pages) if num_pages is not None
                            else max_batch * pages_for(2 * bucket,
                                                       self.page_size)) + 1
        self._kv: Optional[Dict] = None                 # lazy device alloc
        self._free: List[int] = list(range(1, self._pool_pages))
        self._held: List[List[int]] = [[] for _ in range(max_batch)]
        self._maxp = max(1, pages_for(2 * bucket, self.page_size))
        self._tables = np.zeros((max_batch, self._maxp), np.int32)
        # admission order, for LIFO preemption under pool pressure
        self._admit_order = np.zeros(max_batch, np.int64)
        self._admit_seq = 0

    def _pad_bucket(self, n: int) -> int:
        b = self.bucket
        return max(b, (n + b - 1) // b * b)

    def _required(self, r: GenRequest) -> int:
        """Worst-case cache tokens a request may touch."""
        return self._pad_bucket(len(r.tokens)) + self._pad_bucket(r.max_new)

    # ------------------------------------------------------------- interface
    def submit(self, r: GenRequest) -> None:
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
        active = [s for s in self._slots if s is not None]
        usable = self._pool_pages - 1
        used = usable - len(self._free)
        return dict(
            active_streams=len(active),
            queued_streams=len(self._queue),
            queued_prompt_tokens=sum(len(r.tokens) for r in self._queue),
            queued_new_tokens=sum(r.max_new for r in self._queue),
            pending_decode_tokens=sum(s.req.max_new - len(s.out)
                                      for s in active),
            pages_used=used, pages_total=usable, free_pages=len(self._free),
            page_size=self.page_size,
            # paged KV charges pages actually held, not reservations
            kv_used=used * self.page_size, kv_budget=usable * self.page_size,
            cached_pages=0, prefix_hit_rate=0.0, resident_prefixes=())

    def serve(self, reqs: List[GenRequest]) -> List[GenRequest]:
        """Submit ``reqs`` and pump steps until the engine drains."""
        for r in reqs:
            self.submit(r)
        while self.has_work():
            self.step()
        return reqs

    # -------------------------------------------------------- paged admission
    def _pages(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def _admit_paged(self) -> None:
        if not self._queue:
            return
        resident = any(s is not None for s in self._slots)
        usable = self._pool_pages - 1
        if resident and any(self._pages(self._required(r)) > usable
                            for r in self._queue):
            # a queued request cannot fit the pool even alone; stop
            # backfilling so the batch drains and the growth branch runs
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
        free_slots = [i for i, s in enumerate(self._slots) if s is None]
        free_now = len(self._free)
        take: List[Tuple[int, GenRequest]] = []
        rest: List[GenRequest] = []
        taking = resident
        for r in self._queue:
            need = self._pages(len(r.tokens))
            if (free_slots and need <= free_now
                    and self._pages(self._required(r)) <= usable
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

    def _table_width(self) -> int:
        """Logical-page width the decode block table needs this step: every
        resident row's allocated pages, plus the page its next write lands
        in (a riding-along row whose prompt exactly fills its pages writes
        into the next, unallocated logical page, and without that column
        the clamped lookup would alias slot 0 of its own last real page).
        Rounded up to a power of two, capped at the full table."""
        need = 1
        for i, s in enumerate(self._slots):
            if s is None:
                continue
            need = max(need, len(self._held[i]),
                       int(self._lengths[i]) // self.page_size + 1)
        w = 1
        while w < need:
            w *= 2
        return min(w, self._maxp)

    def _prefill_paged(self, take: List[Tuple[int, GenRequest]]) -> None:
        """Claim the admitted rows' prompt pages, then prefill them."""
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

    def _prefill_cold(self, cold: List[Tuple[int, GenRequest]]) -> None:
        """Right-padded prompt prefill, then scatter the contiguous KV into
        the rows' already-allocated pool pages (pad-tail pages alias the
        scratch page 0, which per-row lengths keep inert)."""
        n = len(cold)
        plen = self._pad_bucket(max(len(r.tokens) for _, r in cold))
        plen = -(-plen // self.page_size) * self.page_size  # page multiple
        toks = np.full((n, plen), self.eos_id, np.int64)
        last = np.zeros(n, np.int64)
        phys = np.zeros((n, plen // self.page_size), np.int64)
        for j, (i, r) in enumerate(cold):
            toks[j, : len(r.tokens)] = r.tokens      # right-pad (inert)
            last[j] = len(r.tokens) - 1
            phys[j, : len(self._held[i])] = self._held[i]
        dev = self.device
        with get_tracer().wall("engine.prefill", who=self.owner, path="cold",
                               rows=n, tokens=plen * n) as sp:
            logits, cache = self._prefill(
                self.params, self.cfg, torch.from_numpy(toks).to(dev),
                capacity=plen, last_positions=torch.from_numpy(last).to(dev))
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
        self._queue.insert(0, r)
        self.stats.preempted += 1
        get_registry().counter("engine.preempted").inc()
        tr = get_tracer()
        if tr.enabled:
            tr.event("executor.preempt", r.rid, self.owner, wall_now(),
                     clock=_WALL, row=i)

    def _ensure_decode_pages(self, survivors: List[int]) -> List[int]:
        """Allocate the page each surviving row's next write lands in.
        Under pool pressure the most recently admitted resident is
        preempted until a page frees; oldest rows are served first, so the
        oldest admission always makes progress and the loop terminates."""
        for i in sorted(survivors, key=lambda i: self._admit_order[i]):
            while (self._slots[i] is not None
                   and self._lengths[i] // self.page_size
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

    # ------------------------------------------------------------ decode step
    def _append_token(self, i: int, t: int, now: float,
                      finished: List[GenRequest]) -> bool:
        """Append one emitted token to row ``i``, retiring the row on EOS
        or budget exhaustion (EOS is dropped from the result unless it is
        the only token).  Returns True while the row survives."""
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
            self._release_pages(i)             # pages return to the pool
            self.stats.served += 1
            return False
        return True

    def step(self) -> List[GenRequest]:
        """One engine iteration: sample a token for every resident sequence,
        retire finished ones, prefill admissions into freed slots, then run
        one batched paged decode step for the sequences that continue."""
        self._admit_paged()
        resident = [i for i, s in enumerate(self._slots) if s is not None]
        if not resident:
            return []
        # 1. sample the next token of every resident row from its logits
        temps_np = np.zeros(self.max_batch, np.float32)
        for i in resident:
            temps_np[i] = self._slots[i].req.temperature
        temps = (0.0 if (temps_np <= 0.0).all()
                 else torch.from_numpy(temps_np).to(self.device))
        cur = sample(self.generator, self._logits, temperature=temps,
                     vocab_size=self.cfg.vocab_size)
        cur_np = cur[:, 0].cpu().numpy()
        now = wall_now()
        finished: List[GenRequest] = []
        survivors: List[int] = []
        for i in resident:
            if self._append_token(i, int(cur_np[i]), now, finished):
                survivors.append(i)
        # 2. admit queued work into freed slots between decode steps
        if finished:
            self._admit_paged()
        # 2b. claim this step's write page per survivor, preempting the
        #     most recent admissions if the pool is exhausted
        if survivors:
            survivors = self._ensure_decode_pages(survivors)
        # 3. one batched decode step advances the surviving rows; rows that
        #    are empty or just prefilled ride along (static batch shape) --
        #    their write lands at their own depth and is overwritten by
        #    their first real decode, and their logits are kept
        if survivors:
            dev = self.device
            with get_tracer().wall("engine.decode_step", who=self.owner,
                                   batch=len(survivors)) as spn:
                w = self._table_width()
                cache = {**self._kv,
                         "block_tables": torch.from_numpy(np.ascontiguousarray(
                             self._tables[:, :w])).to(dev),
                         "lengths": torch.from_numpy(
                             self._lengths.astype(np.int32)).to(dev)}
                logits, _ = self._decode_paged(self.params, self.cfg, cache,
                                               cur)
                _sync(dev)
            self.stats.decode_wall_s += spn.dt
            keep = torch.tensor(survivors, device=dev)
            self._logits[keep] = logits[keep]
            self._lengths[survivors] += 1
            self.stats.decode_tokens += len(survivors)
            self.stats.decode_steps += 1
        return finished
