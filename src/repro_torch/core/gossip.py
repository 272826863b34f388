"""Gossip-driven peer synchronization (paper §A.2, Figure 10) plus the
load-dissemination plane (DESIGN.md §6.2-gossip).

Every node keeps a local view: node_id -> PeerRecord(version, online, addr,
last_seen, digest).  In each gossip round a node exchanges its full view with
a few random peers; each side keeps, per entry, the record with the higher
*version* (a per-origin monotonic counter bumped by the origin on any status /
address change, and by heartbeats).

Two payloads ride the same versioned records:

* **Load digests** — each heartbeat carries a compact ``LoadDigest`` of the
  origin's ``ExecutorLoad`` (headrooms, phase backlogs, speculative speedup,
  cumulative handoff bytes, prefix-cache hit rate plus the fingerprints of
  its most-recently-touched resident prefixes for cache-affinity dispatch
  (DESIGN.md §6.1-prefix), snapshot timestamp).  Because the digest is
  versioned by the same per-origin counter, anti-entropy merging propagates
  the freshest digest for free; routers rank candidates from this stale
  table with staleness discounting instead of probing every candidate.
* **Dead reports** — when a peer's heartbeat goes stale past
  ``suspect_after``, the suspecting node marks it offline *at the suspected
  version*.  The merge rule treats offline-at-equal-version as newer, so
  the suspicion spreads epidemically until the whole view agrees
  (consensus), while a revived origin's own heartbeat — which always
  carries a strictly higher version — overrides the report everywhere it
  has spread.  A node that receives a dead report about *itself* refutes it
  by jumping its own version past the report's.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.sim.executor import LoadDigest


@dataclass(frozen=True)
class PeerRecord:
    node_id: str
    version: int
    online: bool
    addr: str
    heartbeat_time: float    # origin-local time of the last self-update
    digest: Optional[LoadDigest] = None   # load digest published at heartbeat


class PeerView:
    """One node's local membership view.

    ``view_cap`` bounds the number of *remote* records retained (partial
    views, HyParView-style): past the cap, merging evicts the records with
    the stalest heartbeats.  ``None`` (the default) keeps full membership —
    the cap only matters at the 10k-node scale where O(n) views per node
    stop being realistic.
    """

    def __init__(self, self_id: str, addr: str, now: float = 0.0,
                 view_cap: Optional[int] = None) -> None:
        self.self_id = self_id
        self.view_cap = view_cap
        self.records: Dict[str, PeerRecord] = {
            self_id: PeerRecord(self_id, 1, True, addr, now)
        }

    # -- local mutations (the origin bumps its own version) ------------------
    def heartbeat(self, now: float, digest: Optional[LoadDigest] = None) -> None:
        """Bump own version; piggyback a fresh load digest when given (a
        ``None`` digest keeps the previously published one)."""
        r = self.records[self.self_id]
        self.records[self.self_id] = replace(
            r, version=r.version + 1, heartbeat_time=now, online=True,
            digest=digest if digest is not None else r.digest)

    def set_offline(self, now: float) -> None:
        r = self.records[self.self_id]
        self.records[self.self_id] = replace(r, version=r.version + 1,
                                             online=False, heartbeat_time=now)

    def set_addr(self, addr: str, now: float) -> None:
        r = self.records[self.self_id]
        self.records[self.self_id] = replace(r, version=r.version + 1,
                                             addr=addr, heartbeat_time=now)

    # -- anti-entropy merge ---------------------------------------------------
    def merge(self, remote: Iterable[PeerRecord]) -> int:
        """Per node, keep the higher-version record; at *equal* version a
        dead report (offline) beats a live record, so suspicion propagates
        without stealing the origin's version counter.  Returns #updates
        taken."""
        taken = 0
        for rec in remote:
            mine = self.records.get(rec.node_id)
            if rec.node_id == self.self_id:
                assert mine is not None
                if mine.online and not rec.online and rec.version >= mine.version:
                    # dead report about myself: refute it by jumping past
                    # the report's version so the refutation wins merges.
                    self.records[self.self_id] = replace(
                        mine, version=rec.version + 1, online=True)
                    taken += 1
                continue
            if (mine is None or rec.version > mine.version
                    or (rec.version == mine.version
                        and mine.online and not rec.online)):
                self.records[rec.node_id] = rec
                taken += 1
        if taken:
            self._evict_over_cap()
        return taken

    def _evict_over_cap(self) -> None:
        cap = self.view_cap
        if cap is None:
            return
        extra = (len(self.records) - 1) - cap
        if extra <= 0:
            return
        stalest = sorted(
            (r.heartbeat_time, nid) for nid, r in self.records.items()
            if nid != self.self_id)[:extra]
        for _, nid in stalest:
            del self.records[nid]

    def suspect_failures(self, now: float, suspect_after: float) -> List[str]:
        """Mark peers offline whose heartbeat is stale.  The mark keeps the
        suspected version — the dead-at-equal-version merge rule then
        gossips it to consensus, while the origin's next heartbeat (a
        strictly higher version) revives it everywhere."""
        newly = []
        for nid, rec in list(self.records.items()):
            if nid == self.self_id or not rec.online:
                continue
            if now - rec.heartbeat_time > suspect_after:
                self.records[nid] = replace(rec, online=False)
                newly.append(nid)
        return newly

    def online_peers(self) -> List[str]:
        return sorted(n for n, r in self.records.items()
                      if r.online and n != self.self_id)

    def digest_of(self, nid: str) -> Optional[LoadDigest]:
        """Last gossip-learned load digest for ``nid`` (None = never seen)."""
        rec = self.records.get(nid)
        return rec.digest if rec is not None else None

    def knows(self, nid: str) -> bool:
        return nid in self.records

    def snapshot(self) -> List[PeerRecord]:
        return list(self.records.values())


def gossip_round(a: PeerView, b: PeerView) -> Tuple[int, int]:
    """Symmetric pairwise exchange (paper Fig 10). Returns updates taken by each."""
    snap_a, snap_b = a.snapshot(), b.snapshot()
    return a.merge(snap_b), b.merge(snap_a)


def rounds_to_convergence(views: Sequence[PeerView], rng: np.random.Generator,
                          fanout: int = 2, max_rounds: int = 64) -> int:
    """Drive random pairwise gossip until all views agree — including the
    digest payloads, so convergence means every node also holds the same
    load picture, not just the same membership.  Returns #rounds."""
    def state(v: PeerView) -> Dict[str, Tuple[int, bool, Optional[LoadDigest]]]:
        return {n: (r.version, r.online, r.digest) for n, r in v.records.items()}

    for rnd in range(1, max_rounds + 1):
        for v in views:
            peers = [w for w in views if w is not v]
            for w in rng.choice(len(peers), size=min(fanout, len(peers)),
                                replace=False):
                gossip_round(v, peers[int(w)])
        base = state(views[0])
        if all(state(v) == base for v in views[1:]):
            return rnd
    return max_rounds
