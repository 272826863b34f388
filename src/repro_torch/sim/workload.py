"""Piecewise-Poisson request workloads (paper Table 3).

Each node's user traffic is a piecewise-homogeneous Poisson process: a list of
``(t_start, t_end, mean_interarrival_s)`` intervals.  Request lengths are drawn
from a seeded lognormal-ish distribution mimicking OpenR1-Math-220k reasoning
prompts (long outputs, max_tokens 8192 per paper Appendix C).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Request:
    rid: str
    origin: str            # node id where the user submitted it
    arrival: float         # sim time of user submission
    prompt_tokens: int
    output_tokens: int
    slo_s: float           # latency threshold for SLO attainment
    is_duel_extra: bool = False   # challenger / judge traffic (excluded from SLO)
    # cross-request prefix caching (DESIGN.md §6.1-prefix): requests from the
    # same application share a system prompt — ``prefix_id`` names it and
    # ``prefix_tokens`` is the shared-prefix length (<= prompt_tokens).
    # ``None`` means the whole prompt is unique.
    prefix_id: Optional[str] = None
    prefix_tokens: int = 0


@dataclass(frozen=True)
class ArrivalPhase:
    t_start: float
    t_end: float
    mean_interarrival: float   # 1/lambda, seconds


@dataclass
class WorkloadSpec:
    """Per-node arrival schedule, as in paper Table 3."""

    node_id: str
    phases: Sequence[ArrivalPhase]
    prompt_mean: int = 512
    output_mean: int = 2048       # reasoning traces are long
    max_tokens: int = 8192        # paper: max token length 8192
    slo_s: float = 300.0

    def arrivals(self, rng: np.random.Generator) -> List[Tuple[float, int, int]]:
        """Materialize (time, prompt_tokens, output_tokens) arrivals."""
        out: List[Tuple[float, int, int]] = []
        for ph in self.phases:
            t = ph.t_start
            while True:
                t += rng.exponential(ph.mean_interarrival)
                if t >= ph.t_end:
                    break
                p = int(np.clip(rng.lognormal(np.log(self.prompt_mean), 0.6), 16, 4096))
                o = int(np.clip(rng.lognormal(np.log(self.output_mean), 0.7), 32, self.max_tokens))
                out.append((t, p, o))
        out.sort(key=lambda x: x[0])
        return out


def make_requests(specs: Sequence[WorkloadSpec], seed: int) -> List[Request]:
    """Materialize the full multi-node workload deterministically."""
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    for spec in specs:
        for i, (t, p, o) in enumerate(spec.arrivals(rng)):
            reqs.append(Request(
                rid=f"{spec.node_id}-r{i}", origin=spec.node_id, arrival=t,
                prompt_tokens=p, output_tokens=o, slo_s=spec.slo_s))
    reqs.sort(key=lambda r: r.arrival)
    return reqs


def make_zipf_prefix_requests(n: int, node_ids: Sequence[str], seed: int, *,
                              n_prefixes: int = 8, zipf_a: float = 1.3,
                              prefix_tokens: int = 256, suffix_mean: int = 32,
                              mean_interarrival: float = 0.5,
                              output_mean: int = 64,
                              slo_s: float = 60.0) -> List[Request]:
    """Zipf-shared-prefix workload (DESIGN.md §6.1-prefix).

    Each request draws one of ``n_prefixes`` shared system prompts with
    zipf(``zipf_a``) popularity (rank 1 most popular; the unbounded tail is
    clamped onto the last rank), prepends it to a short unique suffix, and
    lands on a uniformly random origin node with exponential interarrivals —
    the traffic shape where cross-request prefix caching and cache-affinity
    dispatch pay off: most prompts are mostly a prefix some node has warm.
    """
    rng = np.random.default_rng(seed)
    reqs: List[Request] = []
    t = 0.0
    for i in range(n):
        t += rng.exponential(mean_interarrival)
        rank = min(int(rng.zipf(zipf_a)), n_prefixes)
        suffix = max(1, int(rng.lognormal(np.log(suffix_mean), 0.4)))
        reqs.append(Request(
            rid=f"z{i}",
            origin=node_ids[int(rng.integers(len(node_ids)))],
            arrival=t,
            prompt_tokens=prefix_tokens + suffix,
            output_tokens=max(8, int(rng.lognormal(np.log(output_mean), 0.5))),
            slo_s=slo_s,
            prefix_id=f"sys-{rank}",
            prefix_tokens=prefix_tokens))
    return reqs


def uniform_phases(t_end: float, mean_interarrival: float) -> List[ArrivalPhase]:
    return [ArrivalPhase(0.0, t_end, mean_interarrival)]


def two_phase(split: float, t_end: float, ia1: float, ia2: float) -> List[ArrivalPhase]:
    return [ArrivalPhase(0.0, split, ia1), ArrivalPhase(split, t_end, ia2)]
