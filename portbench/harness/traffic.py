"""The open-loop traffic generator: one general generator that every
traffic mix (a JSON file of parameters under ``portbench/traffic/``) feeds.

After the port's piecewise-Poisson workload (``sim/workload.py``'s
``WorkloadSpec``), frozen here and not imported.  Arrivals are an open loop
at a fixed mean rate with exponential gaps; prompt and output lengths are
clipped lognormals.  Each phase of a run (the warm-up before the measured
window, the window, and the drain after it) takes its own set of gaps,
lengths and origins: the distributions' quantiles at evenly spaced levels,
shuffled by the mix's own ``schedule_seed``.  So the schedule is one fixed
draw of the cell, like a replayed trace, and the run's seed draws the
prompts' token ids (and, elsewhere, the weights).  A schedule shuffled by
the run's seed made the 95th percentile of the time to first token swing
by a factor of two from seed to seed (the same seed repeated within 2%):
the order of long prompts, not the program, set the tail.
"""

from __future__ import annotations

import json
import math
import pathlib
from dataclasses import dataclass
from statistics import NormalDist
from typing import Dict, List, Sequence

import numpy as np

PHASES = ("warmup", "window", "drain")


@dataclass(frozen=True)
class Arrival:
    rid: str
    phase: str             # warmup | window | drain
    at: float              # seconds after traffic starts
    origin: str            # the node the user sends it to
    prompt_len: int
    output_len: int


def load(path: pathlib.Path) -> Dict:
    mix = json.loads(pathlib.Path(path).read_text())
    for key in ("rate_per_s", "prompt", "output", "origins", "warmup_s",
                "drain_s", "schedule_seed"):
        if key not in mix:
            raise KeyError(f"traffic {path}: no {key!r}")
    return mix


def lognormal_levels(spec: Dict, n: int) -> np.ndarray:
    """``n`` lengths: the clipped lognormal's quantiles at levels
    (i + 0.5) / n, rounded to whole tokens."""
    nd = NormalDist()
    z = np.array([nd.inv_cdf((i + 0.5) / n) for i in range(n)])
    x = spec["median"] * np.exp(spec["sigma"] * z)
    return np.clip(np.rint(x), spec["min"], spec["max"]).astype(np.int64)


def exponential_gaps(n: int, span: float) -> np.ndarray:
    """``n`` gaps from the exponential's quantiles at levels (i + 0.5) / n,
    scaled so that they add up to ``span`` seconds."""
    u = (np.arange(n) + 0.5) / n
    g = -np.log1p(-u)
    return g * (span / g.sum())


def origin_labels(origins: Dict[str, float], n: int) -> List[str]:
    """``n`` origins in the mix's shares, largest remainders rounded."""
    names = sorted(origins)
    raw = [origins[k] * n / sum(origins.values()) for k in names]
    counts = [int(math.floor(r)) for r in raw]
    for i in sorted(range(len(names)), key=lambda i: counts[i] - raw[i])[
            : n - sum(counts)]:
        counts[i] += 1
    return [k for k, c in zip(names, counts) for _ in range(c)]


def schedule(mix: Dict, seconds: float) -> List[Arrival]:
    """Every arrival of one run, in time order: ``mix["warmup_s"]`` of
    traffic before the window, ``seconds`` of window, and
    ``mix["drain_s"]`` after it (traffic goes on while the window's last
    requests finish)."""
    rng = np.random.default_rng(mix["schedule_seed"])
    spans = {"warmup": float(mix["warmup_s"]), "window": float(seconds),
             "drain": float(mix["drain_s"])}
    out: List[Arrival] = []
    t0 = 0.0
    for phase in PHASES:
        span = spans[phase]
        n = max(1, int(round(mix["rate_per_s"] * span)))
        gaps = rng.permutation(exponential_gaps(n, span))
        prompts = rng.permutation(lognormal_levels(mix["prompt"], n))
        outputs = rng.permutation(lognormal_levels(mix["output"], n))
        origins = rng.permutation(origin_labels(mix["origins"], n))
        # the first arrival of a phase comes one gap after its start
        at = t0 + np.cumsum(gaps)
        for i in range(n):
            out.append(Arrival(f"{phase}-{i}", phase, float(at[i]),
                               str(origins[i]), int(prompts[i]),
                               int(outputs[i])))
        t0 += span
    out.sort(key=lambda a: a.at)
    return out


def prompt_tokens(arrivals: Sequence[Arrival], vocab: int, seed: int
                  ) -> Dict[str, np.ndarray]:
    """Each request's prompt token ids, uniform over [2, vocab) (ids 0 and
    1 are left out: 1 is the port's end-of-sequence id and pads prompts),
    from a generator of its own, derived from the seed."""
    rng = np.random.default_rng([seed, 1])
    return {a.rid: rng.integers(2, vocab, size=a.prompt_len).astype(np.int32)
            for a in arrivals}
