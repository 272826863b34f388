"""The engine's step from inside, on the card: runs of one cell as
``run.py`` makes them, all in one process, each printed as one
``INSIDE {...}`` line with what the program's own counters and spans say
of the window beside the cell's listed metrics:

- ``decode_ms_a_step`` and ``decode_launch_ms_a_step``: the window's
  change of ``EngineStats.decode_wall_s`` and of ``decode_launch_s`` over
  that of ``decode_steps``; ``decode_launch_share``: 100 x the launch
  over the wall, the share of decode time in which the host is still
  enqueuing;
- ``queue_wait_ms``: 1000 x the change of ``queue_wait_s`` over that of
  ``admitted``, a request's wait from its enqueue to the start of the
  admission that took it to its prefill;
- in a traced run, the breakdown with each idle gap named by the
  innermost of the program's spans inside the step (``STEP_LABELS``),
  and each slice's clock offset taken from its first leading spin, or
  from its first trailing spin where no leading one survived, each
  against the host's clock when the launch of its slice edge's first
  spin returned; with the widest disagreement of the two over the
  slices where both survived, and the longest such launch at either
  edge.

A reading is None where the program lacks its counter.

    python portbench/tools/inside.py --workload cmdr-chat --seconds 51 \
        --seeds 11,12 --trace 0,1
"""

import argparse
import contextlib
import json
import pathlib
import sys
import time
from typing import Dict, List, Optional, Tuple

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

from portbench.harness import cell, serve, trace  # noqa: E402

# the program's spans inside a step, and the harness's own step phase,
# by the label of the idle gaps they hold
STEP_LABELS = {"engine.decode.inputs": "decode.inputs",
               "engine.decode.launch": "decode.launch",
               "engine.decode.wait": "decode.wait",
               "engine.sample": "sample", "engine.pages": "pages",
               "engine.admit": "admission", "step": "step"}


class StepPhases(trace.Phases):
    """The harness's phases with the step's parts, innermost first."""
    NAMES = {**trace.Phases.NAMES, **STEP_LABELS}
    ORDER = ("prefill", "decode.inputs", "decode.launch", "decode.wait",
             "decode", "sample", "pages", "admission", "step", "admit",
             "harness", "wait")


def readings(delta: Dict[str, float]) -> Dict[str, Optional[float]]:
    """The window's readings from its change of every ``EngineStats``
    number; None where a counter is absent or a denominator is 0."""
    def ratio(num: str, den: str, scale: float) -> Optional[float]:
        if num not in delta or not delta.get(den, 0) > 0:
            return None
        return scale * delta[num] / delta[den]

    return {
        "decode_ms_a_step": ratio("decode_wall_s", "decode_steps", 1e3),
        "decode_launch_ms_a_step": ratio("decode_launch_s", "decode_steps",
                                         1e3),
        "decode_launch_share": ratio("decode_launch_s", "decode_wall_s",
                                     100.0),
        "queue_wait_ms": ratio("queue_wait_s", "admitted", 1e3),
    }


def offsets(sl: trace.Slice, spin_names: frozenset
            ) -> Tuple[Optional[int], Optional[int]]:
    """A slice's device clock minus host clock (ns) from its first
    surviving leading spin and from its first surviving trailing spin,
    each against the host's clock when the launch of that edge's first
    spin returned (``open_ns``, ``close_ns``: before and after); None
    where no such spin survived."""
    spins = sorted((s, e) for n, s, e in sl.events if n in spin_names)
    work = [(s, e) for n, s, e in sl.events if n not in spin_names]
    if not spins or not work:
        return None, None
    first, last = min(s for s, _ in work), max(e for _, e in work)
    lead = [s for s, _ in spins if s < first]
    trail = [s for s, _ in spins if s >= last]
    close = getattr(sl, "close_ns", None)
    return (lead[0] - sl.open_ns[1] if lead else None,
            trail[0] - close[1] if trail and close else None)


def aligned(slices: List[trace.Slice], spin_names: frozenset) -> Dict:
    """Sets each slice's ``host_ns`` so that ``trace.reduce``, which takes
    the offset from the earliest surviving spin against ``host_ns``,
    takes the one from a leading spin, or from the trailing ones where
    no leading spin survived; returns how many slices took which, the
    widest disagreement (ns) where both survived, the longest launch of
    an edge's first spin (ns), and each slice's two offsets (ns)."""
    out = {"slices": len(slices), "from_trailing": 0, "neither": 0,
           "widest_disagreement_ns": None,
           "longest_first_launch_ns": {"open": 0, "close": 0},
           "offsets_ns": []}
    longest = out["longest_first_launch_ns"]
    for sl in slices:
        for edge in ("open", "close"):
            t0, t1 = getattr(sl, f"{edge}_ns", (0, 0))
            longest[edge] = max(longest[edge], t1 - t0)
        lead, trail = offsets(sl, spin_names)
        out["offsets_ns"].append([lead, trail])
        if lead is not None and trail is not None:
            d = abs(lead - trail)
            out["widest_disagreement_ns"] = max(
                d, out["widest_disagreement_ns"] or 0)
        off = lead if lead is not None else trail
        if off is None:
            out["neither"] += 1
            continue
        out["from_trailing"] += lead is None
        earliest = min(s for n, s, _ in sl.events if n in spin_names)
        sl.host_ns = earliest - off
    return out


@contextlib.contextmanager
def watched():
    """Inside: the harness's phases as ``StepPhases``, each slice stamped
    with the host's clock around the launch of each edge's first spin,
    the offsets aligned before the reduction, and every reading of the
    engines' counters kept in the yielded list."""
    seen: List[Dict[str, float]] = []
    clock: Dict = {}
    launched: List[Tuple[int, int]] = []
    real = (trace.Phases, trace.Slicer, trace.reduce, trace._spins,
            serve.counters)
    slicer = real[1]

    def spins():
        t0 = time.perf_counter_ns()
        torch.cuda._sleep(trace.EDGE_SPIN_CYCLES)
        launched.append((t0, time.perf_counter_ns()))
        for _ in range(trace.EDGE_SPINS - 1):
            torch.cuda._sleep(trace.EDGE_SPIN_CYCLES)

    class Slicer(slicer):
        def _open(self, late: bool) -> None:
            n = len(self.slices)
            slicer._open(self, late)
            if len(self.slices) > n:
                self.slices[-1].open_ns = launched[-1]

        def _close(self) -> None:
            slicer._close(self)
            self.slices[-1].close_ns = launched[-1]

    def reduce(slices, spin_names, phase_of, kernels):
        clock.update(aligned(slices, spin_names))
        return real[2](slices, spin_names, phase_of, kernels)

    def counters(nodes):
        seen.append(real[4](nodes))
        return seen[-1]

    (trace.Phases, trace.Slicer, trace.reduce, trace._spins,
     serve.counters) = (StepPhases, Slicer, reduce, spins, counters)
    try:
        yield seen, clock
    finally:
        (trace.Phases, trace.Slicer, trace.reduce, trace._spins,
         serve.counters) = real


def one(spec: cell.Spec, seed: int, seconds: float, traced: bool,
        device: torch.device, **kw) -> Dict:
    """One run of ``spec`` (``kw`` as ``cell.run`` takes them) and its
    readings."""
    with watched() as (seen, clock):
        o = cell.run(spec, seed, seconds, traced, device,
                     time.perf_counter(), **kw)
    opened, closed = seen[0], seen[1]
    delta = {k: closed[k] - opened[k] for k in opened}
    return {"workload": spec.name, "seed": seed, "trace": int(traced),
            "correct": o.correct, "metrics": o.metrics,
            "readings": readings(delta), "device": o.device,
            "breakdown": o.breakdown, "clock": clock or None,
            "notes": o.notes}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", default="0,1",
                    help="the trace settings to run each seed with, in turn")
    a = ap.parse_args()
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = cell.spec_of(bench, a.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        for traced in (bool(int(t)) for t in a.trace.split(",")):
            row = one(spec, seed, a.seconds, traced, dev)
            row["card"] = torch.cuda.get_device_name(dev)
            print("INSIDE " + json.dumps(row), flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
