"""Trace export: Perfetto ``trace_event`` JSON + latency breakdowns.

The port's own copy of ``repro.obs.export``.

Two consumers of the same span stream (DESIGN.md §Observability):

* :func:`to_chrome_trace` / :func:`write_chrome_trace` — the Chrome
  ``trace_event`` array format that chrome://tracing and ui.perfetto.dev
  load directly.  The two clock domains become two Perfetto *processes*
  (``sim-time`` and ``wall-time``) so simulated seconds and wall seconds
  never share an axis; each node/executor id becomes a named thread.
  Interval spans are complete events (``ph: "X"``, microsecond ``ts`` /
  ``dur``); instants (``t0 == t1``: admissions, preemptions) are thread-
  scoped instant events (``ph: "i"``).
* :func:`latency_breakdown` / :func:`breakdown_report` — "where did this
  request's latency go?": per request, the stage spans in start order
  with durations, plus the covered total.  The sim-side lifecycle spans
  partition ``[arrival, finish]`` by construction, so the per-stage sums
  reconstruct ``CompletedRequest.latency`` (the ``--trace`` acceptance
  check and the smoke round-trip both assert this).
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List

from repro_torch.obs.tracer import _SIM, _WALL, Span

_PROCESS = {_SIM: (1, "sim-time"), _WALL: (2, "wall-time")}


def to_chrome_trace(spans: Iterable[Span]) -> Dict[str, Any]:
    """Render spans as a Chrome ``trace_event`` payload (JSON-able dict).

    Wall-clock timestamps are rebased to the earliest wall span so the
    trace starts near zero; sim timestamps are already small seconds.
    """
    spans = list(spans)
    base = {_SIM: 0.0, _WALL: 0.0}
    walls = [s.t0 for s in spans if s.clock == _WALL]
    if walls:
        base[_WALL] = min(walls)

    events: List[Dict[str, Any]] = []
    tids: Dict[tuple, int] = {}
    for clock, (pid, pname) in sorted(_PROCESS.items()):
        events.append({"ph": "M", "pid": pid, "tid": 0,
                       "name": "process_name", "args": {"name": pname}})

    for s in spans:
        pid, _ = _PROCESS.get(s.clock, _PROCESS[_SIM])
        key = (pid, s.who)
        tid = tids.get(key)
        if tid is None:
            tid = tids[key] = len(tids) + 1
            events.append({"ph": "M", "pid": pid, "tid": tid,
                           "name": "thread_name",
                           "args": {"name": s.who or "-"}})
        ts = (s.t0 - base[s.clock]) * 1e6
        args = {"rid": s.rid, **s.attrs} if s.rid else dict(s.attrs)
        ev: Dict[str, Any] = {"name": s.name,
                              "cat": s.name.split(".", 1)[0],
                              "pid": pid, "tid": tid,
                              "ts": round(ts, 3), "args": args}
        if s.t1 <= s.t0:
            ev["ph"] = "i"
            ev["s"] = "t"          # thread-scoped instant
        else:
            ev["ph"] = "X"
            ev["dur"] = round((s.t1 - s.t0) * 1e6, 3)
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_chrome_trace(spans: Iterable[Span], path: str) -> Dict[str, Any]:
    """Serialize :func:`to_chrome_trace` to ``path``; returns the payload
    so callers can assert on what was written."""
    payload = to_chrome_trace(spans)
    with open(path, "w") as f:
        json.dump(payload, f)
    return payload


def latency_breakdown(spans: Iterable[Span]) -> Dict[str, Dict[str, Any]]:
    """Per request id: stage durations (summed per span name, seconds),
    the covered ``total`` (earliest start to latest end), and the span
    count.  Batch-scoped spans (``rid == ""``) are excluded — they
    describe engine steps, not any one request."""
    groups: Dict[str, List[Span]] = {}
    for s in spans:
        if s.rid:
            groups.setdefault(s.rid, []).append(s)
    out: Dict[str, Dict[str, Any]] = {}
    for rid, ss in groups.items():
        ss.sort(key=lambda s: (s.t0, s.t1))
        stages: Dict[str, float] = {}
        for s in ss:
            stages[s.name] = stages.get(s.name, 0.0) + s.dur
        out[rid] = {"stages": stages,
                    "total": max(s.t1 for s in ss) - min(s.t0 for s in ss),
                    "spans": len(ss)}
    return out


def breakdown_report(spans: Iterable[Span], limit: int = 0) -> str:
    """The plain-text "where did this request's latency go?" report:
    one block per request (all of them, or the ``limit`` slowest), each
    stage with its duration and share of the covered total."""
    bd = latency_breakdown(spans)
    rids = sorted(bd, key=lambda r: -bd[r]["total"])
    if limit:
        rids = rids[:limit]
    lines: List[str] = []
    for rid in rids:
        entry = bd[rid]
        total = entry["total"]
        lines.append(f"{rid}: total {total * 1e3:.3f} ms "
                     f"({entry['spans']} spans)")
        for name, dur in sorted(entry["stages"].items(),
                                key=lambda kv: -kv[1]):
            share = dur / total if total > 0 else 0.0
            lines.append(f"  {name:<18s} {dur * 1e3:10.3f} ms "
                         f"{share:6.1%}")
    return "\n".join(lines)
