"""The traced run's readings: ``torch.profiler`` slices spread evenly over
the whole window, each kernel launch's shapes as the host made it, and the
host's phases, reduced to device busy time, kernel roofline shares and the
breakdown.

Which kernels are read is not known here: each kernel roofline metric
declares its ``Kernel`` (``metrics/<name>.py``): the entry of
``repro_torch.kernels.ops`` to wrap, how to tell its device records by
symbol, and each launch's least time from the call's arguments.

A slice opens with a device synchronisation and ``EDGE_SPINS`` short
spinning kernels and closes with as many and a synchronisation: the
profiler may lose records at a session's edges, and those are the spins'
(left out of every sum); they also mark the slice's bounds on the device
clock.  A kernel's roofline share is summed only over slices in which the
profiler saw exactly the launches the host made of it.
"""

from __future__ import annotations

import inspect
import time
from collections import Counter, defaultdict
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

from portbench.harness import roofline

EDGE_SPINS, EDGE_SPIN_CYCLES = 32, 2_000

Cost = Callable[[], Dict[str, float]]


@dataclass(frozen=True)
class Kernel:
    """What a kernel roofline metric reads in a traced run.  ``entry`` is
    the attribute of ``repro_torch.kernels.ops`` that launches it;
    ``symbol`` tells its device records by name; ``note`` takes the call's
    arguments by name (bound to the entry's signature, defaults applied)
    and returns a function, called once the slice has closed, that gives
    the launch's ``bytes`` and ``flops``.  Where one call may launch a
    second kernel that belongs to the same work (a split row's merge),
    ``aux_symbol`` tells it and ``aux_launches(entry)``, read after the
    call, says how many the call made."""
    entry: str
    symbol: Callable[[str], bool]
    note: Callable[[Dict[str, Any]], Cost]
    aux_symbol: Optional[Callable[[str], bool]] = None
    aux_launches: Optional[Callable[[Any], int]] = None


@dataclass
class Launch:
    kind: str                        # the metric's name
    cost: Cost
    aux: int = 0


@dataclass
class Slice:
    host_ns: int                     # host clock at the leading spins
    launches: List[Launch] = field(default_factory=list)
    events: list = field(default_factory=list)   # (name, start_ns, end_ns)
    prof: object = None           # the stopped session, read after the run


class Recorder:
    """Wraps each ``repro_torch.kernels.ops`` entry that a listed kernel
    declares, to note each launch's shapes while a slice is open."""

    def __init__(self, kernels: Dict[str, Kernel]) -> None:
        self.kernels = kernels
        self.current: Optional[Slice] = None
        self._undo: List[Tuple[object, str, object]] = []

    def install(self) -> None:
        from repro_torch.kernels import ops
        by_entry: Dict[str, List[Tuple[str, Kernel]]] = defaultdict(list)
        for name, k in self.kernels.items():
            by_entry[k.entry].append((name, k))
        for entry, ks in by_entry.items():
            real = getattr(ops, entry)
            self._undo.append((ops, entry, real))
            setattr(ops, entry, self._wrap(real, ks))

    def _wrap(self, real, ks: List[Tuple[str, Kernel]]):
        sig = inspect.signature(real)
        rec = self

        def noted(*args, **kwargs):
            out = real(*args, **kwargs)
            if rec.current is not None:
                bound = sig.bind(*args, **kwargs)
                bound.apply_defaults()
                for name, k in ks:
                    rec.current.launches.append(Launch(
                        name, k.note(bound.arguments),
                        k.aux_launches(real) if k.aux_launches else 0))
            return out

        return noted

    def uninstall(self) -> None:
        for mod, name, fn in self._undo:
            setattr(mod, name, fn)
        self._undo.clear()


def _spins() -> None:
    for _ in range(EDGE_SPINS):
        torch.cuda._sleep(EDGE_SPIN_CYCLES)


def _device_events(prof) -> List[Tuple[str, int, int]]:
    """(name, start_ns, end_ns) of every device activity of a stopped
    profiler session, read from its raw results (no host-side event tree
    is built)."""
    from torch.autograd import DeviceType
    inner = prof.profiler
    raw = getattr(inner, "kineto_results", None)
    if raw is not None:
        return [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in raw.events()
                if e.device_type() == DeviceType.CUDA]
    return [(e.name, int(e.time_range.start * 1e3),
             int(e.time_range.end * 1e3)) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


class Slicer:
    """Opens ``n`` profiler slices of ``slice_s`` seconds, their centres
    spread evenly over the window [open_at, open_at + seconds) of the
    replay's clock."""

    def __init__(self, open_at: float, seconds: float, n: int,
                 slice_s: float, recorder: Recorder) -> None:
        step = seconds / n
        self.bounds = [(open_at + (j + 0.5) * step - slice_s / 2,
                        open_at + (j + 0.5) * step + slice_s / 2)
                       for j in range(n)]
        self.recorder = recorder
        self.slices: List[Slice] = []
        self.spin_names: frozenset = frozenset()
        self.overhead_s: List[float] = []   # host seconds each close took
        self._prof = None
        self._next = 0

    def warm(self) -> None:
        """Set-up: one short session, so that the profiler's own start-up
        is paid before the window, and the spinning kernels' names."""
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            _spins()
            torch.cuda.synchronize()
        self.spin_names = frozenset(n for n, _, _ in _device_events(prof))

    def tick(self, t: float) -> None:
        if self._prof is not None and t >= self.bounds[self._next - 1][1]:
            self._close()
        if (self._prof is None and self._next < len(self.bounds)
                and t >= self.bounds[self._next][0]):
            self._open(t >= self.bounds[self._next][1])

    def _open(self, late: bool) -> None:
        from torch.profiler import ProfilerActivity, profile
        self._next += 1
        if late:                   # a step outran the whole slice
            return
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CUDA])
        self._prof.start()
        sl = Slice(host_ns=time.perf_counter_ns())
        _spins()
        self.slices.append(sl)
        self.recorder.current = sl

    def _close(self) -> None:
        t = time.perf_counter()
        _spins()
        torch.cuda.synchronize()
        self.recorder.current = None
        self._prof.stop()
        self.slices[-1].prof = self._prof
        self._prof = None
        self.overhead_s.append(time.perf_counter() - t)

    def finish(self) -> None:
        """After the window: close an open slice, then read every slice's
        device records (outside the window, since reading takes time)."""
        if self._prof is not None:
            self._close()
        for sl in self.slices:
            sl.events = _device_events(sl.prof)
            sl.prof = None


@dataclass
class Reading:
    busy_s: float
    window_s: float
    kernels: Dict[str, Dict[str, float]]     # metric -> bound_s, device_s
    skipped: Dict[str, int]                  # metric -> slices left out
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]
    slices: int


def _union(intervals: Sequence[Tuple[int, int]], lo: int, hi: int) -> int:
    busy, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _gaps(intervals: Sequence[Tuple[int, int]], lo: int, hi: int
          ) -> List[Tuple[int, int]]:
    out, at = [], lo
    for s, e in sorted(intervals):
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def reduce(slices: Sequence[Slice], spin_names: frozenset,
           phase_of: Callable[[int], str],
           kernels: Dict[str, Kernel]) -> Reading:
    """The readings of every slice.  ``phase_of(host_ns)`` names what the
    host was doing at a host clock time; ``kernels`` are the listed kernel
    metrics' declarations, by metric name."""
    busy = window = 0
    k_bound: Dict[str, float] = defaultdict(float)
    k_dev: Dict[str, float] = defaultdict(float)
    skipped: Counter = Counter()
    ops: Counter = Counter()
    idle: Counter = Counter()
    for sl in slices:
        spins = sorted((s, e) for n, s, e in sl.events if n in spin_names)
        work = [(n, s, e) for n, s, e in sl.events if n not in spin_names]
        if not spins:
            continue
        first_work = min((s for _, s, _ in work), default=None)
        last_work = max((e for _, _, e in work), default=None)
        lead = [x for x in spins if first_work is None or x[0] < first_work]
        trail = [x for x in spins if last_work is not None
                 and x[0] >= last_work]
        lo = max(e for _, e in lead) if lead else first_work
        hi = min(s for s, _ in trail) if trail else last_work
        if lo is None or hi is None or hi <= lo:
            continue
        ivals = [(s, e) for _, s, e in work]
        busy += _union(ivals, lo, hi)
        window += hi - lo
        offset = spins[0][0] - sl.host_ns          # device minus host clock
        for s, e in _gaps(ivals, lo, hi):
            idle[phase_of((s + e) // 2 - offset)] += e - s
        for n, s, e in work:
            ops[n] += e - s
        for name, k in kernels.items():
            mine = [l for l in sl.launches if l.kind == name]
            if not mine:
                continue
            main = [e - s for n, s, e in work if k.symbol(n)]
            aux = [e - s for n, s, e in work
                   if k.aux_symbol is not None and k.aux_symbol(n)]
            if (len(main) != len(mine)
                    or len(aux) != sum(l.aux for l in mine)):
                skipped[name] += 1
                continue
            k_dev[name] += (sum(main) + sum(aux)) * 1e-9
            for l in mine:
                c = l.cost()
                k_bound[name] += roofline.bound_s(c["bytes"], c["flops"])
    return Reading(
        busy_s=busy * 1e-9, window_s=window * 1e-9,
        kernels={k: {"bound_s": k_bound[k], "device_s": k_dev[k]}
                 for k in k_dev},
        skipped=dict(skipped),
        device_ops=[(n[:160], ns * 1e-9) for n, ns in ops.most_common(10)],
        idle_gaps=[(n, ns * 1e-9) for n, ns in idle.most_common(10)],
        slices=len(slices))


class Phases:
    """Host phase spans on the host clock (ns), innermost first: the
    program's own ``engine.prefill`` and ``engine.decode_step`` wall spans,
    and the loop's ``admit``, ``step``, ``observe`` and ``wait``."""

    NAMES = {"engine.prefill": "prefill", "engine.decode_step": "decode",
             "step": "sample", "admit": "admit", "observe": "harness",
             "wait": "wait"}
    ORDER = ("prefill", "decode", "sample", "admit", "harness", "wait")

    def __init__(self) -> None:
        self.spans: Dict[str, List[Tuple[int, int]]] = defaultdict(list)

    def add(self, name: str, t0_s: float, t1_s: float) -> None:
        label = self.NAMES.get(name)
        if label is not None:
            self.spans[label].append((int(t0_s * 1e9), int(t1_s * 1e9)))

    def finalize(self) -> None:
        for v in self.spans.values():
            v.sort()

    def phase_of(self, host_ns: int) -> str:
        import bisect
        for label in self.ORDER:
            sp = self.spans.get(label)
            if not sp:
                continue
            i = bisect.bisect_right(sp, (host_ns, 1 << 62)) - 1
            if i >= 0 and sp[i][0] <= host_ns < sp[i][1]:
                return label
        return "harness"
