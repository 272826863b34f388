"""``tools/inside.py``: the readings from the engines' counters (none
where the program lacks a counter), the idle gaps named by the innermost
of the step's spans, the slices' clock offsets with and without leading
spins, and a whole untraced run on the CPU at smoke size."""

import pytest
import torch

from portbench.harness import cell, serve, trace
from portbench.tests import smoke
from portbench.tools import inside

SPIN = "spin"
SEED = 2**31 + 77


def test_readings_from_the_counters():
    delta = {"decode_wall_s": 2.0, "decode_launch_s": 1.5,
             "decode_steps": 100.0, "queue_wait_s": 3.0, "admitted": 60.0}
    r = inside.readings(delta)
    assert r["decode_ms_a_step"] == pytest.approx(20.0)
    assert r["decode_launch_ms_a_step"] == pytest.approx(15.0)
    assert r["decode_launch_share"] == pytest.approx(75.0)
    assert r["queue_wait_ms"] == pytest.approx(50.0)


def test_readings_are_none_without_counter_or_denominator():
    parent = {"decode_wall_s": 2.0, "decode_steps": 100.0}  # no new fields
    r = inside.readings(parent)
    assert r["decode_launch_share"] is None and r["queue_wait_ms"] is None
    assert r["decode_ms_a_step"] == pytest.approx(20.0)
    idle = {"decode_wall_s": 0.0, "decode_launch_s": 0.0,
            "decode_steps": 0.0, "queue_wait_s": 0.0, "admitted": 0.0}
    assert set(inside.readings(idle).values()) == {None}


def test_step_phases_name_the_innermost_span():
    ph = inside.StepPhases()
    ph.add("step", 0.0, 10.0)                      # the harness's step
    ph.add("engine.sample", 0.0, 1.0)
    ph.add("engine.admit", 1.0, 4.0)
    ph.add("engine.prefill", 2.0, 3.0)
    ph.add("engine.pages", 4.0, 4.5)
    ph.add("engine.decode_step", 5.0, 9.0)
    ph.add("engine.decode.inputs", 5.0, 5.5)
    ph.add("engine.decode.launch", 5.5, 8.0)
    ph.add("engine.decode.wait", 8.0, 9.0)
    ph.add("admit", 10.0, 11.0)
    ph.finalize()
    at = {0.5: "sample", 1.5: "admission", 2.5: "prefill", 4.2: "pages",
          4.7: "step", 5.2: "decode.inputs", 6.0: "decode.launch",
          8.5: "decode.wait", 9.5: "step", 10.5: "admit", 12.0: "harness"}
    for t, label in at.items():
        assert ph.phase_of(int(t * 1e9)) == label, t
    # the benchmark's own phases keep their labels, its step aside
    plain = trace.Phases()
    plain.add("step", 0.0, 10.0)
    plain.finalize()
    assert plain.phase_of(int(4.7e9)) == "sample"


def _slice(host_ns, close_ns, events, open_launch=0):
    """A slice whose edges' first spins were launched at ``host_ns`` and
    ``close_ns``, the one at the open returning ``open_launch`` ns
    later."""
    sl = trace.Slice(host_ns=host_ns)
    sl.open_ns = (host_ns, host_ns + open_launch)
    sl.close_ns = (close_ns, close_ns)
    sl.events = events
    return sl


def test_offset_from_trailing_spins_where_no_leading_one_survived():
    """Device clock = host clock + 1000 ns.  The slice opened at host 0
    and closed at host 9000; its leading spins were lost.  The gap at
    device 4000-6000 (host 3000-5000) falls inside the host's prefill."""
    ev = [("gemm", 2000, 4000), ("gemm", 6000, 8000),
          (SPIN, 10000, 10050), (SPIN, 10050, 10100)]
    sl = _slice(0, 9000, ev)
    assert inside.offsets(sl, frozenset({SPIN})) == (None, 1000)
    ph = trace.Phases()
    ph.add("engine.prefill", 3e-6, 5e-6)
    ph.finalize()
    # taken from the earliest surviving spin, a trailing one, the offset
    # is one slice length too large: both gaps land before the slice
    before = trace.reduce([sl], frozenset({SPIN}), ph.phase_of, {})
    assert dict(before.idle_gaps) == {"harness": pytest.approx(4000e-9)}
    clock = inside.aligned([sl], frozenset({SPIN}))
    assert clock["from_trailing"] == 1 and clock["neither"] == 0
    after = trace.reduce([sl], frozenset({SPIN}), ph.phase_of, {})
    assert dict(after.idle_gaps) == {"prefill": pytest.approx(2000e-9),
                                     "harness": pytest.approx(2000e-9)}
    assert after.busy_s == before.busy_s


def test_leading_spin_sets_the_offset_and_the_two_are_compared():
    """The first leading spin's launch returned 400 ns after the host's
    stamp: the offset is taken against its return."""
    ev = [(SPIN, 1400, 1450), ("gemm", 2000, 4000), (SPIN, 10030, 10080)]
    sl = _slice(0, 9000, ev, open_launch=400)
    assert inside.offsets(sl, frozenset({SPIN})) == (1000, 1030)
    clock = inside.aligned([sl], frozenset({SPIN}))
    assert clock == {"slices": 1, "from_trailing": 0, "neither": 0,
                     "widest_disagreement_ns": 30,
                     "longest_first_launch_ns": {"open": 400, "close": 0},
                     "offsets_ns": [[1000, 1030]]}
    assert sl.host_ns == 400


def test_watched_puts_the_harness_back():
    real = (trace.Phases, trace.Slicer, trace.reduce, trace._spins,
            serve.counters)
    with inside.watched():
        assert trace.Phases is inside.StepPhases
        assert issubclass(trace.Slicer, real[1]) and trace.Slicer is not \
            real[1]
    assert (trace.Phases, trace.Slicer, trace.reduce, trace._spins,
            serve.counters) == real


def test_untraced_run_on_the_cpu_reads_the_new_counters():
    spec = cell.spec_of(smoke.bench(), "cmdr-chat")
    row = inside.one(spec, SEED, 1.5, False, torch.device("cpu"),
                     dtype="float32",
                     cfg=smoke.config("command-r-plus-104b-l8"),
                     mix=smoke.mix("chat"))
    assert row["correct"]
    r = row["readings"]
    assert 0 < r["decode_launch_share"] <= 100
    assert 0 < r["decode_launch_ms_a_step"] <= r["decode_ms_a_step"]
    assert r["queue_wait_ms"] >= 0
    assert row["breakdown"] is None and row["clock"] is None
