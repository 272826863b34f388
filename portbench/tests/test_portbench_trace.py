"""The traced run's reduction, on hand-made device records: slice bounds
from the spinning kernels, busy time as the union of activities, a
kernel's share only over slices whose launches the profiler saw whole,
idle gaps named by the host phase at their middle; and the kernels that
the listed metrics declare, wrapped and noted from the call's arguments."""

import pytest
import torch

from portbench.harness import cell, roofline, trace
from portbench.tests import smoke

SPIN = "spin"
FLASH = "void repro_torch::wg::flash_wgmma_kernel<128>(...)"
PAGED = ("void repro_torch::mma::decode_mma_kernel<128, repro_torch::PagedKv,"
         " repro_torch::mma::DecodeBf16>(...)")
GEMM = "nvjet_tst_192x192"
ROW1, ROW2 = "flash_attention_roofline", "paged_decode_roofline"
KERNELS = cell.kernels_of([{"name": ROW1}, {"name": ROW2},
                           {"name": "prefill_mfu"}])


def _slice(host_ns, events, launches):
    sl = trace.Slice(host_ns=host_ns, launches=launches)
    sl.events = events
    return sl


def _flash():
    return trace.Launch(ROW1, lambda: roofline.flash_attention_cost(
        1, 128, 128, 8, 8, 128))


def _reduce(slices, ph):
    return trace.reduce(slices, frozenset({SPIN}), ph.phase_of, KERNELS)


def test_only_kernel_metrics_declare_kernels():
    assert sorted(KERNELS) == [ROW1, ROW2]
    every = [e["name"] for e in smoke.bench()["per_layer"]]
    assert sorted(cell.kernels_of([{"name": n} for n in every])) == [ROW1,
                                                                     ROW2]


def test_kernel_names():
    k1, k2 = KERNELS[ROW1], KERNELS[ROW2]
    assert k1.symbol(FLASH) and not k1.symbol(PAGED)
    assert k2.symbol(PAGED) and not k2.symbol(FLASH)
    assert not k2.symbol(PAGED.replace("DecodeBf16", "DecodeInt8"))
    assert k2.aux_symbol("x decode_combine_kernel y")
    assert not k1.symbol(GEMM) and not k2.symbol(GEMM)


def test_reduce_bounds_busy_shares_and_gaps():
    # device clock = host clock + 1000 ns; spins at 1000-1100 and 9000-9100
    ev = [(SPIN, 1000, 1050), (SPIN, 1050, 1100),
          (GEMM, 2000, 4000), (FLASH, 3000, 5000),      # busy 2000-5000
          (FLASH, 7000, 8000),                           # busy 7000-8000
          (SPIN, 9000, 9100)]
    sl = _slice(0, ev, [_flash(), _flash()])
    ph = trace.Phases()
    ph.add("step", 0.0, 1e-5)                 # host 0-10000 ns: sample
    ph.add("engine.prefill", 5e-6, 6.5e-6)    # host 5000-6500 ns: prefill
    ph.finalize()
    r = _reduce([sl], ph)
    assert r.window_s == pytest.approx((9000 - 1100) * 1e-9)
    assert r.busy_s == pytest.approx((3000 + 1000) * 1e-9)
    k = r.kernels[ROW1]
    assert k["device_s"] == pytest.approx(3000e-9)
    c = roofline.flash_attention_cost(1, 128, 128, 8, 8, 128)
    assert k["bound_s"] == pytest.approx(2 * roofline.bound_s(c["bytes"],
                                                              c["flops"]))
    gaps = dict(r.idle_gaps)
    # gaps 1100-2000 (host 100-1000: sample), 5000-7000 (host 4000-6000,
    # middle 5000: prefill), 8000-9000 (host 7000-8000: sample)
    assert gaps["prefill"] == pytest.approx(2000e-9)
    assert gaps["sample"] == pytest.approx(1900e-9)


def test_slice_whose_launches_the_profiler_lost_is_left_out():
    ev = [(SPIN, 0, 10), (FLASH, 20, 30), (SPIN, 40, 50)]
    lost = _slice(0, ev, [_flash(), _flash()])      # host made 2, saw 1
    whole = _slice(0, ev, [_flash()])
    ph = trace.Phases()
    ph.finalize()
    r = _reduce([lost, whole], ph)
    assert r.skipped == {ROW1: 1}
    assert r.kernels[ROW1]["device_s"] == pytest.approx(10e-9)
    only_lost = _reduce([lost], ph)
    assert ROW1 not in only_lost.kernels


def test_merges_count_with_row2():
    ev = [(SPIN, 0, 10), (PAGED, 20, 30), ("decode_combine_kernel", 30, 34),
          (SPIN, 40, 50)]
    l2 = trace.Launch(ROW2, lambda: roofline.paged_decode_cost(
        [64], 4, 16, 8, 1, 128), aux=1)
    ph = trace.Phases()
    ph.finalize()
    r = _reduce([_slice(0, ev, [l2])], ph)
    assert r.kernels[ROW2]["device_s"] == pytest.approx(14e-9)
    unmerged = trace.Launch(ROW2, l2.cost, aux=0)     # a merge it never made
    r = _reduce([_slice(0, ev, [unmerged])], ph)
    assert r.skipped == {ROW2: 1}


def test_recorder_wraps_the_declared_entries_and_notes_shapes(monkeypatch):
    """The wrapped entries still return the real call's result, note one
    launch a call while a slice is open with the cost of its shapes, and
    are put back by ``uninstall``."""
    from repro_torch.kernels import ops
    calls = []

    def flash(q, k, v, *, causal=True, window=None):
        calls.append(q.shape)
        return q

    monkeypatch.setattr(ops, "flash_attention_cuda", flash)
    rec = trace.Recorder({ROW1: KERNELS[ROW1]})
    rec.install()
    try:
        q = torch.zeros(2, 64, 8, 128)
        kv = torch.zeros(2, 64, 2, 128)
        assert ops.flash_attention_cuda(q, kv, kv) is q    # no slice open
        rec.current = sl = trace.Slice(host_ns=0)
        ops.flash_attention_cuda(q, k=kv, v=kv, causal=False)
        rec.current = None
    finally:
        rec.uninstall()
    assert ops.flash_attention_cuda is flash and len(calls) == 2
    [l] = sl.launches
    assert l.kind == ROW1 and l.aux == 0
    assert l.cost() == roofline.flash_attention_cost(2, 64, 64, 8, 2, 128,
                                                     causal=False)
