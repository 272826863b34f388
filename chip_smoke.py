#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. print the card's name and power limit (``nvidia-smi``) and build the
   four CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, started together);
2. hold each kernel against its plain PyTorch version on the card at
   qwen3-8b widths (H=32, Hkv=8, D=128, page 16) and, for the prefill and
   contiguous decode kernels, at the speculative draft's (H=2, Hkv=1,
   D=64), in bfloat16 and float32 with TF32 off -- absolute tolerance 1e-4
   (float32: the card sums in another order) and 2e-2 (bfloat16) -- and
   time the kernel, the plain version and, as a yardstick the port never
   calls, one ``scaled_dot_product_attention`` on the same (for paged
   kernels: gathered) inputs with a length mask;
3. model consistency at full width: qwen3-8b, all 36 layers, float32.  A
   paged engine serves two requests, and the logits of every paged decode
   step must match a fresh prefill over the same tokens within 1e-3 *
   max|logit|; a slot engine and a speculative engine whose draft is the
   target itself (every draft accepted) serve the same requests, their
   slot-decode and verify logits (every one of the K positions) held to
   fresh prefills the same way, and all three engines' greedy tokens must
   be identical;
4. the main paths, through ``repro_torch.launch.serve.run`` -- the
   decentralized protocol assigns 8 requests and two nodes serve them with
   full-width qwen3-8b (36 layers, bfloat16, random weights seeded per
   node): [4] on paged engines, [4b] on slot engines (the driver's
   default), [4c] on speculative paged engines with the ``cfg.draft()``
   model, spec_k 4.  Every request must return tokens, and every kernel of
   the phase's path must have launched: the launch counts are zeroed just
   before each run and read just after it, and the shapes, tables and
   lengths the run hands each kernel are recorded.  Each phase reruns its
   scenario under ``torch.profiler`` for the device's busy share;
5. each kernel against its plain version again, at the shapes its serve
   phase gave it: the most frequent prefill shape, and the decode or verify
   step of median attended length with that step's own table and lengths.

Times (``ms``, ``plain_ms``, ``library_ms``) are device time per call from
``torch.profiler`` over repeated calls on the same inputs (warm L2) or,
where the profiler records no device activity three times running, from
CUDA events around calls queued behind a spinning kernel (``timed_by``);
``call_ms`` is the kernel wrapper's time per call from CUDA events around
back-to-back calls, which is the host's call rate where that is slower.

The line before the last is one JSON object ``{"kernels": [...]}`` with one
entry per kernel and head width built: its source, the TPU kernel it
replaces, the serve phase it was measured in, its launches there, and its
error and times at that phase's shapes (phase 5) beside the least time the
card could take (``bound_ms``: the larger of the bytes it must move over
3.35 TB/s and the operations it must do over the card's peak for their
type).  The last line is ``{"ok": true, "device": ...}``.  Without a CUDA
card, or outside a checkout of the repository, the script exits with an
error before printing any result.
"""

from __future__ import annotations

import collections
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core rate
              "float32": 67e12}           # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
H, HKV, D, PAGE = 32, 8, 128, 16          # qwen3-8b attention widths
TARGET, DRAFT = (H, HKV, D), (2, 1, 64)   # (H, Hkv, D); the draft: cfg.draft()
SPEC_K = 4

# the kernels line: one entry per kernel and head width built, each read in
# the serve phase whose path runs it
ENTRIES = {  # entry: (kernel in ops.KERNELS, head width, serve phase)
    "flash_attention": ("flash_attention", 128, "4"),
    "paged_decode": ("paged_decode", 128, "4"),
    "flash_decode": ("flash_decode", 128, "4b"),
    "flash_attention_d64": ("flash_attention", 64, "4c"),
    "flash_decode_d64": ("flash_decode", 64, "4c"),
    "paged_verify": ("paged_verify", 128, "4c"),
}
PHASE_MODE = {"4": "paged", "4b": "slot", "4c": "spec"}
# (kernel, head width) pairs each serve phase's path must launch
PATHS = {"4": {("flash_attention", 128), ("paged_decode", 128)},
         "4b": {("flash_attention", 128), ("flash_decode", 128)},
         "4c": {("flash_attention", 128), ("flash_attention", 64),
                ("flash_decode", 64), ("paged_verify", 128)}}


def log(*a) -> None:
    print(*a, flush=True)


def call_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean milliseconds per call from CUDA events around ``iters``
    back-to-back calls: the device time or the host's call rate, whichever
    is slower."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def queued_ms(fn, iters: int) -> float:
    """Mean milliseconds per call from CUDA events around ``iters`` calls
    queued behind a kernel that spins the device for ~0.1 s, so that the
    host has queued them all before the first one starts: device time,
    gaps between back-to-back kernels included."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)        # clock cycles
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def device_ms(fn, iters: int, attempts: int = 3) -> tuple[float, str]:
    """Mean device milliseconds per call and how they were timed: the
    summed duration of the device activity ``torch.profiler`` records over
    ``iters`` calls.  The profiler now and then hands back a session
    without any device activity; such a session is run again, and after
    ``attempts`` empty ones the calls are timed by ``queued_ms``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.elapsed_us() for e in prof.events()
                 if e.device_type == DeviceType.CUDA)
        if us > 0:
            return us / iters / 1e3, "profiler"
    log(f"  the profiler recorded no device activity in {attempts} sessions:"
        f" timed by CUDA events behind a spinning kernel instead")
    return queued_ms(fn, iters), "cuda_events"


def timings(kernel, plain, library, iters: int) -> dict:
    slow = max(3, iters // 5)             # the plain version is slow
    out, timed_by = {}, {}
    for key, fn, n in (("ms", kernel, iters), ("plain_ms", plain, slow),
                       ("library_ms", library, iters)):
        out[key], timed_by[key] = device_ms(fn, n)
    return dict(out, call_ms=call_ms(kernel, iters), timed_by=timed_by)


def bound(nbytes: float, flops: float, dt: str) -> dict:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dt] * 1e3
    return dict(bytes=nbytes, flops=flops, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations")


def check(name, got, want, dt) -> float:
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not (torch.isfinite(got.float()).all() and err <= TOL[dt]):
        raise AssertionError(f"{name} {dt}: max_err {err} > {TOL[dt]}")
    return err


def _shown(lengths):
    return lengths if len(lengths) <= 8 else f"{len(lengths)}x{lengths[0]}"


# ------------------------------------------------------------ phases 2, 5
def prefill_case(name, b, s, dt, *, heads=TARGET, window=None, causal=True,
                 iters=50):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_ref
    h, hkv, d = heads
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(b * 1000 + s + d)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d)))
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = check(f"prefill {name}", got,
                flash_ref(q, k, v, causal=causal, window=window), dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    pos = torch.arange(s, device="cuda")
    mask = None
    if window is not None:
        mask = (pos[:, None] >= pos[None, :]) & (pos[:, None] - pos[None, :]
                                                 < window)
    t = timings(
        lambda: flash_attention_cuda(q, k, v, causal=causal, window=window),
        lambda: flash_ref(q, k, v, causal=causal, window=window),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), iters)
    qp = torch.arange(s)
    vis = torch.ones((s, s), dtype=torch.bool)
    if causal:
        vis &= qp[:, None] >= qp[None, :]
    if window is not None:
        vis &= qp[:, None] - qp[None, :] < window
    flops = 4.0 * b * h * d * int(vis.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(case=name, dtype=dt, shape=f"B={b} S={s} H={h} Hkv={hkv} "
                f"D={d}" + (f" window={window}" if window else "")
                + ("" if causal else " non-causal"),
                max_abs_err=err, tol=TOL[dt], **t, **bound(nbytes, flops, dt))


def decode_case(name, s, lengths, dt, *, heads=TARGET, window=None,
                iters=100):
    """The contiguous decode kernel on caches of ``s`` positions with
    per-row ``lengths``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_decode import flash_decode_cuda
    from repro_torch.kernels.ref import decode_ref
    h, hkv, d = heads
    b = len(lengths)
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(sum(lengths) + s + d)
    q = torch.randn((b, 1, h, d), generator=g, device="cuda").to(dtype)
    kc, vc = (torch.randn((b, s, hkv, d), generator=g,
                          device="cuda").to(dtype) for _ in range(2))
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    got = flash_decode_cuda(q, kc, vc, ln, window=window)
    torch.cuda.synchronize()
    err = check(f"decode {name}", got,
                decode_ref(q, kc, vc, ln, window=window), dt)
    pos = torch.arange(s, device="cuda")[None, :]
    valid = pos < ln[:, None]
    if window is not None:
        valid &= pos >= ln[:, None] - window
    mask = valid[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    t = timings(lambda: flash_decode_cuda(q, kc, vc, ln, window=window),
                lambda: decode_ref(q, kc, vc, ln, window=window),
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), iters)
    # what the function needs: a row's K and V over its visible positions
    # and QK + PV on them; a row that sees no key averages V over all S
    # positions and needs no K and no QK
    k_pos = v_pos = 0
    for n in lengths:
        lo = max(0, n - window) if window is not None else 0
        seen = max(0, min(n, s) - lo)
        k_pos += seen
        v_pos += seen if seen else s
    elem = q.element_size()
    nbytes = (2 * q.numel() + (k_pos + v_pos) * hkv * d) * elem + 4 * b
    flops = 2.0 * h * d * (k_pos + v_pos)
    return dict(case=name, dtype=dt, shape=f"B={b} S={s} "
                f"lengths={_shown(lengths)} H={h} Hkv={hkv} D={d}"
                + (f" window={window}" if window else ""),
                max_abs_err=err, tol=TOL[dt], **t, **bound(nbytes, flops, dt))


def fresh_tables(lengths, width=None):
    """A block table with distinct pages per row covering ``lengths``
    positions (cut at ``width`` columns if given); entries past a row's
    allocation point at the scratch page 0."""
    import numpy as np
    n_row = [-(-ln // PAGE) for ln in lengths]
    if width is not None:
        n_row = [min(n, width) for n in n_row]
    bt = np.zeros((len(lengths), width or max(2, max(n_row) + 1)), np.int32)
    free = list(range(1, 1 + sum(n_row)))
    for i, n in enumerate(n_row):
        for j in range(n):
            bt[i, j] = free.pop()
    return bt


def _pool(bt, lengths, kq, dt, seed):
    """q (B, kq, H, D) and random pools holding every page ``bt`` names."""
    import torch
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(seed)
    n_pool = int(bt.max()) + 1
    q = torch.randn((bt.shape[0], kq, H, D), generator=g,
                    device="cuda").to(dtype)
    kp, vp = (torch.randn((n_pool, PAGE, HKV, D), generator=g,
                          device="cuda").to(dtype) for _ in range(2))
    return (q, kp, vp, torch.from_numpy(bt).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def paged_case(name, bt, lengths, dt, *, iters=100):
    """The paged decode kernel on block table ``bt`` (numpy int32
    (B, maxp)) and ``lengths``, over a random pool holding every page the
    table names."""
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import paged_decode_cuda
    from repro_torch.kernels.ref import _gather_pages, paged_decode_ref
    import torch
    b, maxp = bt.shape
    q, kp, vp, btc, ln = _pool(bt, lengths, 1, dt, sum(lengths) + b)
    got = paged_decode_cuda(q, kp, vp, btc, ln)
    torch.cuda.synchronize()
    err = check(f"paged {name}", got, paged_decode_ref(q, kp, vp, btc, ln),
                dt)
    kg, vg = (_gather_pages(p, btc).transpose(1, 2).contiguous()
              for p in (kp, vp))
    mask = (torch.arange(maxp * PAGE, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()
    t = timings(lambda: paged_decode_cuda(q, kp, vp, btc, ln),
                lambda: paged_decode_ref(q, kp, vp, btc, ln),
                lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask, enable_gqa=True), iters)
    # what the function needs: a live row's K and V up to its length and
    # QK + PV on them; a length-0 row averages V over its whole table and
    # needs no K and no QK; each row's table entries for those positions
    cap = maxp * PAGE
    k_pos = sum(min(n, cap) for n in lengths if n > 0)
    v_pos = k_pos + cap * sum(1 for n in lengths if n <= 0)
    entries = sum(-(-(min(n, cap) if n > 0 else cap) // PAGE)
                  for n in lengths)
    elem = q.element_size()
    nbytes = ((2 * q.numel() + (k_pos + v_pos) * HKV * D) * elem
              + 4 * (entries + b))
    flops = 2.0 * H * D * (k_pos + v_pos)
    return dict(case=name, dtype=dt, shape=f"B={b} maxp={maxp} "
                f"lengths={_shown(lengths)} H={H} Hkv={HKV} D={D} "
                f"page={PAGE}", max_abs_err=err, tol=TOL[dt], **t,
                **bound(nbytes, flops, dt))


def verify_case(name, bt, lengths, kq, dt, *, iters=100):
    """The paged verify kernel: ``kq`` query tokens per row over block
    table ``bt`` with ``lengths`` valid positions before them."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_verify import paged_verify_cuda
    from repro_torch.kernels.ref import _gather_pages, paged_verify_ref
    b, maxp = bt.shape
    q, kp, vp, btc, ln = _pool(bt, lengths, kq, dt, sum(lengths) + kq)
    got = paged_verify_cuda(q, kp, vp, btc, ln)
    torch.cuda.synchronize()
    err = check(f"verify {name}", got, paged_verify_ref(q, kp, vp, btc, ln),
                dt)
    kg, vg = (_gather_pages(p, btc).transpose(1, 2).contiguous()
              for p in (kp, vp))
    cap = maxp * PAGE
    limit = ln[:, None] + torch.arange(kq, device="cuda")[None, :]
    mask = (torch.arange(cap, device="cuda")[None, None, :]
            <= limit[..., None])[:, None]                   # (B, 1, K, S)
    qt = q.transpose(1, 2).contiguous()
    t = timings(lambda: paged_verify_cuda(q, kp, vp, btc, ln),
                lambda: paged_verify_ref(q, kp, vp, btc, ln),
                lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask, enable_gqa=True), iters)
    # what the function needs: each row's K and V through its last query's
    # bound, its table entries for them, and QK + PV of every query over
    # the positions it sees
    read = [min(n + kq, cap) for n in lengths]
    seen = sum(min(n + j + 1, cap) for n in lengths for j in range(kq))
    elem = q.element_size()
    nbytes = ((2 * q.numel() + 2 * sum(read) * HKV * D) * elem
              + 4 * (sum(-(-r // PAGE) for r in read) + b))
    flops = 4.0 * H * D * seen
    return dict(case=name, dtype=dt, shape=f"B={b} K={kq} maxp={maxp} "
                f"lengths={_shown(lengths)} H={H} Hkv={HKV} D={D} "
                f"page={PAGE}", max_abs_err=err, tol=TOL[dt], **t,
                **bound(nbytes, flops, dt))


def verify_one_token_is_decode(dt) -> float:
    """K = 1 verify at ``lengths`` against the paged decode kernel at
    ``lengths + 1``: the same function, two kernels."""
    import torch
    from repro_torch.kernels.paged_decode import paged_decode_cuda
    from repro_torch.kernels.paged_verify import paged_verify_cuda
    lengths = [28, 1, 40, 0]
    q, kp, vp, btc, ln = _pool(fresh_tables([n + 1 for n in lengths]),
                               lengths, 1, dt, 11)
    got = paged_verify_cuda(q, kp, vp, btc, ln)
    want = paged_decode_cuda(q, kp, vp, btc, ln + 1)
    torch.cuda.synchronize()
    return check("verify K=1 vs paged decode", got, want, dt)


def show(name, r) -> None:
    log(f"  {name:19s} {r['case']:10s} {r['dtype']:8s} "
        f"max_err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} ms "
        f"(call {r['call_ms']:.4f}) plain {r['plain_ms']:.4f} ms sdpa "
        f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']})  [{r['shape']}]"
        + "".join(f" {k} by {v}" for k, v in r["timed_by"].items()
                  if v != "profiler"))


def phase_kernels():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = {name: [] for name in ENTRIES}
    for dt in ("bfloat16", "float32"):
        cases["flash_attention"] += [
            prefill_case("short", 4, 32, dt, iters=200),
            prefill_case("long", 1, 4096, dt, iters=10),
            prefill_case("window", 2, 512, dt, window=64),
            prefill_case("non-causal", 2, 256, dt, causal=False),
            prefill_case("s100", 2, 100, dt),
        ]
        cases["flash_attention_d64"] += [
            prefill_case("short", 4, 32, dt, heads=DRAFT, iters=200),
            prefill_case("long", 1, 4096, dt, heads=DRAFT, iters=10),
        ]
        rider = [0, 17, 40, 33]           # a length-0 row and page-0 pads
        cases["paged_decode"] += [
            paged_case("rider", fresh_tables(rider), rider, dt, iters=200),
            paged_case("long", fresh_tables([4096] * 32), [4096] * 32, dt,
                       iters=20),
        ]
        cases["flash_decode"] += [
            decode_case("rider", 64, [25, 1, 33, 0], dt, iters=200),
            decode_case("long", 4096, [4096] * 32, dt, iters=20),
            decode_case("window", 4096, [4096, 3000, 100, 0] * 2, dt,
                        window=1024, iters=20),
        ]
        cases["flash_decode_d64"] += [
            decode_case("rider", 72, [25, 1, 33, 0], dt, heads=DRAFT,
                        iters=200),
            decode_case("long", 4096, [4096] * 32, dt, heads=DRAFT,
                        iters=20),
        ]
        # a rider whose lengths + K passes its 2-page table
        past = [30, 31, 9, 0]
        cases["paged_verify"] += [
            verify_case("rider", fresh_tables(past, width=2), past,
                        SPEC_K + 1, dt, iters=200),
            verify_case("long", fresh_tables([4096 + SPEC_K + 1] * 32),
                        [4096] * 32, SPEC_K + 1, dt, iters=20),
        ]
        err = verify_one_token_is_decode(dt)
        log(f"  paged_verify K=1 {dt}: max_err {err:.2e} against paged "
            f"decode at lengths + 1")
    for name, rows in cases.items():
        for r in rows:
            show(name, r)
    log("kernel_cases " + json.dumps(cases))
    return cases


def _most_common_prefill(seen, d):
    shapes = collections.Counter(x for x in seen if x[0][3] == d)
    log(f"  prefill shapes at D={d} (q shape, causal, window: calls): "
        f"{ {str(k): v for k, v in shapes.items()} }")
    return shapes.most_common(1)[0][0]


def _median(steps, label):
    steps = sorted(steps, key=lambda st: int(st[-1].sum()))
    mid = steps[len(steps) // 2]
    log(f"  {len(steps)} {label} steps; the median step attends "
        f"{mid[-1].tolist()}")
    return mid


def _dense_pages(bt):
    """Renumber the pages a table names densely (0 stays the scratch page):
    the engine's pool numbers them up to its size."""
    import numpy as np
    ids = np.unique(np.concatenate([[0], bt.ravel()]))
    return np.searchsorted(ids, bt).astype(np.int32)


def phase_main_shapes(seen) -> dict:
    """Each kernel against its plain version at the shapes its serve phase
    gave it (bfloat16, the serve dtype)."""
    out = {}
    for entry, heads, phase in (("flash_attention", TARGET, "4"),
                                ("flash_attention_d64", DRAFT, "4c")):
        (b, s, h, d), causal, window = _most_common_prefill(
            seen[phase]["flash_attention"], heads[2])
        if (h, d) != (heads[0], heads[2]):
            raise AssertionError(f"{entry}: prefill heads {h} x {d}")
        out[entry] = prefill_case("main", b, s, "bfloat16", heads=heads,
                                  causal=causal, window=window, iters=200)
    bt, ln = _median(seen["4"]["paged_decode"], "paged decode (phase 4)")
    out["paged_decode"] = paged_case("main", _dense_pages(bt),
                                     [int(x) for x in ln], "bfloat16",
                                     iters=200)
    for entry, heads, phase in (("flash_decode", TARGET, "4b"),
                                ("flash_decode_d64", DRAFT, "4c")):
        steps = [st for st in seen[phase]["flash_decode"]
                 if st[0] == heads[2]]
        _, s, ln = _median(steps, f"D={heads[2]} decode (phase {phase})")
        out[entry] = decode_case("main", s, [int(x) for x in ln],
                                 "bfloat16", heads=heads, iters=200)
    kq, bt, ln = _median(seen["4c"]["paged_verify"], "verify (phase 4c)")
    out["paged_verify"] = verify_case("main", _dense_pages(bt),
                                      [int(x) for x in ln], kq, "bfloat16",
                                      iters=200)
    for entry, r in out.items():
        show(entry, r)
    log("main_cases " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 3
def phase_consistency(n_layers: int):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import dense
    from repro_torch.serving import Engine, GenRequest
    from repro_torch.serving.sampling import masked_logits
    cfg = get_config("qwen3-8b").replace(dtype="float32", n_layers=n_layers)
    t0 = time.perf_counter()
    params = dense.init(cfg, torch.Generator("cuda").manual_seed(7), "cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"  {cfg.name} x{cfg.n_layers} layers fp32: {gb:.1f} GB of weights "
        f"in {time.perf_counter() - t0:.1f}s")
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).numpy()
               .astype("int32") for n in (24, 11)]
    fresh_cache = {}

    def fresh(tokens):
        key = tuple(tokens)
        if key not in fresh_cache:
            logits = dense.prefill(params, cfg, torch.tensor(
                [list(key)], device="cuda"))[0][0, 0].float().cpu()
            fresh_cache[key] = logits
        return fresh_cache[key]

    worst = {}

    def held(kind, got, tokens, what):
        want = fresh(tokens)
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        worst[kind] = max(worst.get(kind, 0.0), diff / scale)
        if diff > 1e-3 * scale:
            raise AssertionError(f"{what}: |{kind} - prefill| {diff:.3e} > "
                                 f"1e-3 * {scale:.3e}")

    def serve(**kw):
        eng = Engine(cfg, params, max_batch=4, bucket=32, **kw)
        reqs = [GenRequest(rid=f"c{i}", max_new=8, tokens=p)
                for i, p in enumerate(prompts)]
        steps = []
        attr = ("_verify" if "spec_draft" in kw else
                "_decode_paged" if kw.get("paged") else "_decode")
        fwd = getattr(eng, attr)

        def recording(p, c, cache, tok):
            # rows with a sampled token are the step's live rows; their
            # fed history is the prompt plus what they emitted before it
            live = {i: [int(t) for t in s.req.tokens] + s.out[:-1]
                    for i, s in enumerate(eng._slots)
                    if s is not None and s.out}
            logits, cache = fwd(p, c, cache, tok)
            steps.append((live, tok.cpu().tolist(), logits.float().cpu()))
            return logits, cache

        setattr(eng, attr, recording)
        eng.serve(reqs)
        return reqs, steps

    results = {}
    for mode, kw in (("paged", dict(paged=True)), ("slot", {}),
                     ("spec", dict(paged=True, spec_draft=(cfg, params),
                                   spec_k=SPEC_K))):
        reqs, steps = serve(**kw)
        results[mode] = [r.result.tolist() for r in reqs]
        for live, toks, logits in steps:
            for i, hist in live.items():
                for j in range(len(toks[i])):
                    held(mode, logits[i, j], hist + toks[i][: j + 1],
                         f"{mode} row {i} position {j}")
        # each emitted token is the greedy choice of a fresh prefill
        for r in reqs:
            toks = [int(t) for t in r.tokens] + [int(t) for t in r.result]
            for t in range(len(r.result)):
                want = int(torch.argmax(masked_logits(
                    fresh(toks[: len(r.tokens) + t]), cfg.vocab_size)))
                if want != int(r.result[t]):
                    raise AssertionError(f"{mode} {r.rid} token {t}: "
                                         f"{r.result[t]} != prefill {want}")
        log(f"  {mode}: {sum(len(t) for t in results[mode])} tokens; "
            f"{len(steps)} {'verify' if mode == 'spec' else 'decode'} steps "
            f"held to fresh prefills: worst |diff| / max|logit| = "
            f"{worst[mode]:.2e} (limit 1e-3)")
    if not results["paged"] == results["slot"] == results["spec"]:
        raise AssertionError(f"greedy streams differ: {results}")
    log("  paged, slot and agreeing-spec greedy tokens identical")
    del params, fresh_cache
    torch.cuda.empty_cache()
    return {"worst_rel_diff": worst}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phase 4
def recording_ops(ops, seen, widths):
    """Wrap the attention entry points the model calls so that each call
    also notes what it was given: the prefill's (q shape, causal, window);
    once per decode or verify step (one lengths tensor serves all layers) a
    host copy of its shapes, table and lengths; and every call's head width
    in ``widths``.  Returns a function that puts the originals back."""
    names = ("attention", "paged_decode", "decode", "paged_verify")
    orig = {n: getattr(ops, n) for n in names}
    last = [None]

    def step(key, lengths, *record):
        if lengths is not last[0]:
            last[0] = lengths
            seen[key].append(tuple(record) + (lengths.cpu().numpy(),))

    def att(q, k, v, *, causal=True, window=None):
        widths["flash_attention", q.shape[3]] += 1
        seen["flash_attention"].append((tuple(q.shape), causal, window))
        return orig["attention"](q, k, v, causal=causal, window=window)

    def paged(q, k_pool, v_pool, block_tables, lengths):
        widths["paged_decode", q.shape[3]] += 1
        step("paged_decode", lengths, block_tables.cpu().numpy())
        return orig["paged_decode"](q, k_pool, v_pool, block_tables, lengths)

    def decode(q, k_cache, v_cache, lengths, *, window=None):
        widths["flash_decode", q.shape[3]] += 1
        step("flash_decode", lengths, q.shape[3], k_cache.shape[1])
        return orig["decode"](q, k_cache, v_cache, lengths, window=window)

    def verify(q, k_pool, v_pool, block_tables, lengths):
        widths["paged_verify", q.shape[3]] += 1
        step("paged_verify", lengths, q.shape[1], block_tables.cpu().numpy())
        return orig["paged_verify"](q, k_pool, v_pool, block_tables, lengths)

    ops.attention, ops.paged_decode, ops.decode, ops.paged_verify = (
        att, paged, decode, verify)

    def restore():
        for n in names:
            setattr(ops, n, orig[n])
    return restore


def phase_serve(phase, params, first=None):
    """Serve the scenario on ``PHASE_MODE[phase]`` engines; check every
    request's tokens and that every kernel entry of the phase launched;
    print step times and rerun under the profiler."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    mode = PHASE_MODE[phase]
    cfg = get_config("qwen3-8b").replace(dtype="bfloat16")
    dev = torch.device("cuda")
    kw = dict(nodes=2, requests=8, max_new=8, seed=0, device=dev, mode=mode,
              spec_k=SPEC_K, params_fn=lambda i, c, d: params[i])
    seen = {k: [] for k in ("flash_attention", "paged_decode",
                            "flash_decode", "paged_verify")}
    widths = collections.Counter()
    restore = recording_ops(ops, seen, widths)
    try:
        ops.reset_launch_counts()
        out = serve.run(cfg, **kw)
        launches = ops.launch_counts()
    finally:
        restore()
    log(f"  launches on the {mode} path: {launches}; by (kernel, head "
        f"width): {dict(widths)}")
    for kernel, n in launches.items():
        if n != sum(c for (k, _), c in widths.items() if k == kernel):
            raise AssertionError(f"{kernel}: {n} launches but "
                                 f"{dict(widths)} calls")
    missing = sorted(f"{k}@{d}" for k, d in PATHS[phase] if widths[k, d] < 1)
    if missing:
        raise AssertionError(f"kernels of the {mode} path never launched: "
                             f"{missing}")
    mine = {e: widths[k, d] for e, (k, d, p) in ENTRIES.items()
            if p == phase}
    if set(out["results"]) != {f"r{i}" for i in range(8)}:
        raise AssertionError(f"requests without a result: {out['results']}")
    for rid, toks in out["results"].items():
        if not (1 <= len(toks) <= 8 and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    log(f"  serve: {out['tokens']} tokens in {out['wall_s']:.3f}s "
        f"({out['tok_per_s']:.1f} tok/s), assignment "
        f"{ {k: len(v) for k, v in out['assigned'].items()} }, balances "
        f"{out['balances']}")
    # where the time goes: each decode step streams every weight once, so
    # its floor is the weights' bytes over the memory rate
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params[0]))
    floor_ms = wbytes / HBM_BYTES_PER_S * 1e3
    steps = {}
    for nid, st in out["stats"].items():
        steps[nid] = dict(
            prefill_ms=st.prefill_wall_s / max(1, st.batches) * 1e3,
            prefill_batches=st.batches,
            decode_ms=st.decode_wall_s / max(1, st.decode_steps) * 1e3,
            decode_steps=st.decode_steps, decode_tokens=st.decode_tokens)
        line = (f"  {nid}: {st.batches} prefills at "
                f"{steps[nid]['prefill_ms']:.2f} ms, {st.decode_steps} "
                f"{'verify' if mode == 'spec' else 'decode'} steps at "
                f"{steps[nid]['decode_ms']:.2f} ms (weight-streaming floor "
                f"{floor_ms:.2f} ms)")
        if mode == "spec":
            steps[nid].update(
                spec_steps=st.spec_steps, spec_drafted=st.spec_drafted,
                spec_accepted=st.spec_accepted,
                draft_ms_per_step=st.draft_wall_s / max(1, st.spec_steps)
                * 1e3,
                verify_ms_per_step=st.verify_wall_s / max(1, st.spec_steps)
                * 1e3,
                expected_tokens_per_step=out["expected_tokens_per_step"][nid])
            line += (f"; accepted {st.spec_accepted}/{st.spec_drafted} "
                     f"drafts over {st.spec_steps} verifies, draft "
                     f"{steps[nid]['draft_ms_per_step']:.2f} ms and verify "
                     f"{steps[nid]['verify_ms_per_step']:.2f} ms per step")
        log(line)
    extra = {}
    if first is not None:
        same = sum(int(a == b) for rid, t in first["results"].items()
                   for a, b in zip(t.tolist(),
                                   out["results"][rid].tolist()))
        total = sum(len(t) for t in first["results"].values())
        extra["share_equal_to_paged"] = same / total
        log(f"  tokens equal to phase 4's, position by position: {same} of "
            f"{total} (bf16: verify and decode GEMMs may round differently; "
            f"exact equality is held in fp32 in phase 3)")
    profile = profile_serve(serve, cfg, kw, out)
    log(f"serve_profile_{phase} " + json.dumps(dict(
        mode=mode, steps=steps, weights_gb=wbytes / 1e9,
        step_floor_ms=floor_ms, tok_per_s=out["tok_per_s"],
        wall_s=out["wall_s"], launches=launches,
        launches_by_width={f"{k}@{d}": n for (k, d), n in widths.items()},
        **extra, **profile)))
    return out, mine, seen


def profile_serve(serve, cfg, kw, first) -> dict:
    """Run the same scenario again under ``torch.profiler`` and return the
    device's busy time over the replay and the kernels that take it."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        again = serve.run(cfg, verbose=False, **kw)
    same = all((again["results"][r] == t).all() if len(t) == len(
        again["results"][r]) else False for r, t in first["results"].items())
    kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kern:
        log("  profiler saw no device activity: busy share not measured")
        return dict(busy_share=None, same_tokens=same)
    by_name = {}
    for e in kern:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = again["wall_s"] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profiled rerun (same tokens: {same}): device busy {busy_ms:.1f} "
        f"ms of {wall_ms:.1f} ms replay wall ({busy_ms / wall_ms:.1%}), "
        f"{len(kern)} kernel launches")
    for name, us in top:
        log(f"    {us / 1e3:9.2f} ms  {name[:90]}")
    return dict(busy_ms=busy_ms, profiled_wall_ms=wall_ms,
                busy_share=busy_ms / wall_ms, kernel_launches=len(kern),
                top_kernels_ms={n[:90]: us / 1e3 for n, us in top},
                same_tokens=same)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card -- nothing to measure")
    from repro_torch.kernels import _build, ops   # needs the checkout's src/
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    _build.build(force=True)
    build_s = time.perf_counter() - t_all
    log(f"[1] built {list(_build.SOURCES)} in {build_s:.1f}s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    log("[2] kernels vs their plain versions")
    phase_kernels()
    log("[3] model consistency: paged, slot and verify logits vs fresh "
        "prefills")
    phase_consistency(n_layers=36)
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("qwen3-8b").replace(dtype="bfloat16")
    params = [serve.seeded_params(i, cfg, torch.device("cuda"))
              for i in range(2)]
    seen, launches = {}, {}
    log("[4] serve on paged engines")
    paged_out, launches["4"], seen["4"] = phase_serve("4", params)
    log("[4b] serve on slot engines (the driver's default)")
    _, launches["4b"], seen["4b"] = phase_serve("4b", params)
    log("[4c] serve on speculative paged engines, draft cfg.draft()")
    _, launches["4c"], seen["4c"] = phase_serve("4c", params,
                                                first=paged_out)
    del params
    torch.cuda.empty_cache()
    log("[5] kernels vs their plain versions at the serve phases' shapes")
    main_cases = phase_main_shapes(seen)
    kernels = []
    for entry, (kernel, d, phase) in ENTRIES.items():
        meta, r = ops.KERNELS[kernel], main_cases[entry]
        kernels.append(dict(
            name=entry, route="cuda", source=meta["source"],
            replaces=meta["replaces"], head_dim=d, phase=phase,
            launches=launches[phase][entry], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            call_ms=r["call_ms"], timed_by=r["timed_by"], shape=r["shape"],
            dtype=r["dtype"]))
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
