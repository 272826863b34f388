#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. print the card's name and power limit (``nvidia-smi``) and build both
   CUDA kernels from ``src/repro_torch/kernels/csrc`` (one ``nvcc`` each,
   started together);
2. hold each kernel against its plain PyTorch version on the card at
   qwen3-8b widths (H=32, Hkv=8, D=128, page 16) in bfloat16 and float32
   with TF32 off -- absolute tolerance 1e-4 (float32: the card sums in
   another order) and 2e-2 (bfloat16) -- and time the kernel, the plain
   version and, as a yardstick the port never calls, one
   ``scaled_dot_product_attention`` on the same (gathered) inputs;
3. model consistency at full width: qwen3-8b, all 36 layers, float32, one
   paged engine serving two requests; the logits of every paged decode
   step must match a fresh prefill over the same tokens within
   1e-3 * max|logit|, and the greedy tokens must be identical;
4. the main path: ``repro_torch.launch.serve.run`` -- the decentralized
   protocol assigns 8 requests, two nodes serve them on paged engines with
   full-width qwen3-8b (36 layers, bfloat16, random weights seeded per
   node); every request must return tokens and both kernels must have
   launched.  The launch counts are zeroed just before this run and read
   just after it, and the shapes, block tables and lengths the run hands
   each kernel are recorded;
5. each kernel against its plain version again, at the shapes the main
   path gave it: the most frequent prefill shape, and the decode step of
   median attended length with that step's own block table and lengths.

Times (``ms``, ``plain_ms``, ``library_ms``) are device time per call from
``torch.profiler`` over repeated calls on the same inputs (warm L2);
``call_ms`` is the kernel wrapper's time per call from CUDA events around
back-to-back calls, which is the host's call rate where that is slower.

The line before the last is one JSON object ``{"kernels": [...]}`` with,
per kernel: its source, the TPU kernel it replaces, its launches on the
main path, and its error and times at the main path's shapes (phase 5)
beside the least time the card could take (``bound_ms``: the larger of
the bytes it must move over 3.35 TB/s and the operations it must do over
the card's peak for their type).  The last line is
``{"ok": true, "device": ...}``.  Without a CUDA card, or outside a
checkout of the repository, the script exits with an error before
printing any result.
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


def device_ms(fn, iters: int) -> float:
    """Mean device milliseconds per call: the summed duration of the device
    activity ``torch.profiler`` records over ``iters`` calls."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError("the profiler recorded no device activity")
    return us / iters / 1e3


def timings(kernel, plain, library, iters: int) -> dict:
    slow = max(3, iters // 5)             # the plain version is slow
    return dict(ms=device_ms(kernel, iters), call_ms=call_ms(kernel, iters),
                plain_ms=device_ms(plain, slow),
                library_ms=device_ms(library, iters))


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


# ------------------------------------------------------------ phases 2, 5
def prefill_case(name, b, s, dt, *, window=None, causal=True, iters=50):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_ref
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(b * 1000 + s)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, s, H, D), (b, s, HKV, D), (b, s, HKV, D)))
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
    flops = 4.0 * b * H * D * int(vis.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(case=name, dtype=dt, shape=f"B={b} S={s} H={H} Hkv={HKV} "
                f"D={D}" + (f" window={window}" if window else "")
                + ("" if causal else " non-causal"),
                max_abs_err=err, tol=TOL[dt], **t, **bound(nbytes, flops, dt))


def fresh_tables(lengths):
    """A block table with distinct pages per row; entries past a row's
    allocation point at the scratch page 0."""
    import numpy as np
    n_row = [-(-ln // PAGE) for ln in lengths]
    bt = np.zeros((len(lengths), max(2, max(n_row) + 1)), np.int32)
    free = list(range(1, 1 + sum(n_row)))
    for i, n in enumerate(n_row):
        for j in range(n):
            bt[i, j] = free.pop()
    return bt


def paged_case(name, bt, lengths, dt, *, iters=100):
    """The paged kernel on block table ``bt`` (numpy int32 (B, maxp)) and
    ``lengths``, over a random pool holding every page the table names."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.paged_decode import paged_decode_cuda
    from repro_torch.kernels.ref import _gather_pages, paged_decode_ref
    dtype = getattr(torch, dt)
    b, maxp = bt.shape
    n_pool = int(bt.max()) + 1
    g = torch.Generator("cuda").manual_seed(sum(lengths) + b)
    q = torch.randn((b, 1, H, D), generator=g, device="cuda").to(dtype)
    kp, vp = (torch.randn((n_pool, PAGE, HKV, D), generator=g,
                          device="cuda").to(dtype) for _ in range(2))
    btc = torch.from_numpy(bt).cuda()
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
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
    shown = lengths if b <= 8 else f"{b}x{lengths[0]}"
    return dict(case=name, dtype=dt, shape=f"B={b} maxp={maxp} "
                f"lengths={shown} H={H} Hkv={HKV} D={D} page={PAGE}",
                max_abs_err=err, tol=TOL[dt], **t,
                **bound(nbytes, flops, dt))


def show(name, r) -> None:
    log(f"  {name:15s} {r['case']:10s} {r['dtype']:8s} "
        f"max_err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} ms "
        f"(call {r['call_ms']:.4f}) plain {r['plain_ms']:.4f} ms sdpa "
        f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.4f} ms "
        f"({r['bound_by']})  [{r['shape']}]")


def phase_kernels():
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cases = {"flash_attention": [], "paged_decode": []}
    for dt in ("bfloat16", "float32"):
        cases["flash_attention"] += [
            prefill_case("short", 4, 32, dt, iters=200),
            prefill_case("long", 1, 4096, dt, iters=10),
            prefill_case("window", 2, 512, dt, window=64),
            prefill_case("non-causal", 2, 256, dt, causal=False),
            prefill_case("s100", 2, 100, dt),
        ]
        rider = [0, 17, 40, 33]           # a length-0 row and page-0 pads
        cases["paged_decode"] += [
            paged_case("rider", fresh_tables(rider), rider, dt, iters=200),
            paged_case("long", fresh_tables([4096] * 32), [4096] * 32, dt,
                       iters=20),
        ]
    for name, rows in cases.items():
        for r in rows:
            show(name, r)
    log("kernel_cases " + json.dumps(cases))
    return cases


def phase_main_shapes(seen) -> dict:
    """Each kernel against its plain version at the shapes the main path
    gave it (bfloat16, the serve dtype)."""
    import numpy as np
    shapes = collections.Counter(seen["flash_attention"])
    (q_shape, causal, window), n = shapes.most_common(1)[0]
    log(f"  prefill shapes on the main path (q shape, causal, window: "
        f"calls): { {str(k): v for k, v in shapes.items()} }")
    b, s, h, d = q_shape
    if (h, d) != (H, D):
        raise AssertionError(f"main path prefill q {q_shape}: not qwen3-8b")
    pre = prefill_case("main", b, s, "bfloat16", causal=causal,
                       window=window, iters=200)
    steps = sorted(seen["paged_decode"], key=lambda st: int(st[1].sum()))
    bt, lengths = steps[len(steps) // 2]
    log(f"  {len(steps)} decode steps on the main path; attended lengths "
        f"per step {[st[1].tolist() for st in steps]}; the median step "
        f"has {lengths.tolist()} over a {bt.shape[1]}-page table")
    # the engine's pool numbers pages up to its size: renumber the ones
    # this table names densely (0 stays the scratch page)
    ids = np.unique(np.concatenate([[0], bt.ravel()]))
    dense_bt = np.searchsorted(ids, bt).astype(np.int32)
    pd = paged_case("main", dense_bt, [int(x) for x in lengths], "bfloat16",
                    iters=200)
    show("flash_attention", pre)
    show("paged_decode", pd)
    log("main_cases " + json.dumps({"flash_attention": pre,
                                    "paged_decode": pd}))
    return {"flash_attention": pre, "paged_decode": pd}


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
    eng = Engine(cfg, params, max_batch=4, bucket=32, paged=True)
    rng = torch.Generator().manual_seed(0)
    reqs = [GenRequest(rid=f"c{i}", max_new=8, tokens=torch.randint(
        2, cfg.vocab_size, (n,), generator=rng).numpy().astype("int32"))
        for i, n in enumerate((24, 11))]
    # record the logits of every batched paged decode step the engine takes
    step_logits = []
    decode = eng._decode_paged

    def recording(p, c, cache, tok):
        logits, cache = decode(p, c, cache, tok)
        step_logits.append(logits[:, 0].float().cpu())
        return logits, cache

    eng._decode_paged = recording
    eng.serve(reqs)
    # both requests are admitted together, into rows 0 and 1; decode step
    # k feeds token k of every live row and yields the logits of token k+1
    worst, n_checked = 0.0, 0
    for row, r in enumerate(reqs):
        toks = [int(t) for t in r.tokens] + [int(t) for t in r.result]
        for t in range(len(r.result)):
            prefix = torch.tensor([toks[: len(r.tokens) + t]], device="cuda")
            fresh = dense.prefill(params, cfg, prefix)[0][0, 0].float().cpu()
            want = int(torch.argmax(masked_logits(fresh, cfg.vocab_size)))
            if want != int(r.result[t]):
                raise AssertionError(f"{r.rid} token {t}: engine "
                                     f"{r.result[t]} != prefill {want}")
            if t == 0:
                continue                   # token 0 comes from the prefill
            diff = float((step_logits[t - 1][row] - fresh).abs().max())
            scale = float(fresh.abs().max())
            worst = max(worst, diff / scale)
            n_checked += 1
            if diff > 1e-3 * scale:
                raise AssertionError(f"{r.rid} step {t}: |paged - prefill| "
                                     f"{diff:.3e} > 1e-3 * {scale:.3e}")
    log(f"  {n_checked} paged decode steps match fresh prefills: worst "
        f"|diff| / max|logit| = {worst:.2e} (limit 1e-3); greedy tokens "
        f"identical")
    del params, eng
    torch.cuda.empty_cache()
    return {"steps_checked": n_checked, "worst_rel_diff": worst}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phase 4
def recording_ops(ops, seen):
    """Wrap ``ops.attention`` / ``ops.paged_decode`` (the calls the model
    makes) so that each call also notes what it was given: the prefill's
    (q shape, causal, window), and once per decode step (one lengths tensor
    serves all layers) a device copy of its block table and lengths.
    Returns a function that puts the originals back."""
    attention, paged_decode = ops.attention, ops.paged_decode
    last = [None]

    def att(q, k, v, *, causal=True, window=None):
        seen["flash_attention"].append((tuple(q.shape), causal, window))
        return attention(q, k, v, causal=causal, window=window)

    def paged(q, k_pool, v_pool, block_tables, lengths):
        if lengths is not last[0]:
            last[0] = lengths
            seen["paged_decode"].append((block_tables.clone(),
                                         lengths.clone()))
        return paged_decode(q, k_pool, v_pool, block_tables, lengths)

    ops.attention, ops.paged_decode = att, paged

    def restore():
        ops.attention, ops.paged_decode = attention, paged_decode
    return restore


def phase_serve():
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    cfg = get_config("qwen3-8b").replace(dtype="bfloat16")
    dev = torch.device("cuda")
    params = [serve.seeded_params(i, cfg, dev) for i in range(2)]
    kw = dict(nodes=2, requests=8, max_new=8, seed=0, device=dev,
              params_fn=lambda i, c, d: params[i])
    seen = {"flash_attention": [], "paged_decode": []}
    restore = recording_ops(ops, seen)
    try:
        ops.reset_launch_counts()
        out = serve.run(cfg, **kw)
        launches = ops.launch_counts()
    finally:
        restore()
    seen["paged_decode"] = [(bt.cpu().numpy(), ln.cpu().numpy())
                            for bt, ln in seen["paged_decode"]]
    log(f"  launches on the main path: {launches}")
    if set(out["results"]) != {f"r{i}" for i in range(8)}:
        raise AssertionError(f"requests without a result: {out['results']}")
    for rid, toks in out["results"].items():
        if not (1 <= len(toks) <= 8 and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel never launched: {launches}")
    log(f"  serve: {out['tokens']} tokens in {out['wall_s']:.3f}s "
        f"({out['tok_per_s']:.1f} tok/s), assignment "
        f"{ {k: len(v) for k, v in out['assigned'].items()} }, balances "
        f"{out['balances']}")
    # where the time goes: each decode step streams every weight once, so
    # its floor is the weights' bytes over the memory rate
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params[0]))
    floor_ms = wbytes / HBM_BYTES_PER_S * 1e3
    steps = {nid: dict(prefill_ms=st.prefill_wall_s / max(1, st.batches)
                       * 1e3, prefill_batches=st.batches,
                       decode_ms=st.decode_wall_s / max(1, st.decode_steps)
                       * 1e3, decode_steps=st.decode_steps)
             for nid, st in out["stats"].items()}
    for nid, st in steps.items():
        log(f"  {nid}: {st['prefill_batches']} prefills at "
            f"{st['prefill_ms']:.2f} ms, {st['decode_steps']} decode steps "
            f"at {st['decode_ms']:.2f} ms (weight-streaming floor "
            f"{floor_ms:.2f} ms)")
    profile = profile_serve(serve, cfg, kw, out)
    log("serve_profile " + json.dumps(dict(
        steps=steps, weights_gb=wbytes / 1e9, step_floor_ms=floor_ms,
        tok_per_s=out["tok_per_s"], wall_s=out["wall_s"], **profile)))
    del params
    torch.cuda.empty_cache()
    return out, launches, seen


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
    log("[3] model consistency: paged decode vs fresh prefill")
    phase_consistency(n_layers=36)
    log("[4] serve (main path)")
    _, launches, seen = phase_serve()
    log("[5] kernels vs their plain versions at the main path's shapes")
    main_cases = phase_main_shapes(seen)
    kernels = []
    for name, meta in ops.KERNELS.items():
        r = main_cases[name]
        kernels.append(dict(
            name=name, route="cuda", source=meta["source"],
            replaces=meta["replaces"], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"], bound_by=r["bound_by"],
            library_ms=r["library_ms"], call_ms=r["call_ms"],
            shape=r["shape"], dtype=r["dtype"]))
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
