#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises (exit code != 0) when it fails:

1. print the card's name and power limit (``nvidia-smi``) and build the
   four CUDA sources from ``src/repro_torch/kernels/csrc`` (one ``nvcc``
   each, started together; six kernels: paged decode and paged verify each
   have an fp-page and an int8-page entry point); print ``-Xptxas -v``'s
   registers, shared memory and spills for the prefill, decode and verify
   bodies, the bf16 contiguous decode body at D=256 with zero spills, and
   disassemble their libraries (``cuobjdump -sass``): the bf16 prefill
   kernels (D=64, 128 and 256) must hold HGMMA (wgmma), the bf16 verify
   kernels (fp and int8 pages) and the bf16 decode kernels (paged at
   D=128 over fp and int8 pages, contiguous at D=64, 128 and 256) HMMA or
   HGMMA, and the CUDA-core bodies (fp32) neither;
2. hold each kernel against its plain PyTorch version on the card at
   qwen3-8b widths (H=32, Hkv=8, D=128, page 16) and, for the prefill and
   contiguous decode kernels, at the speculative draft's (H=2, Hkv=1,
   D=64), in bfloat16 and float32 with TF32 off -- absolute tolerance 1e-4
   (float32: the card sums in another order) and 2e-2 (bfloat16) -- and
   time the kernel, the plain version and, as a yardstick the port never
   calls, one ``scaled_dot_product_attention`` on the same (for paged
   kernels: gathered; for int8 pages: gathered and dequantized) inputs with
   a length mask.  The decode kernels (int8 pages too) also run on a few
   long rows (B=2 x 4096) and on ragged rows with a dead one, which in
   bf16 cut each row across blocks (``splits`` > 1, printed with every
   decode case); a split case is also held to 2e-2 of each (row, head)'s
   largest |plain| value.  bf16 decode cases under 100 MB are timed again with the L2
   emptied before each call (``cold_ms``).  The verify kernels also run
   at K = 32 and 33 (128 and 132 query rows per kv head, in tiles), and
   at K = 1 each must equal its paged decode kernel at ``lengths + 1``.
   The bf16 int8 paged decode kernel is also timed at 32 rows x 4096 with
   1-4 splits forced (``int8_split_sweep``: what its split target rests
   on).  Then every row the dense variants and the moe, vlm, hybrid and
   audio families run, at their head ratios (``RATIOS``: rep 9 = 36/4,
   rep 12 = 96/8, rep 8 = 64/8 and rep 7 = 28/4 for rows 1-4 with 2q and
   3q; rep 6 = 48/8, at D=64 rep 2 = 16/8 and at D=256 rep 16 = 16/1 for
   rows 1 and 4), in both dtypes, at the serve shape and one long shape
   (S=4096 prefill, 32 x 4096 decode and verify), the verify rows at rep
   12 also at K = 33 (396 query rows a kv head); at D=256 also the
   prefill under a 2048-token window, a decode over 32 rings of 2048, and
   two split decode cases (2 x 2048, and 2048/700/0 with a dead row);
   whisper-base's rows 1 and 4 (rep 1 = 8/8, D=64) at its own shapes
   instead: the encoder (B=4, S=1500, no mask), the cross prefill (B=4,
   32 queries over 1500 keys, no mask), the decoder's causal prompt (B=4,
   S=32), the cross decode over the 1500-frame cache (B=4, which must
   split in bf16) and the self ring (B=4, 40 of 48 positions).
   Each bf16 case prints
   ``vs_library`` (ms / library_ms: below 1, faster than the library call)
   and ``bound_share`` (bound_ms / ms: the share of the least time the
   card could take);
3. model consistency at full width: qwen3-8b, all 36 layers, float32.  A
   paged engine serves two requests, and the logits of every paged decode
   step must match a fresh prefill over the same tokens within 1e-3 *
   max|logit|; a slot engine and a speculative engine whose draft is the
   target itself (every draft accepted) serve the same requests, their
   slot-decode and verify logits (every one of the K positions) held to
   fresh prefills the same way, and all three engines' greedy tokens must
   be identical.  The same three engines on int8 KV: int8 slot-decode and
   int8 verify logits are held to the int8 paged-decode logits of the same
   token history (all attend the same quantized values) within 1e-3 *
   max|logit|, and their greedy tokens must be identical.  A prefix-cache
   engine serves two waves sharing a 48-token prefix: the warm prefill's
   logits and the decode steps after it are held to fresh prefills.  A
   disaggregated pair (``DisaggEngineExecutor``: a prefill engine and a
   decode engine over the same weights) serves the paged engine's
   requests: its greedy tokens must equal the paged engine's, and the
   prefill side's first decode and every decode-side step are held to
   fresh prefills.  ``apply_logits`` over one served sequence is held to
   fresh prefills at every position, and ``Engine.logprob_of`` of the
   sequence must equal the sum of the gold tokens' log-softmax taken from
   those fresh prefills within 1e-3 relative.  Then the dense variants
   and the moe family (``ARCH_CONSISTENCY``), each at full width in
   float32 on the port's seeded init with every bias, norm scale and norm
   bias perturbed: starcoder2-7b (32 layers) on slot, paged and
   speculative engines, qwen3-32b (8 of 64 layers) on slot and paged,
   command-r-plus-104b (4 of 64 layers) on paged and speculative engines
   (their drafts ``cfg.draft()``), granite-moe-1b-a400m (24 layers) and
   dbrx-132b (2 of 40 layers) on wave engines at capacity factor 8 (no
   token dropped, so a decode step and a prefill compute the same
   function), qwen2-vl-7b (28 layers) on slot, paged and speculative
   engines, recurrentgemma-9b (8 of 38 layers: two groups and the
   recurrent tail) on wave engines with one prompt of 2100 tokens, past
   its 2048-token window, xlstm-1.3b (all 48 layers) on wave engines with
   a 150-token prompt (two chunks and a padded third): every decode,
   verify and wave-decode logit row
   held to a fresh prefill over the same tokens (a wave row's with its
   left pads) within 1e-3 * max|logit|, every token the greedy choice of
   a fresh prefill, and each arch's tokens identical across its backends;
   and qwen2-vl-7b's ``dense.apply`` on embeddings at distinct (t, h, w)
   ids through the kernels held to the same call on the plain prefill
   within 1e-3 * max|logit|; whisper-base (6 + 6 layers, biases and
   norms perturbed) on two 16-token prompts over 1500 seeded frames:
   ``prefill`` and 8 greedy ``decode_step``s, each one's logits held to
   ``apply`` over the same frames and tokens within 1e-3 * max|logit|;
4. the main paths, through ``repro_torch.launch.serve.run`` -- the
   decentralized protocol assigns 8 requests and two nodes serve them with
   full-width qwen3-8b (36 layers, bfloat16, random weights seeded per
   node): [4] on paged engines, [4b] on slot engines (the driver's
   default), [4c] on speculative paged engines with the ``cfg.draft()``
   model, spec_k 4, [4d] on int8 paged engines (``--kv-quant``), [4e] on
   int8 speculative engines (``--spec --kv-quant``); then [4f] the prefix
   cache on ``Engine(paged=True, prefix_cache=True)`` with fp and int8
   pages, whose second wave must hit the cache and whose warm prefill
   verifies more than 16 tokens a row; [4g] on disaggregated
   prefill/decode pairs (``--disagg``), where each node's handoffs must
   cover every request that decoded past its first token, every handoff
   must carry 147456 bytes (qwen3-8b's K and V in bf16) per valid token,
   and a third, untimed run with ``trace=`` must write a Chrome trace
   with both clock domains, whose sim-clock stages add up to each
   request's simulated latency within 1e-9 s and which holds one
   ``disagg.handoff`` event per handoff; then the new configurations in
   bfloat16 (``PHASE_ARCH``, biases and norms perturbed): [4h]
   starcoder2-7b, all 32 layers, on paged engines, each node its own
   weights; [4i] qwen3-32b, all 64 layers, on slot engines and [4j]
   command-r-plus-104b, 16 of its 64 layers, on speculative engines, each
   with one set of weights for both nodes (one 80 GB card holds one);
   [4k] granite-moe-1b-a400m, all 24 layers, on the wave engines the moe
   family gets, [4l] qwen2-vl-7b, all 28 layers, on paged engines, and
   [4m] recurrentgemma-9b, all 38 layers, on wave engines (local attention
   at D=256), [4n] xlstm-1.3b, all 48 layers, on wave engines, whose path
   must launch no port kernel, each node its own weights; then [4o]
   whisper-base (bf16, perturbed) through the family interface, which the
   driver's wave path cannot reach: ``prefill`` on B=4 seeded 1500-frame
   embeddings and 32-token prompts and 16 greedy ``decode_step``s, with 18
   launches of row 1 and 12 of row 4 a step (both D=64), each cross decode
   also merging its splits.  Every request must return tokens,
   and every kernel of the phase's path must have launched: the launch
   counts are zeroed just before each run and read just after it, and the
   shapes, tables and lengths the run hands each kernel are recorded.
   Each phase reruns its scenario under ``torch.profiler`` for the
   device's busy share and each port kernel's device time there, with the
   launches the profiler saw held to the host's counts of the same rerun:
   on a shortfall the rerun runs again, up to 3 more times, and then the
   phase's port-kernel times are marked incomplete with both counts;
5. each kernel against its plain version again, at the shapes its serve
   phase gave it: the most frequent prefill shape, and the decode or verify
   step of median attended length with that step's own table and lengths;
   the verify kernels also at phase 4f's warm prefill; each kernel of
   phases 4h-4o at that phase's shapes and head ratio.

Times (``ms``, ``plain_ms``, ``library_ms``) are device time per call from
``torch.profiler`` over repeated calls on the same inputs (warm L2),
taken only from a session whose records are a multiple of the calls;
where three sessions running fell short, CUDA events around calls queued
behind a spinning kernel (``timed_by``);
``call_ms`` is the kernel wrapper's time per call from CUDA events around
back-to-back calls, which is the host's call rate where that is slower.

The line before the last is one JSON object ``{"kernels": [...]}`` with one
entry per kernel and head width built: its source, the TPU kernel it
replaces, the serve phase it was measured in, its launches there, and its
error and times at that phase's shapes (phase 5) beside the least time the
card could take (``bound_ms``: the larger of the bytes it must move over
3.35 TB/s and the operations it must do over the card's peak for their
type), with ``vs_library`` and ``bound_share``, its launches in phases
4f and 4g (``launches_4f``, ``launches_4g``), and, for each of phases
4h-4o whose path runs it, its launches and times there
(``arch_phases``); the D=256 entries are read in phase 4m.  The last line is ``{"ok":
true, "device": ...}``.  Without a CUDA card, or outside a checkout of the
repository, the script exits with an error before printing any result.
"""

from __future__ import annotations

import collections
import json
import pathlib
import re
import shutil
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12                 # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"bfloat16": 989e12,         # dense tensor-core rate
              "float32": 67e12}           # fp32 outside the tensor cores
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# the 50 MB L2 holds a case of fewer bytes across back-to-back calls: the
# bf16 decode cases under twice that are also timed with the L2 emptied
# before each call by a read of FLUSH_BYTES (cold_ms, cold_bound_share)
L2_BYTES = 50e6                           # H100 SXM, NVIDIA data sheet
FLUSH_BYTES = 256 * 2**20
# short spinning kernels (torch.cuda._sleep) around each profiled session's
# calls: the profiler may drop a session's first or last records
EDGE_SPINS, EDGE_SPIN_CYCLES = 32, 2_000
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
    "paged_decode_int8": ("paged_decode_int8", 128, "4d"),
    "paged_verify_int8": ("paged_verify_int8", 128, "4e"),
    "flash_attention_d256": ("flash_attention", 256, "4m"),
    "flash_decode_d256": ("flash_decode", 256, "4m"),
}
# serve phase: (engine mode, int8 KV); the driver's default mode, slot,
# gives the moe and hybrid families wave engines
PHASE_MODE = {"4": ("paged", False), "4b": ("slot", False),
              "4c": ("spec", False), "4d": ("paged", True),
              "4e": ("spec", True), "4g": ("disagg", False),
              "4h": ("paged", False), "4i": ("slot", False),
              "4j": ("spec", False), "4k": ("slot", False),
              "4l": ("paged", False), "4m": ("slot", False),
              "4n": ("slot", False)}
# the serve phases of the dense variants, the moe, vlm, hybrid and ssm
# families: (arch, layers served, one set of weights for both nodes).  qwen3-32b (65.5 GB of bf16
# weights) and command-r-plus-104b (56.6 GB at 16 of its 64 layers; 208 GB
# whole) fit one 80 GB card only with the two nodes sharing their weights,
# as the two engines of a disaggregated node already do; the others draw
# each node's own.  Phases 4-4g serve qwen3-8b, all 36 layers
PHASE_ARCH = {"4h": ("starcoder2-7b", 32, False),
              "4i": ("qwen3-32b", 64, True),
              "4j": ("command-r-plus-104b", 16, True),
              "4k": ("granite-moe-1b-a400m", 24, False),
              "4l": ("qwen2-vl-7b", 28, False),
              "4m": ("recurrentgemma-9b", 38, False),
              "4n": ("xlstm-1.3b", 48, False)}
# (kernel, head width) pairs each serve phase's path must launch
PATHS = {"4": {("flash_attention", 128), ("paged_decode", 128)},
         "4b": {("flash_attention", 128), ("flash_decode", 128)},
         "4c": {("flash_attention", 128), ("flash_attention", 64),
                ("flash_decode", 64), ("paged_verify", 128)},
         "4d": {("flash_attention", 128), ("paged_decode_int8", 128)},
         "4e": {("flash_attention", 128), ("flash_attention", 64),
                ("flash_decode", 64), ("paged_verify_int8", 128)},
         "4f": {("flash_attention", 128), ("paged_decode", 128),
                ("paged_verify", 128), ("paged_decode_int8", 128),
                ("paged_verify_int8", 128)},
         "4g": {("flash_attention", 128), ("paged_decode", 128)},
         "4h": {("flash_attention", 128), ("paged_decode", 128)},
         "4i": {("flash_attention", 128), ("flash_decode", 128)},
         "4j": {("flash_attention", 128), ("flash_attention", 64),
                ("flash_decode", 64), ("paged_verify", 128)},
         "4k": {("flash_attention", 64), ("flash_decode", 64)},
         "4l": {("flash_attention", 128), ("paged_decode", 128)},
         "4m": {("flash_attention", 256), ("flash_decode", 256)},
         # xlstm-1.3b has no attention: its path must launch no port kernel
         "4n": set(),
         # whisper-base through the family interface (not the driver)
         "4o": {("flash_attention", 64), ("flash_decode", 64)}}
KERNEL_OPS = {  # kernel: the ops entry point the model calls for it
    "flash_attention": "attention", "paged_decode": "paged_decode",
    "flash_decode": "decode", "paged_verify": "paged_verify",
    "paged_decode_int8": "paged_decode_quant",
    "paged_verify_int8": "paged_verify_quant"}


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


def _profiled(run, iters: int, edges: int = 0) -> list:
    """(name, us) of every device kernel ``torch.profiler`` records over
    ``iters`` calls of ``run``, between ``edges`` short spinning kernels
    (``torch.cuda._sleep``) on each side."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(edges):
            torch.cuda._sleep(EDGE_SPIN_CYCLES)
        for _ in range(iters):
            run()
        for _ in range(edges):
            torch.cuda._sleep(EDGE_SPIN_CYCLES)
        torch.cuda.synchronize()
    return [(e.name, e.time_range.elapsed_us()) for e in prof.events()
            if e.device_type == DeviceType.CUDA]


_SPIN_NAMES: set = set()


def spin_names() -> set:
    """The device kernel names of ``torch.cuda._sleep`` (named by a
    profiled run of the spinning kernels alone, once)."""
    import torch
    for _ in range(3):
        if not _SPIN_NAMES:
            _SPIN_NAMES.update(name for name, _ in _profiled(
                lambda: torch.cuda._sleep(EDGE_SPIN_CYCLES), EDGE_SPINS))
    if not _SPIN_NAMES:
        raise RuntimeError("the profiler recorded none of the spinning "
                           "kernels in 3 sessions")
    return _SPIN_NAMES


def _kernel_records(run, iters: int, skip=frozenset()) -> list:
    """``_profiled`` with ``EDGE_SPINS`` spinning kernels on each side of
    the calls, so that records a session loses at its start or its end are
    theirs rather than the calls', and with the spinning kernels and those
    named in ``skip`` left out."""
    spins = spin_names()
    return [(name, us) for name, us in _profiled(run, iters, EDGE_SPINS)
            if name not in skip and name not in spins]


def device_ms(fn, iters: int, attempts: int = 3) -> tuple[float, str]:
    """Mean device milliseconds per call and how they were timed: the
    summed duration of the device kernels ``torch.profiler`` records over
    ``iters`` calls.  Each call launches the same kernels, so a complete
    session records a multiple of ``iters`` of them; the profiler now and
    then drops records, and a session that falls short of a multiple (or
    records nothing) is run again.  After ``attempts`` such sessions the
    calls are timed by ``queued_ms`` instead, and ``timed_by`` says so:
    no sum of an incomplete session is reported."""
    import torch
    fn()
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        kern = _kernel_records(fn, iters)
        if kern and len(kern) % iters == 0:
            return sum(t for _, t in kern) / iters / 1e3, "profiler"
        counts.append(len(kern))
    log(f"  the profiler recorded {counts} device kernels over {iters} calls"
        f" in {attempts} sessions, none a multiple of the calls: timed by"
        f" CUDA events behind a spinning kernel instead")
    return queued_ms(fn, iters), "cuda_events"


def cold_ms(fn, iters: int, attempts: int = 3) -> tuple[float, str]:
    """Mean device milliseconds per call of ``fn`` with a cold L2: each
    call follows a read of ``FLUSH_BYTES`` (a sum), which leaves the L2
    holding only clean lines of that buffer (a write would leave dirty
    ones, whose write-back the timed call would pay for), and the device
    time summed is that of every kernel but the read's (named by a
    profiled run of reads alone).  A session whose kernels other than the
    read's are not a multiple of ``iters`` is run again; after
    ``attempts`` of them the calls are timed one by one by CUDA events,
    queued behind a spinning kernel."""
    import torch
    flush = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")

    def flushed():
        flush.sum()
        fn()

    flushed()
    torch.cuda.synchronize()
    counts = []
    for _ in range(attempts):
        own = frozenset(name for name, _ in _kernel_records(flush.sum,
                                                             iters))
        kern = _kernel_records(flushed, iters, own) if own else []
        if kern and len(kern) % iters == 0:
            return sum(t for _, t in kern) / iters / 1e3, "profiler"
        counts.append(len(kern))
    log(f"  the profiler recorded {counts} device kernels besides the L2"
        f" flush over {iters} cold calls in {attempts} sessions, none a"
        f" multiple of the calls: cold calls timed by CUDA events one by"
        f" one instead")
    marks = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(200_000_000)        # clock cycles
    for start, stop in marks:
        flush.sum()
        start.record()
        fn()
        stop.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in marks) / iters, "cuda_events"


def with_cold(r: dict, fn, iters: int) -> dict:
    """A bf16 case the L2 could hold (``bytes`` under twice its size) gains
    its cold-L2 time, ``cold_ms``, and how that was timed."""
    if r["dtype"] != "bfloat16" or r["bytes"] >= 2 * L2_BYTES:
        return r
    ms, how = cold_ms(fn, iters)
    return dict(r, cold_ms=ms, timed_by=dict(r["timed_by"], cold_ms=how))


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


def with_ratios(r: dict) -> dict:
    """A case's speed against the same run's library call (``vs_library``:
    ms / library_ms, below 1 is faster) and against the card's bound
    (``bound_share``: bound_ms / ms, the share of the least time; with a
    cold-L2 time, ``cold_bound_share`` too)."""
    cold = ({"cold_bound_share": r["bound_ms"] / r["cold_ms"]}
            if "cold_ms" in r else {})
    return dict(r, vs_library=r["ms"] / r["library_ms"],
                bound_share=r["bound_ms"] / r["ms"], **cold)


def check(name, got, want, dt) -> float:
    import torch
    err = (got.float() - want.float()).abs().max().item()
    if not (torch.isfinite(got.float()).all() and err <= TOL[dt]):
        raise AssertionError(f"{name} {dt}: max_err {err} > {TOL[dt]}")
    return err


def check_splits(name, got, want, splits) -> dict:
    """A case the bf16 decode kernel cut into ``splits`` > 1 is held,
    besides ``check``, to ``SPLIT_REL`` of each (row, head)'s largest
    |plain| value (``head_scaled_err``), which a fault in the merge of the
    splits exceeds where the absolute tolerance may not."""
    if splits < 2:
        return {}
    from repro_torch.kernels.decode_split import SPLIT_REL, head_scaled_err
    rel = head_scaled_err(got, want)
    if rel > SPLIT_REL:
        raise AssertionError(f"{name} ({splits} splits): head-scaled err "
                             f"{rel} > {SPLIT_REL}")
    return dict(head_scaled_err=rel, head_scaled_tol=SPLIT_REL)


def _shown(lengths):
    return lengths if len(lengths) <= 8 else f"{len(lengths)}x{lengths[0]}"


# ------------------------------------------------------------ phase 1
# (library, fragments of the kernel's mangled name, instructions one of
# which it must hold, or None: it must hold neither): the bf16 bodies run on the tensor cores
# (HGMMA is wgmma, HMMA mma.sync), the fp32 bodies on the CUDA cores
SASS_RULES = (
    ("flash_attention", ("flash_wgmma_kernelILi64E",), ("HGMMA",)),
    ("flash_attention", ("flash_wgmma_kernelILi128E",), ("HGMMA",)),
    ("flash_attention", ("flash_wgmma_kernelILi256E",), ("HGMMA",)),
    ("flash_attention", ("flash_fwd_kernel",), None),
    ("paged_verify", ("verify_mma_kernel", "Bf16Pages"), ("HMMA", "HGMMA")),
    ("paged_verify", ("verify_mma_kernel", "Int8Pages"), ("HMMA", "HGMMA")),
    ("paged_verify", ("attend_kernel",), None),
    ("paged_decode", ("decode_mma_kernelILi128E", "PagedKv"), ("HMMA", "HGMMA")),
    ("paged_decode", ("decode_mma_kernelILi128E", "DecodeInt8"), ("HMMA", "HGMMA")),
    ("paged_decode", ("attend_kernel",), None),
    ("flash_decode", ("decode_mma_kernelILi64E", "ContiguousKv"), ("HMMA", "HGMMA")),
    ("flash_decode", ("decode_mma_kernelILi128E", "ContiguousKv"), ("HMMA", "HGMMA")),
    ("flash_decode", ("decode_mma_kernelILi256E", "ContiguousKv"), ("HMMA", "HGMMA")),
    ("flash_decode", ("attend_kernel",), None),
)


# kernels whose -Xptxas -v report must show zero spill stores and loads:
# the bf16 contiguous decode body at D = 256, whose 128 accumulators a
# thread leave room for the query fragments only when read per k-step
NO_SPILLS = (("decode_mma_kernelILi256E", "ContiguousKv"),)


def check_no_spills(report, rules) -> None:
    """Each kernel of ``rules`` (fragments of its name) is in the ptxas
    ``report`` and spills nothing."""
    for frags in rules:
        names = [n for n in report if all(f in n for f in frags)]
        if not names:
            raise AssertionError(f"no ptxas report for {frags}")
        for n in names:
            r = report[n]
            if r.get("spill_stores", 0) or r.get("spill_loads", 0):
                raise AssertionError(f"{n} spills: {r}")


def _disassembler() -> str:
    """cuobjdump from the toolkit, else Triton's copy."""
    found = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if pathlib.Path(found).exists():
        return found
    try:
        import triton
        found = str(pathlib.Path(triton.__file__).parent / "backends" / "nvidia"
                    / "bin" / "cuobjdump")
    except ImportError:
        pass
    if not pathlib.Path(found).exists():
        raise RuntimeError("no cuobjdump in the toolkit or in triton")
    return found


def sass_check(build_dir) -> dict:
    """Disassemble the built libraries and hold each kernel of SASS_RULES
    to its rule; returns, per kernel, its count of HGMMA and HMMA
    instructions."""
    tool = _disassembler()
    found = {}
    for lib in sorted({lib for lib, _, _ in SASS_RULES}):
        sass = subprocess.run([tool, "-sass", str(build_dir / f"lib{lib}.so")],
                              capture_output=True, text=True,
                              check=True).stdout
        for block in sass.split("Function : ")[1:]:
            name = block.split(None, 1)[0]
            found[name] = {op: len(re.findall(rf"\b{op}\b", block))
                           for op in ("HGMMA", "HMMA")}
    report = {}
    for lib, frags, need in SASS_RULES:
        names = [n for n in found if all(f in n for f in frags)]
        if not names:
            raise AssertionError(f"lib{lib}.so holds no kernel {frags}: "
                                 f"{sorted(found)}")
        for n in names:
            counts = found[n]
            if need is None and any(counts.values()):
                raise AssertionError(f"{n}: fp32 body on the tensor cores "
                                     f"{counts}")
            if need is not None and not any(counts[op] for op in need):
                raise AssertionError(f"{n}: no {' or '.join(need)} in its "
                                     f"SASS {counts}")
            report[n] = counts
    return report


def ptxas_report(logs, fragments) -> dict:
    """Registers, shared memory and spills that ``-Xptxas -v`` printed for
    each kernel whose name holds one of ``fragments``."""
    out, cur = {}, None
    for text in logs.values():
        for line in text.splitlines():
            m = re.search(r"(?:Compiling entry function|Function properties "
                          r"for) '?([\w$]+)'?", line)
            if m:
                cur = m.group(1) if any(f in m.group(1) for f in fragments) \
                    else None
                continue
            if cur is None:
                continue
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
            if m:
                out.setdefault(cur, {}).update(
                    spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                smem = re.search(r"(\d+) bytes smem", line)
                out.setdefault(cur, {}).update(
                    registers=int(m.group(1)),
                    static_smem=int(smem.group(1)) if smem else 0)
    return out


# ------------------------------------------------------------ phases 2, 5
def prefill_case(name, b, s, dt, *, heads=TARGET, window=None, causal=True,
                 skv=None, iters=50):
    """The prefill kernel on ``s`` query positions against ``skv`` (default
    ``s``) keys."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.ref import flash_ref
    h, hkv, d = heads
    dtype = getattr(torch, dt)
    skv = skv or s
    g = torch.Generator("cuda").manual_seed(b * 1000 + s + d + skv - s)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dtype)
               for shape in ((b, s, h, d), (b, skv, hkv, d),
                             (b, skv, hkv, d)))
    got = flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    err = check(f"prefill {name}", got,
                flash_ref(q, k, v, causal=causal, window=window), dt)
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    qp, kp = torch.arange(s), torch.arange(skv)
    mask = None
    if window is not None:
        mask = ((qp[:, None] >= kp[None, :])
                & (qp[:, None] - kp[None, :] < window)).cuda()
    t = timings(
        lambda: flash_attention_cuda(q, k, v, causal=causal, window=window),
        lambda: flash_ref(q, k, v, causal=causal, window=window),
        lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, is_causal=causal and mask is None,
            enable_gqa=True), iters)
    vis = torch.ones((s, skv), dtype=torch.bool)
    if causal:
        vis &= qp[:, None] >= kp[None, :]
    if window is not None:
        vis &= qp[:, None] - kp[None, :] < window
    flops = 4.0 * b * h * d * int(vis.sum())
    nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
    return dict(case=name, dtype=dt, shape=f"B={b} S={s} "
                + (f"Skv={skv} " if skv != s else "")
                + f"H={h} Hkv={hkv} D={d}"
                + (f" window={window}" if window else "")
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
    splits = flash_decode_cuda.last_splits
    want = decode_ref(q, kc, vc, ln, window=window)
    err = check(f"decode {name}", got, want, dt)
    scaled = check_splits(f"decode {name}", got, want, splits)
    pos = torch.arange(s, device="cuda")[None, :]
    valid = pos < ln[:, None]
    if window is not None:
        valid &= pos >= ln[:, None] - window
    mask = valid[:, None, None, :]
    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, kc, vc))
    def run():
        return flash_decode_cuda(q, kc, vc, ln, window=window)

    t = timings(run, lambda: decode_ref(q, kc, vc, ln, window=window),
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
    return with_cold(dict(
        case=name, dtype=dt, shape=f"B={b} S={s} lengths={_shown(lengths)} "
        f"H={h} Hkv={hkv} D={d}" + (f" window={window}" if window else ""),
        splits=splits, max_abs_err=err, tol=TOL[dt], **scaled, **t,
        **bound(nbytes, flops, dt)), run, iters)


def fresh_tables(lengths, width=None, page=PAGE):
    """A block table with distinct pages of ``page`` positions per row
    covering ``lengths`` positions (cut at ``width`` columns if given);
    entries past a row's allocation point at the scratch page 0."""
    import numpy as np
    n_row = [-(-ln // page) for ln in lengths]
    if width is not None:
        n_row = [min(n, width) for n in n_row]
    bt = np.zeros((len(lengths), width or max(2, max(n_row) + 1)), np.int32)
    free = list(range(1, 1 + sum(n_row)))
    for i, n in enumerate(n_row):
        for j in range(n):
            bt[i, j] = free.pop()
    return bt


def _pool(bt, lengths, kq, dt, seed, quant=False, page=PAGE, heads=TARGET):
    """q (B, kq, H, D), random pools holding every page ``bt`` names --
    (k, v) of q's dtype, or with ``quant`` (k, v, k_scale, v_scale): the
    same random values quantized to int8 pages and bf16 scales on the card
    by the port's ``kv_quantize`` -- the table and the lengths; ``heads``
    is (H, Hkv, D)."""
    import torch
    from repro_torch.models.attention import kv_quantize
    h, hkv, d = heads
    dtype = getattr(torch, dt)
    g = torch.Generator("cuda").manual_seed(seed)
    n_pool = int(bt.max()) + 1
    q = torch.randn((bt.shape[0], kq, h, d), generator=g,
                    device="cuda").to(dtype)
    kp, vp = (torch.randn((n_pool, page, hkv, d), generator=g,
                          device="cuda").to(dtype) for _ in range(2))
    pools = (kp, vp)
    if quant:
        (kq_, ks), (vq_, vs) = kv_quantize(kp), kv_quantize(vp)
        pools = (kq_, vq_, ks, vs)
    return (q, pools, torch.from_numpy(bt).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"))


def _paged_fns(verify, quant):
    """The kernel wrapper and plain version of paged decode or verify, fp
    or int8 pages."""
    from repro_torch.kernels import paged_decode, paged_verify, ref
    if verify:
        return ((paged_verify.paged_verify_int8_cuda,
                 ref.paged_verify_quant_ref) if quant else
                (paged_verify.paged_verify_cuda, ref.paged_verify_ref))
    return ((paged_decode.paged_decode_int8_cuda, ref.paged_decode_quant_ref)
            if quant else (paged_decode.paged_decode_cuda,
                           ref.paged_decode_ref))


def _gathered(pools, btc, dtype):
    """The library call's K/V: each row's pages gathered (and dequantized
    to q's dtype for int8 pages) in SDPA's (B, Hkv, S, D) layout."""
    from repro_torch.kernels.ref import _gather_dequantized, _gather_pages
    if len(pools) == 4:
        kg = _gather_dequantized(pools[0], pools[2], btc, dtype)
        vg = _gather_dequantized(pools[1], pools[3], btc, dtype)
    else:
        kg, vg = (_gather_pages(p, btc) for p in pools)
    return tuple(x.transpose(1, 2).contiguous() for x in (kg, vg))


def _kv_bytes(positions, quant, elem, heads=TARGET):
    """Bytes of ``positions`` (position, kv head) K or V vectors: D values
    of the pool's type, plus one bf16 scale each for int8 pages."""
    _, hkv, d = heads
    return positions * hkv * (d * 1 + 2 if quant else d * elem)


def paged_case(name, bt, lengths, dt, *, iters=100, quant=False, page=PAGE,
               heads=TARGET):
    """The paged decode kernel (``quant``: its int8 form) on block table
    ``bt`` (numpy int32 (B, maxp)) and ``lengths``, over a random pool of
    ``page``-position pages holding every page the table names."""
    import torch.nn.functional as F
    import torch
    kernel, plain = _paged_fns(False, quant)
    b, maxp = bt.shape
    h, hkv, d = heads
    q, pools, btc, ln = _pool(bt, lengths, 1, dt, sum(lengths) + b, quant,
                              page, heads)
    got = kernel(q, *pools, btc, ln)
    torch.cuda.synchronize()
    splits = kernel.last_splits
    want = plain(q, *pools, btc, ln)
    err = check(f"paged{' int8' * quant} {name}", got, want, dt)
    scaled = check_splits(f"paged{' int8' * quant} {name}", got, want,
                          splits)
    kg, vg = _gathered(pools, btc, q.dtype)
    mask = (torch.arange(maxp * page, device="cuda")[None, :]
            < ln[:, None])[:, None, None, :]
    qt = q.transpose(1, 2).contiguous()
    def run():
        return kernel(q, *pools, btc, ln)

    t = timings(run, lambda: plain(q, *pools, btc, ln),
                lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask, enable_gqa=True), iters)
    # what the function needs: a live row's K and V up to its length and
    # QK + PV on them; a length-0 row averages V over its whole table and
    # needs no K and no QK; each row's table entries for those positions
    cap = maxp * page
    k_pos = sum(min(n, cap) for n in lengths if n > 0)
    v_pos = k_pos + cap * sum(1 for n in lengths if n <= 0)
    entries = sum(-(-(min(n, cap) if n > 0 else cap) // page)
                  for n in lengths)
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem
              + _kv_bytes(k_pos + v_pos, quant, elem, heads)
              + 4 * (entries + b))
    flops = 2.0 * h * d * (k_pos + v_pos)
    return with_cold(dict(
        case=name, dtype=dt, shape=f"B={b} maxp={maxp} "
        f"lengths={_shown(lengths)} H={h} Hkv={hkv} D={d} page={page}"
        + (" int8 pages" if quant else ""), splits=splits, max_abs_err=err,
        tol=TOL[dt], **scaled, **t, **bound(nbytes, flops, dt)), run, iters)


def int8_split_sweep(splits=(1, 2, 3, 4), iters=20) -> dict:
    """The bf16 int8 paged decode kernel at 32 rows x 4096 with its split
    count forced -- the C entry point called directly, so no wrapper
    counts these launches -- each held to the plain version and timed:
    the measurement ``decode_split.TARGET_BLOCKS_INT8`` rests on."""
    import torch
    from repro_torch.kernels import _build, paged_decode
    from repro_torch.kernels.decode_split import split_span
    from repro_torch.kernels.ref import paged_decode_quant_ref
    lengths = [4096] * 32
    bt = fresh_tables(lengths)
    b, maxp = bt.shape
    q, pools, btc, ln = _pool(bt, lengths, 1, "bfloat16", 5, True)
    want = paged_decode_quant_ref(q, *pools, btc, ln)
    fn = _build.function("paged_decode", "paged_decode_int8_fwd",
                         paged_decode._INT8_ARGTYPES)
    out = {}
    for z in splits:
        work = torch.empty(b * H * z * (D + 2), device="cuda")
        got = torch.empty_like(q)

        def run():
            err = fn(q.data_ptr(), *(t.data_ptr() for t in pools),
                     btc.data_ptr(), ln.data_ptr(), got.data_ptr(),
                     work.data_ptr(), 1, b, H, HKV, D, PAGE, maxp,
                     pools[0].shape[0], z, split_span(maxp * PAGE, z),
                     D ** -0.5, 0, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"paged_decode_int8_fwd: CUDA error {err}")

        run()
        torch.cuda.synchronize()
        err = check(f"paged int8 long, {z} splits", got, want, "bfloat16")
        if z > 1:
            check_splits(f"paged int8 long, {z} splits", got, want, z)
        out[z] = dict(zip(("ms", "timed_by"), device_ms(run, iters)),
                      max_abs_err=err)
    log("  paged_decode_int8 long (B=32 x 4096, bf16) with its splits forced:"
        + "".join(f" {z}: {r['ms']:.4f} ms" for z, r in out.items()))
    return out


def verify_case(name, bt, lengths, kq, dt, *, iters=100, quant=False,
                heads=TARGET):
    """The paged verify kernel (``quant``: its int8 form): ``kq`` query
    tokens per row over block table ``bt`` with ``lengths`` valid
    positions before them."""
    import torch
    import torch.nn.functional as F
    kernel, plain = _paged_fns(True, quant)
    b, maxp = bt.shape
    h, hkv, d = heads
    q, pools, btc, ln = _pool(bt, lengths, kq, dt, sum(lengths) + kq, quant,
                              heads=heads)
    got = kernel(q, *pools, btc, ln)
    torch.cuda.synchronize()
    err = check(f"verify{' int8' * quant} {name}", got,
                plain(q, *pools, btc, ln), dt)
    kg, vg = _gathered(pools, btc, q.dtype)
    cap = maxp * PAGE
    limit = ln[:, None] + torch.arange(kq, device="cuda")[None, :]
    mask = (torch.arange(cap, device="cuda")[None, None, :]
            <= limit[..., None])[:, None]                   # (B, 1, K, S)
    qt = q.transpose(1, 2).contiguous()
    t = timings(lambda: kernel(q, *pools, btc, ln),
                lambda: plain(q, *pools, btc, ln),
                lambda: F.scaled_dot_product_attention(
                    qt, kg, vg, attn_mask=mask, enable_gqa=True), iters)
    # what the function needs: each row's K and V through its last query's
    # bound, its table entries for them, and QK + PV of every query over
    # the positions it sees
    read = [min(n + kq, cap) for n in lengths]
    seen = sum(min(n + j + 1, cap) for n in lengths for j in range(kq))
    elem = q.element_size()
    nbytes = (2 * q.numel() * elem
              + _kv_bytes(2 * sum(read), quant, elem, heads)
              + 4 * (sum(-(-r // PAGE) for r in read) + b))
    flops = 4.0 * h * d * seen
    return dict(case=name, dtype=dt, shape=f"B={b} K={kq} maxp={maxp} "
                f"lengths={_shown(lengths)} H={h} Hkv={hkv} D={d} "
                f"page={PAGE}" + (" int8 pages" if quant else ""),
                max_abs_err=err, tol=TOL[dt], **t,
                **bound(nbytes, flops, dt))


def verify_one_token_is_decode(dt, quant=False) -> float:
    """K = 1 verify at ``lengths`` against the paged decode kernel at
    ``lengths + 1`` (fp or int8 pages): the same function, two kernels."""
    import torch
    verify, _ = _paged_fns(True, quant)
    decode, _ = _paged_fns(False, quant)
    lengths = [28, 1, 40, 0]
    q, pools, btc, ln = _pool(fresh_tables([n + 1 for n in lengths]),
                              lengths, 1, dt, 11, quant)
    got = verify(q, *pools, btc, ln)
    want = decode(q, *pools, btc, ln + 1)
    torch.cuda.synchronize()
    return check(f"verify{' int8' * quant} K=1 vs paged decode", got, want,
                 dt)


def show(name, r) -> None:
    log(f"  {name:19s} {r['case']:10s} {r['dtype']:8s} "
        f"max_err {r['max_abs_err']:.2e} kernel {r['ms']:.4f} ms "
        f"(call {r['call_ms']:.4f}) plain {r['plain_ms']:.4f} ms sdpa "
        f"{r['library_ms']:.4f} ms bound {r['bound_ms']:.5f} ms "
        f"({r['bound_by']})"
        + (f" vs_library {r['vs_library']:.2f}x bound_share "
           f"{r['bound_share']:.1%}" if r["dtype"] == "bfloat16" else "")
        + (f" splits {r['splits']}" if "splits" in r else "")
        + (f" head_scaled_err {r['head_scaled_err']:.2e}"
           if "head_scaled_err" in r else "")
        + (f" cold {r['cold_ms']:.4f} ms cold_bound_share "
           f"{r['cold_bound_share']:.1%}" if "cold_ms" in r else "")
        + f"  [{r['shape']}]"
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
        # a few long rows and ragged ones with a dead row, too few to fill
        # the card: bf16 cuts each across blocks.  The ragged case's
        # 256-position pages put split boundaries (whole 64-position
        # chunks) inside pages
        ragged = [4096, 1500, 0]
        cases["paged_decode"] += [
            paged_case("rider", fresh_tables(rider), rider, dt, iters=200),
            paged_case("long", fresh_tables([4096] * 32), [4096] * 32, dt,
                       iters=20),
            paged_case("few long", fresh_tables([4096] * 2), [4096] * 2, dt,
                       iters=100),
            paged_case("ragged", fresh_tables(ragged, page=256), ragged, dt,
                       iters=100, page=256),
        ]
        cases["flash_decode"] += [
            decode_case("rider", 64, [25, 1, 33, 0], dt, iters=200),
            decode_case("long", 4096, [4096] * 32, dt, iters=20),
            decode_case("window", 4096, [4096, 3000, 100, 0] * 2, dt,
                        window=1024, iters=20),
            decode_case("few long", 4096, [4096] * 2, dt, iters=100),
            decode_case("ragged", 4096, ragged, dt, iters=100),
        ]
        cases["flash_decode_d64"] += [
            decode_case("rider", 72, [25, 1, 33, 0], dt, heads=DRAFT,
                        iters=200),
            decode_case("long", 4096, [4096] * 32, dt, heads=DRAFT,
                        iters=20),
            decode_case("few long", 4096, [4096] * 2, dt, heads=DRAFT,
                        iters=100),
        ]
        # a rider whose lengths + K passes its 2-page table
        past = [30, 31, 9, 0]
        # K = 32 tokens x rep 4 = 128 query rows (4 tiles of 32 in bf16, 2
        # of 64 in fp32), as a warm prefill of a 17-32 token suffix over 3
        # cached pages runs it; K = 33 leaves a ragged last tile
        warm = [48, 48, 0, 16]
        for entry, quant in (("paged_verify", False),
                             ("paged_verify_int8", True)):
            cases[entry] += [
                verify_case("rider", fresh_tables(past, width=2), past,
                            SPEC_K + 1, dt, iters=200, quant=quant),
                verify_case("long", fresh_tables([4096 + SPEC_K + 1] * 32),
                            [4096] * 32, SPEC_K + 1, dt, iters=20,
                            quant=quant),
                verify_case("k32", fresh_tables([n + 32 for n in warm]),
                            warm, 32, dt, iters=100, quant=quant),
                verify_case("k33", fresh_tables([n + 33 for n in warm],
                                                width=5),
                            warm, 33, dt, iters=100, quant=quant),
            ]
        cases["paged_decode_int8"] += [
            paged_case("rider", fresh_tables(rider), rider, dt, iters=200,
                       quant=True),
            paged_case("long", fresh_tables([4096] * 32), [4096] * 32, dt,
                       iters=20, quant=True),
            paged_case("few long", fresh_tables([4096] * 2), [4096] * 2, dt,
                       iters=100, quant=True),
            paged_case("ragged", fresh_tables(ragged, page=256), ragged, dt,
                       iters=100, quant=True, page=256),
        ]
        for quant in (False, True):
            err = verify_one_token_is_decode(dt, quant)
            log(f"  paged_verify{'_int8' * quant} K=1 {dt}: max_err "
                f"{err:.2e} against paged decode{' int8' * quant} at "
                f"lengths + 1")
    sweep = int8_split_sweep()
    cases = {name: [with_ratios(r) for r in rows]
             for name, rows in cases.items()}
    for name, rows in cases.items():
        for r in rows:
            show(name, r)
    # too few rows to fill the card: the bf16 decode kernels split them
    for name in ("paged_decode", "paged_decode_int8", "flash_decode",
                 "flash_decode_d64"):
        for r in cases[name]:
            if (r["case"] in ("few long", "ragged", "window")
                    and r["dtype"] == "bfloat16" and r["splits"] < 2):
                raise AssertionError(f"{name} {r['case']}: ran with "
                                     f"{r['splits']} split")
    log("kernel_cases " + json.dumps(cases))
    log("int8_split_sweep " + json.dumps(sweep))
    return cases


# the head ratios of the dense, moe, vlm and hybrid configs: label -> ((H,
# Hkv, D), the kernel-table rows their paths run).  Rows 1, 3 and 3q flatten Sq * rep
# query rows of a kv head into tiles, which straddle query positions
# unevenly at rep 9 and 12; the decode body keeps rep <= 16 rows of one
# 16-row slice
RATIOS = {
    "rep9 (starcoder2-7b)": ((36, 4, 128), ("1", "2", "2q", "3", "3q", "4")),
    "rep12 (command-r-plus-104b)": ((96, 8, 128),
                                    ("1", "2", "2q", "3", "3q", "4")),
    "rep8 (qwen3-32b)": ((64, 8, 128), ("1", "2", "2q", "3", "3q", "4")),
    "rep6 (dbrx-132b)": ((48, 8, 128), ("1", "4")),
    "rep2 D=64 (granite-moe-1b-a400m)": ((16, 8, 64), ("1", "4")),
    "rep7 (qwen2-vl-7b)": ((28, 4, 128), ("1", "2", "2q", "3", "3q", "4")),
    "rep16 D=256 (recurrentgemma-9b)": ((16, 1, 256), ("1", "4")),
    "rep1 D=64 (whisper-base)": ((8, 8, 64), ("1", "4")),
}
# whisper-base's rows at its own shapes (``whisper_cases``): the encoder
# over 1500 frames, the cross attention of a 32-token prompt over them
# and the decoder's causal prompt; the cross decode over all 1500 frames
# (which splits in bf16) and the self-attention ring of a 32 + 16 wave
WHISPER_HEADS, WHISPER_FRAMES, WHISPER_PROMPT, WHISPER_STEPS = (
    (8, 8, 64), 1500, 32, 16)
# recurrentgemma-9b's local attention: its 2048-token window over a 4096
# prefill, a ring of 2048 positions at 32 rows, and bf16 split cases (one
# block an SM at D = 256: its own split target): two full rings, and
# ragged rows with a dead one
WINDOW_D256 = 2048


def phase_ratios() -> dict:
    """[2, new head ratios] Each row its configs run against its plain
    version at each ratio of ``RATIOS``, in bfloat16 and float32, at the
    serve path's shape ("main": a prefill of 4 x 32 tokens, a decode or
    K = 5 verify step of four rows with a length-0 rider) and one long
    shape (S = 4096 prefill, 32 rows x 4096 decode and verify), timed with
    ``vs_library`` and ``bound_share``; at rep 12 the verify rows also at
    K = 33 (396 query rows a kv head); at D = 256 the prefill also under
    the 2048-token window and the decode over a 32-row ring of 2048 and
    on rows too few to fill the card (two full rings; 2048/700/0), which
    must split in bf16 and stay within ``SPLIT_REL``."""
    out = {}
    rider, past, warm = [0, 17, 40, 33], [30, 31, 9, 0], [48, 48, 0, 16]
    long_rows = [4096] * 32
    for label, (heads, rows) in RATIOS.items():
        cases = []
        for dt in ("bfloat16", "float32"):
            if heads == WHISPER_HEADS:
                cases += whisper_cases(dt)
                continue
            if "1" in rows:
                cases += [("1", prefill_case("main", 4, 32, dt, heads=heads,
                                             iters=50)),
                          ("1", prefill_case("long", 1, 4096, dt,
                                             heads=heads, iters=5))]
            if "4" in rows:
                cases += [("4", decode_case("main", 64, [25, 1, 33, 0], dt,
                                            heads=heads, iters=50)),
                          ("4", decode_case("long", 4096, long_rows, dt,
                                            heads=heads, iters=10))]
            if heads[2] == 256:
                ring = WINDOW_D256
                cases += [
                    ("1", prefill_case("window", 1, 4096, dt, heads=heads,
                                       window=ring, iters=5)),
                    ("4", decode_case("ring", ring, [ring] * 32, dt,
                                      heads=heads, iters=10)),
                    ("4", decode_case("few long", ring, [ring] * 2, dt,
                                      heads=heads, iters=50)),
                    ("4", decode_case("ragged", ring, [ring, 700, 0], dt,
                                      heads=heads, iters=50))]
            for row, quant in (("2", False), ("2q", True)):
                if row in rows:
                    cases += [
                        (row, paged_case("main", fresh_tables(rider), rider,
                                         dt, iters=50, quant=quant,
                                         heads=heads)),
                        (row, paged_case("long", fresh_tables(long_rows),
                                         long_rows, dt, iters=10,
                                         quant=quant, heads=heads))]
            for row, quant in (("3", False), ("3q", True)):
                if row not in rows:
                    continue
                cases += [
                    (row, verify_case("main", fresh_tables(past, width=2),
                                      past, SPEC_K + 1, dt, iters=50,
                                      quant=quant, heads=heads)),
                    (row, verify_case("long", fresh_tables(
                        [n + SPEC_K + 1 for n in long_rows]), long_rows,
                        SPEC_K + 1, dt, iters=10, quant=quant, heads=heads))]
                if heads[0] // heads[1] == 12:
                    cases.append((row, verify_case(
                        "k33", fresh_tables([n + 33 for n in warm], width=5),
                        warm, 33, dt, iters=20, quant=quant, heads=heads)))
        out[label] = [dict(with_ratios(r), row=row) for row, r in cases]
        for r in out[label]:
            show(f"row {r['row']} {label.split()[0]}", r)
            if (r["case"] in ("few long", "ragged", "cross")
                    and r.get("splits") == 1 and r["dtype"] == "bfloat16"):
                raise AssertionError(f"{label} {r['case']}: ran with "
                                     f"{r['splits']} split")
    log("ratio_cases " + json.dumps(out))
    return out


def whisper_cases(dt) -> list:
    """[2] whisper-base's rows 1 and 4 (rep 1, D = 64) at the shapes of
    phase 4o, as (row, case) pairs."""
    b, se, s = 4, WHISPER_FRAMES, WHISPER_PROMPT
    cap = s + WHISPER_STEPS
    heads = WHISPER_HEADS
    return [
        ("1", prefill_case("encoder", b, se, dt, heads=heads, causal=False,
                           iters=20)),
        ("1", prefill_case("cross", b, s, dt, heads=heads, causal=False,
                           skv=se, iters=50)),
        ("1", prefill_case("main", b, s, dt, heads=heads, iters=50)),
        ("4", decode_case("cross", se, [se] * b, dt, heads=heads, iters=50)),
        ("4", decode_case("ring", cap, [cap - 8] * b, dt, heads=heads,
                          iters=50))]


def _most_common_prefill(seen, d):
    """The prefill shape (q shape, causal, window, Skv) called most often
    at head width ``d``; of shapes called as often, the one of most query
    and key positions (whisper's encoder, in phase 4o)."""
    shapes = collections.Counter(x for x in seen if x[0][3] == d)
    log(f"  prefill shapes at D={d} (q shape, causal, window, Skv: calls): "
        f"{ {str(k): v for k, v in shapes.items()} }")
    return max(shapes, key=lambda x: (shapes[x], x[0][1] * x[3]))


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
        (b, s, h, d), causal, window, skv = _most_common_prefill(
            seen[phase]["flash_attention"], heads[2])
        if (h, d) != (heads[0], heads[2]):
            raise AssertionError(f"{entry}: prefill heads {h} x {d}")
        out[entry] = prefill_case("main", b, s, "bfloat16", heads=heads,
                                  causal=causal, window=window, skv=skv,
                                  iters=200)
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
    bt, ln = _median(seen["4d"]["paged_decode_int8"],
                     "int8 paged decode (phase 4d)")
    out["paged_decode_int8"] = paged_case("main", _dense_pages(bt),
                                          [int(x) for x in ln], "bfloat16",
                                          iters=200, quant=True)
    for entry, phase, quant in (("paged_verify", "4c", False),
                                ("paged_verify_int8", "4e", True)):
        kq, bt, ln = _median(seen[phase][entry], f"{entry} (phase {phase})")
        out[entry] = verify_case("main", _dense_pages(bt),
                                 [int(x) for x in ln], kq, "bfloat16",
                                 iters=200, quant=quant)
        # the prefix cache's warm prefill (phase 4f): its widest verify
        kq, bt, ln = max(seen["4f"][entry], key=lambda st: st[0])
        out[entry + "_warm"] = verify_case(
            "warm", _dense_pages(bt), [int(x) for x in ln], kq, "bfloat16",
            iters=100, quant=quant)
    out = {entry: with_ratios(r) for entry, r in out.items()}
    for entry, r in out.items():
        show(entry, r)
    log("main_cases " + json.dumps(out))
    return out


# ------------------------------------------------------------ phase 3
class Consistency:
    """Phase 3's yardstick for one model: the last-position logits of a
    fresh prefill over a token history (cached), and the hold of a
    recorded logit row to them within 1e-3 x max|logit| (``worst`` keeps
    each kind's largest |diff| / max|logit|)."""

    def __init__(self, cfg, params):
        from repro_torch.models import registry
        self.cfg, self.params = cfg, params
        self.prefill = registry.get_family(cfg).prefill
        self.cache, self.worst = {}, {}

    def fresh(self, toks):
        import torch
        key = tuple(int(t) for t in toks)
        if key not in self.cache:
            self.cache[key] = self.prefill(
                self.params, self.cfg, torch.tensor([list(key)],
                                                    device="cuda"))[0][0, 0] \
                .float().cpu()
        return self.cache[key]

    def held(self, kind, got, want, what):
        diff = float((got - want).abs().max())
        scale = float(want.abs().max())
        self.worst[kind] = max(self.worst.get(kind, 0.0), diff / scale)
        if diff > 1e-3 * scale:
            raise AssertionError(f"{what}: |{kind}| {diff:.3e} > "
                                 f"1e-3 * {scale:.3e}")

    def hold_history(self, kind, steps):
        """Hold every recorded logit row to a fresh prefill over its fed
        history; returns how many."""
        rows = by_history(steps)
        for key, got in rows.items():
            self.held(kind, got, self.fresh(list(key)),
                      f"{kind} after {len(key)} tokens")
        return len(rows)

    def hold_greedy(self, kind, histories):
        """Each emitted token is the greedy choice of a fresh prefill:
        ``histories`` pairs each request's fed prompt (a wave's with its
        left pads) with its result."""
        import torch
        from repro_torch.serving.sampling import masked_logits
        for rid, prompt, result in histories:
            toks = [int(t) for t in prompt] + [int(t) for t in result]
            for t in range(len(result)):
                want = int(torch.argmax(masked_logits(
                    self.fresh(toks[: len(prompt) + t]),
                    self.cfg.vocab_size)))
                if want != int(result[t]):
                    raise AssertionError(f"{kind} {rid} token {t}: "
                                         f"{result[t]} != prefill {want}")


def recorder(eng, attr, steps):
    """Wrap ``eng``'s decode or verify forward ``attr`` so that each step
    appends its live rows' fed histories, tokens and logits to
    ``steps``."""
    fwd = getattr(eng, attr)

    def recording(p, c_, cache, tok):
        # rows with a sampled token are the step's live rows; their fed
        # history is the prompt plus what they emitted before it
        live = {i: [int(t) for t in s.req.tokens] + s.out[:-1]
                for i, s in enumerate(eng._slots)
                if s is not None and s.out}
        logits, cache = fwd(p, c_, cache, tok)
        if live:
            steps.append((live, tok.cpu().tolist(), logits.float().cpu()))
        return logits, cache

    setattr(eng, attr, recording)


def wave_recorder(eng, steps, prompts):
    """A wave engine's recorder: its prefill notes each row's left-padded
    prompt (appended to ``prompts``) and each lock-step decode appends
    every row's fed history, token and logits to ``steps``."""
    prefill, decode = eng._prefill, eng._decode
    fed = []

    def recording_prefill(p, c_, toks, **kw):
        fed[:] = [[int(t) for t in row] for row in toks.cpu().tolist()]
        prompts.extend(list(row) for row in fed)
        return prefill(p, c_, toks, **kw)

    def recording_decode(p, c_, cache, tok):
        live = {i: list(h) for i, h in enumerate(fed)}
        logits, cache = decode(p, c_, cache, tok)
        toks = tok.cpu().tolist()
        steps.append((live, toks, logits.float().cpu()))
        for i, t in enumerate(toks):
            fed[i].append(int(t[0]))
        return logits, cache

    eng._prefill, eng._decode = recording_prefill, recording_decode


def by_history(steps):
    """Each recorded logit row keyed by the tokens fed up to it."""
    out = {}
    for live, toks, logits in steps:
        for i, hist in live.items():
            for j in range(len(toks[i])):
                out[tuple(hist + toks[i][: j + 1])] = logits[i, j]
    return out


def phase_consistency(n_layers: int):
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import dense, registry
    from repro_torch.serving import DisaggEngineExecutor, Engine, GenRequest
    cfg = get_config("qwen3-8b").replace(dtype="float32", n_layers=n_layers)
    qcfg = cfg.replace(kv_quant=True)
    t0 = time.perf_counter()
    params = dense.init(cfg, torch.Generator("cuda").manual_seed(7), "cuda")
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"  {cfg.name} x{cfg.n_layers} layers fp32: {gb:.1f} GB of weights "
        f"in {time.perf_counter() - t0:.1f}s")
    kit = Consistency(cfg, params)
    fresh, held, worst = kit.fresh, kit.held, kit.worst
    rng = torch.Generator().manual_seed(0)

    def tokens(n):
        return torch.randint(2, cfg.vocab_size, (n,), generator=rng).numpy() \
            .astype("int32")

    prompts = [tokens(n) for n in (24, 11)]

    def serve(c, waves, warm=None, **kw):
        """Serve ``waves`` (lists of prompts, one wave after the other) on
        one engine; returns the requests, the decode or verify steps' live
        rows, tokens and logits, and the engine.  With ``warm`` (a list),
        each warm prefill's rows are appended to it with their logits."""
        eng = Engine(c, params, max_batch=4, bucket=32, **kw)
        steps = []
        attr = ("_verify" if "spec_draft" in kw else
                "_decode_paged" if kw.get("paged") else "_decode")
        recorder(eng, attr, steps)
        if warm is not None:
            orig_warm = eng._prefill_warm

            def warm_recording(rows, hits):
                orig_warm(rows, hits)
                # a copy: the carried logits are overwritten in place
                warm.extend(([int(t) for t in r.tokens],
                             eng._logits[i, 0].float().cpu().clone())
                            for i, r in rows)

            eng._prefill_warm = warm_recording
        reqs = []
        for w, wave in enumerate(waves):
            batch = [GenRequest(rid=f"c{w}.{i}", max_new=8, tokens=p)
                     for i, p in enumerate(wave)]
            eng.serve(batch)
            reqs += batch
        return reqs, steps, eng

    results = {}
    records = {}
    for mode, c, kw in (
            ("paged", cfg, dict(paged=True)), ("slot", cfg, {}),
            ("spec", cfg, dict(paged=True, spec_draft=(cfg, params),
                               spec_k=SPEC_K)),
            ("int8 paged", qcfg, dict(paged=True)), ("int8 slot", qcfg, {}),
            ("int8 spec", qcfg, dict(paged=True, spec_draft=(qcfg, params),
                                     spec_k=SPEC_K))):
        reqs, steps, _ = serve(c, [prompts], **kw)
        results[mode] = [r.result.tolist() for r in reqs]
        records[mode] = by_history(steps)
        if c.kv_quant:
            if mode == "int8 paged":
                log(f"  {mode}: {sum(len(t) for t in results[mode])} "
                    f"tokens, {len(steps)} decode steps recorded")
                continue
            # int8 slot decode and int8 verify attend the same quantized
            # values as int8 paged decode: held to its logits
            n = 0
            for key, got in records[mode].items():
                want = records["int8 paged"].get(key)
                if want is not None:
                    held(mode, got, want, f"{mode} after {len(key)} tokens")
                    n += 1
            if n < 8:
                raise AssertionError(f"{mode}: only {n} logit rows shared "
                                     f"a history with int8 paged decode")
            log(f"  {mode}: {n} logit rows held to int8 paged decode's: "
                f"worst |diff| / max|logit| = {worst[mode]:.2e} (limit "
                f"1e-3)")
            continue
        kit.hold_history(mode, steps)
        kit.hold_greedy(mode, [(r.rid, r.tokens, r.result) for r in reqs])
        log(f"  {mode}: {sum(len(t) for t in results[mode])} tokens; "
            f"{len(steps)} {'verify' if 'spec' in mode else 'decode'} "
            f"steps held to fresh prefills: worst |diff| / max|logit| = "
            f"{worst[mode]:.2e} (limit 1e-3)")
    if not results["paged"] == results["slot"] == results["spec"]:
        raise AssertionError(f"greedy streams differ: {results}")
    log("  paged, slot and agreeing-spec greedy tokens identical")

    # the disaggregated pair over the same params: the prefill engine's
    # first decode and every decode-engine step held to fresh prefills,
    # and its greedy tokens identical to the paged engine's
    pair = DisaggEngineExecutor(
        Engine(cfg, params, max_batch=4, bucket=32, paged=True),
        Engine(cfg, params, max_batch=4, bucket=32, seed=1000, paged=True))
    side_steps = {"prefill": [], "decode": []}
    for side, steps in side_steps.items():
        recorder(getattr(pair, side), "_decode_paged", steps)
    reqs = [GenRequest(rid=f"d{i}", max_new=8, tokens=p)
            for i, p in enumerate(prompts)]
    pair.bind(None, lambda r, started, first: None)
    pending = list(reqs)
    while pending or pair.has_work():
        while pending and pair.admit(pending[0]):
            pending.pop(0)
        pair.step()
    results["disagg"] = [r.result.tolist() for r in reqs]
    for side, steps in side_steps.items():
        kit.hold_history(f"disagg {side}", steps)
    if results["disagg"] != results["paged"]:
        raise AssertionError(f"disagg greedy tokens differ from paged: "
                             f"{results['disagg']} != {results['paged']}")
    st = pair.engine_stats()
    if not side_steps["decode"] or st.handoffs < len(reqs):
        raise AssertionError(f"disagg pair: {st.handoffs} handoffs, "
                             f"{len(side_steps['decode'])} decode steps")
    log(f"  disagg: {st.handoffs} handoffs ({st.handoff_bytes} B), tokens "
        f"identical to paged; {len(side_steps['prefill'])} prefill-side and "
        f"{len(side_steps['decode'])} decode-side steps held to fresh "
        f"prefills: worst |diff| / max|logit| = prefill side "
        f"{worst.get('disagg prefill', 0.0):.2e}, decode side "
        f"{worst['disagg decode']:.2e} (limit 1e-3)")
    del pair

    # the full-sequence forward at every position of one served sequence,
    # and the sequence's log-likelihood (the duel judges' logprob_of)
    seq = [int(t) for t in prompts[0]] + results["paged"][0]
    full = registry.apply_logits(params, cfg, {"tokens": torch.tensor(
        [seq[:-1]], device="cuda")})[0].float().cpu()
    gold = []
    for t in range(len(seq) - 1):
        want = fresh(seq[: t + 1])
        held("apply_logits", full[t], want,
             f"apply_logits at position {t}")
        gold.append(float(torch.log_softmax(want.double(), -1)[seq[t + 1]]))
    lp = Engine(cfg, params, max_batch=4, bucket=32).logprob_of(
        np.asarray(seq, np.int32))
    want_lp = sum(gold)
    rel = abs(lp - want_lp) / abs(want_lp)
    worst["logprob_of"] = rel
    if rel > 1e-3:
        raise AssertionError(f"logprob_of {lp} != {want_lp} from fresh "
                             f"prefills (relative {rel:.2e} > 1e-3)")
    log(f"  apply_logits at all {len(seq) - 1} positions of a "
        f"{len(seq)}-token sequence held to fresh prefills: worst |diff| / "
        f"max|logit| = {worst['apply_logits']:.2e} (limit 1e-3); "
        f"logprob_of {lp:.6f} vs {want_lp:.6f} summed from fresh prefills "
        f"(relative {rel:.2e}, limit 1e-3)")
    if not (results["int8 paged"] == results["int8 slot"]
            == results["int8 spec"]):
        raise AssertionError(f"int8 greedy streams differ: {results}")
    log("  int8 paged, int8 slot and int8 agreeing-spec greedy tokens "
        "identical")

    # the prefix cache: two waves sharing a page-aligned 48-token prefix;
    # the second wave's warm prefill verifies its 23- and 30-token suffixes
    # (K = 32) over the 3 cached pages, and its logits and the decode
    # steps after it are held to fresh cold prefills of the same tokens
    prefix = tokens(48)
    waves = [[prefix], [prefix, prefix]]
    waves = [[np.concatenate([p, tokens(n)]) for p, n in zip(w, sizes)]
             for w, sizes in zip(waves, ((20,), (23, 30)))]
    warm = []
    _, steps, eng = serve(cfg, waves, warm=warm, paged=True,
                          prefix_cache=True)
    if eng.prefix_hit_tokens <= 0 or not warm:
        raise AssertionError(f"prefix engine never hit: "
                             f"{eng.prefix_hit_tokens} tokens")
    for toks, got in warm:
        held("prefix warm", got, fresh(toks),
             f"warm prefill of {len(toks)} tokens")
    kit.hold_history("prefix decode", steps)
    log(f"  prefix cache: {eng.prefix_hit_tokens} prompt tokens hit; warm "
        f"prefills of {[len(t) for t, _ in warm]} tokens held to fresh "
        f"prefills: worst |diff| / max|logit| = {worst['prefix warm']:.2e};"
        f" decode steps {worst['prefix decode']:.2e} (limit 1e-3)")
    return {"worst_rel_diff": worst}


# phase 3 at the dense variants, the moe, vlm, hybrid and ssm families:
# (arch, layers held (the rest cut for time or memory), backends, capacity
# factor, prompt lengths).  The moe checks lift the capacity factor to 8,
# as the reference's own prefill/decode test does: a prefill of S tokens
# can drop tokens that a one-token decode never drops, so only without
# drops are the two the same function.  recurrentgemma-9b keeps two groups
# and the two-layer recurrent tail (8 of 38 layers), and one prompt longer
# than its 2048-token window, so that the prefill's window masks keys and
# the decode ring wraps.  xlstm-1.3b's 150-token prompt pads the wave to
# 160 positions: two full 64-position chunks and a padded third
ARCH_CONSISTENCY = (
    ("starcoder2-7b", 32, ("slot", "paged", "spec"), None, (24, 11)),
    ("qwen3-32b", 8, ("slot", "paged"), None, (24, 11)),
    ("command-r-plus-104b", 4, ("paged", "spec"), None, (24, 11)),
    ("granite-moe-1b-a400m", 24, ("wave",), 8.0, (24, 11)),
    ("dbrx-132b", 2, ("wave",), 8.0, (24, 11)),
    ("qwen2-vl-7b", 28, ("slot", "paged", "spec"), None, (24, 11)),
    ("recurrentgemma-9b", 8, ("wave",), None, (2100, 11)),
    ("xlstm-1.3b", 48, ("wave",), None, (150, 11)),
)
_SCALES = ("scale", "q_norm", "k_norm")
_BIASES = ("bias", "bq", "bk", "bv", "bo", "b_up", "b_down", "conv_b")


def perturb(params, seed: int):
    """Move every norm scale (+ N(0, 0.2)), norm bias and bias (N(0, 0.1))
    off its start, in place, from a seeded generator: the port's init
    starts biases at zero and scales at one, where a bias dropped or added
    in the wrong place would not show.  Returns ``params``."""
    import torch
    g = torch.Generator("cuda").manual_seed(seed)

    def walk(tree):
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, dict):
                walk(v)
            elif k in _SCALES or k in _BIASES:
                sd = 0.2 if k in _SCALES else 0.1
                v.add_(torch.randn(v.shape, generator=g, device=v.device)
                       .to(v.dtype), alpha=sd)

    walk(params)
    return params


def _free():
    import gc
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def phase_arch_consistency(arch, n_layers, backends, capacity_factor,
                           prompt_lens):
    """[3, dense variants, moe, vlm, hybrid and ssm] ``arch`` at full width,
    ``n_layers`` layers, float32, on the port's seeded init with its biases
    and norms perturbed: two requests of ``prompt_lens`` tokens served on
    each of ``backends`` (slot, paged, spec with ``cfg.draft()``, or a wave
    engine), every decode, verify or wave-decode logit row held to a fresh
    prefill over the same tokens (a wave row's with its left pads) within
    1e-3 x max|logit|, each emitted token the greedy choice of a fresh
    prefill, and the tokens identical across the backends.  For the vlm
    family also ``mrope_on_card``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving import Engine, GenRequest
    cfg = get_config(arch).replace(dtype="float32", n_layers=n_layers)
    if capacity_factor is not None:
        cfg = cfg.replace(capacity_factor=capacity_factor)
    t0 = time.perf_counter()
    params = perturb(registry.init(cfg, torch.Generator("cuda").manual_seed(
        7), "cuda"), 8)
    torch.cuda.synchronize()
    gb = sum(t.numel() * t.element_size() for t in _leaves(params)) / 1e9
    log(f"  {cfg.name}: {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers, fp32, {cfg.n_heads}/{cfg.n_kv_heads} heads at D="
        f"{cfg.head_dim}: {gb:.1f} GB of weights in "
        f"{time.perf_counter() - t0:.1f}s"
        + (f"; capacity factor {capacity_factor}" if capacity_factor else ""))
    kit = Consistency(cfg, params)
    rng = torch.Generator().manual_seed(0)
    prompts = [torch.randint(2, cfg.vocab_size, (n,), generator=rng).numpy()
               .astype("int32") for n in prompt_lens]
    results = {}
    for backend in backends:
        kw = {"paged": dict(paged=True), "slot": {}, "wave": {},
              "spec": dict(paged=True, spec_k=SPEC_K)}[backend]
        if backend == "spec":
            dcfg = cfg.draft()
            kw["spec_draft"] = (dcfg, perturb(registry.init(
                dcfg, torch.Generator("cuda").manual_seed(10_000), "cuda"),
                9))
        eng = Engine(cfg, params, max_batch=4, bucket=32, **kw)
        steps, fed = [], []
        if backend == "wave":
            if eng.slot_decode:
                raise AssertionError(f"{arch}: not a wave engine")
            wave_recorder(eng, steps, fed)
        else:
            recorder(eng, {"paged": "_decode_paged", "slot": "_decode",
                           "spec": "_verify"}[backend], steps)
        reqs = [GenRequest(rid=f"c{i}", max_new=8, tokens=p)
                for i, p in enumerate(prompts)]
        eng.serve(reqs)
        results[backend] = [r.result.tolist() for r in reqs]
        n = kit.hold_history(backend, steps)
        kit.hold_greedy(backend, [
            (r.rid, fed[i] if fed else r.tokens, r.result)
            for i, r in enumerate(reqs)])
        log(f"  {arch} {backend}: {sum(len(t) for t in results[backend])} "
            f"tokens; {len(steps)} {'verify' if backend == 'spec' else 'decode'}"
            f" steps, {n} logit rows held to fresh prefills: worst |diff| / "
            f"max|logit| = {kit.worst[backend]:.2e} (limit 1e-3)"
            + (f"; accepted {eng.stats.spec_accepted}/"
               f"{eng.stats.spec_drafted} drafts" if backend == "spec"
               else ""))
        del eng, kw
    if any(t != results[backends[0]] for t in results.values()):
        raise AssertionError(f"{arch}: greedy streams differ: {results}")
    log(f"  {arch}: greedy tokens identical across {', '.join(backends)}")
    out = dict(layers=n_layers, backends=list(backends),
               prompt_lens=list(prompt_lens),
               worst_rel_diff=dict(kit.worst))
    if cfg.mrope:
        out["mrope_rel_diff"] = mrope_on_card(cfg, params)
    return out


def mrope_on_card(cfg, params) -> float:
    """[3, vlm] ``dense.apply`` on embeddings at distinct (t, h, w) ids (a
    text run, then a patch grid, as Qwen2-VL lays an image out) through
    the prefill kernel, held to the same call with ``ops.attention`` on its
    plain version within 1e-3 x max|logit|: the serve paths broadcast one
    id to all three axes, where M-RoPE is plain RoPE, so only this call
    can show an M-RoPE fault on the card.  Arange ids must give other
    logits.  Returns the |diff| / max|logit|."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.ref import flash_ref
    from repro_torch.models import dense
    s, text = 96, 16
    g = torch.Generator("cuda").manual_seed(11)
    embeds = 0.5 * torch.randn((1, s, cfg.d_model), generator=g,
                               device="cuda")
    pos = torch.zeros((1, s, 3), dtype=torch.long, device="cuda")
    pos[0, :text] = torch.arange(text, device="cuda")[:, None]
    grid = torch.arange(s - text, device="cuda")
    pos[0, text:, 0] = text
    pos[0, text:, 1] = text + grid // 8
    pos[0, text:, 2] = text + grid % 8
    batch = {"embeds": embeds, "positions": pos}
    before = ops.launch_counts()["flash_attention"]
    got = dense.apply(params, cfg, batch).float()
    torch.cuda.synchronize()
    launched = ops.launch_counts()["flash_attention"] - before
    if launched != cfg.n_layers:
        raise AssertionError(f"M-RoPE apply launched the prefill kernel "
                             f"{launched} times for {cfg.n_layers} layers")
    kernel = ops.attention
    ops.attention = flash_ref
    try:
        want = dense.apply(params, cfg, batch).float()
        arange = dense.apply(params, cfg, {"embeds": embeds}).float()
    finally:
        ops.attention = kernel
    scale = float(want.abs().max())
    rel = float((got - want).abs().max()) / scale
    moved = float((arange - want).abs().max()) / scale
    log(f"  M-RoPE on embeddings at distinct (t, h, w) ids, {cfg.n_layers} "
        f"layers: |kernel - plain| / max|logit| = {rel:.2e} (limit 1e-3); "
        f"arange ids move the logits by {moved:.2e} of max|logit|")
    if rel > 1e-3:
        raise AssertionError(f"M-RoPE through the kernels: {rel:.3e} > 1e-3")
    if moved < 1e-2:
        raise AssertionError(f"distinct ids changed the logits by only "
                             f"{moved:.3e}")
    return rel


def phase_whisper_consistency(steps: int = 8) -> dict:
    """[3, audio] whisper-base at full width (6 encoder and 6 decoder
    layers), float32, on the port's seeded init with its biases and norms
    perturbed: ``prefill`` of two 16-token prompts over 1500 seeded frames,
    then ``steps`` greedy ``decode_step``s; the prefill's and every step's
    logits held to ``apply`` over the same frames and tokens within 1e-3 x
    max|logit| (the ring holds every position, so the two compute the
    same function)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    from repro_torch.serving.sampling import masked_logits
    cfg = get_config("whisper-base").replace(dtype="float32")
    fam = registry.get_family(cfg)
    params = perturb(registry.init(cfg, torch.Generator("cuda").manual_seed(
        7), "cuda"), 8)
    g = torch.Generator("cuda").manual_seed(9)
    emb = torch.randn((2, WHISPER_FRAMES, cfg.d_model), generator=g,
                      device="cuda")
    seq = torch.randint(2, cfg.vocab_size, (2, 16), generator=g,
                        device="cuda")
    kit = Consistency(cfg, params)
    logits, cache = fam.prefill(params, cfg, {"encoder_embeds": emb,
                                              "tokens": seq},
                                capacity=seq.shape[1] + steps)
    for t in range(steps + 1):
        want = fam.apply(params, cfg, {"encoder_embeds": emb,
                                       "tokens": seq})[:, -1]
        kit.held("whisper", logits[:, -1].float().cpu(), want.float().cpu(),
                 f"whisper after {seq.shape[1]} tokens")
        if t == steps:
            break
        nt = torch.argmax(masked_logits(logits[:, -1], cfg.vocab_size),
                          dim=-1)[:, None]
        seq = torch.cat([seq, nt], dim=1)
        logits, cache = fam.decode_step(params, cfg, cache, nt)
    log(f"  whisper-base fp32, {cfg.n_encoder_layers}+{cfg.n_layers} "
        f"layers, B=2 over {WHISPER_FRAMES} frames: prefill and {steps} "
        f"decode steps held to apply: worst |diff| / max|logit| = "
        f"{kit.worst['whisper']:.2e} (limit 1e-3)")
    return dict(steps=steps, worst_rel_diff=kit.worst["whisper"])


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


# ------------------------------------------------------------ phase 4
def recording_ops(ops, seen, widths, heads=None):
    """Wrap the attention entry points the model calls so that each call
    also notes what it was given: the prefill's (q shape, causal, window,
    key positions);
    once per decode or verify step (one lengths tensor serves all layers) a
    host copy of its shapes, table and lengths; every call's head width in
    ``widths``, and with ``heads`` every call's (kernel, H, Hkv, D).
    Returns a function that puts the originals back."""
    orig = {n: getattr(ops, n) for n in KERNEL_OPS.values()}
    last = [None]
    heads = collections.Counter() if heads is None else heads

    def step(key, lengths, *record):
        if lengths is not last[0]:
            last[0] = lengths
            seen[key].append(tuple(record) + (lengths.cpu().numpy(),))

    def att(q, k, v, *, causal=True, window=None):
        widths["flash_attention", q.shape[3]] += 1
        heads["flash_attention", q.shape[2], k.shape[2], q.shape[3]] += 1
        seen["flash_attention"].append((tuple(q.shape), causal, window,
                                        k.shape[1]))
        return orig["attention"](q, k, v, causal=causal, window=window)

    def decode(q, k_cache, v_cache, lengths, *, window=None):
        widths["flash_decode", q.shape[3]] += 1
        heads["flash_decode", q.shape[2], k_cache.shape[2], q.shape[3]] += 1
        step("flash_decode", lengths, q.shape[3], k_cache.shape[1])
        return orig["decode"](q, k_cache, v_cache, lengths, window=window)

    def paged(kernel):
        # paged decode and verify, fp or int8: (q, *pools, tables, lengths)
        def call(q, *args):
            block_tables, lengths = args[-2:]
            widths[kernel, q.shape[3]] += 1
            heads[kernel, q.shape[2], args[0].shape[2], q.shape[3]] += 1
            record = (() if kernel.startswith("paged_decode")
                      else (q.shape[1],))
            step(kernel, lengths, *record, block_tables.cpu().numpy())
            return orig[KERNEL_OPS[kernel]](q, *args)
        return call

    wrapped = {"attention": att, "decode": decode}
    for kernel in ("paged_decode", "paged_verify", "paged_decode_int8",
                   "paged_verify_int8"):
        wrapped[KERNEL_OPS[kernel]] = paged(kernel)
    for name, fn in wrapped.items():
        setattr(ops, name, fn)

    def restore():
        for n, fn in orig.items():
            setattr(ops, n, fn)
    return restore


def _seen():
    return {k: [] for k in KERNEL_OPS}


def check_launches(label, launches, widths, phase):
    """Each kernel's launch count equals the calls its entry point saw, and
    every (kernel, width) of the phase's path launched."""
    log(f"  launches on the {label} path: {launches}; by (kernel, head "
        f"width): {dict(widths)}")
    for kernel, n in launches.items():
        if n != sum(c for (k, _), c in widths.items() if k == kernel):
            raise AssertionError(f"{kernel}: {n} launches but "
                                 f"{dict(widths)} calls")
    missing = sorted(f"{k}@{d}" for k, d in PATHS[phase] if widths[k, d] < 1)
    if missing:
        raise AssertionError(f"kernels of the {label} path never launched: "
                             f"{missing}")


def phase_cfg(phase):
    """The bf16 config a serve phase runs (``PHASE_ARCH``'s layers)."""
    from repro_torch.configs import get_config
    arch, layers, _ = PHASE_ARCH.get(phase, ("qwen3-8b", None, False))
    cfg = get_config(arch)
    return cfg.replace(dtype="bfloat16", n_layers=layers or cfg.n_layers)


def phase_serve(phase, params, first=None):
    """Serve the scenario on ``PHASE_MODE[phase]`` engines with the
    per-node ``params``; check every request's tokens and that every kernel
    entry of the phase launched; print step times and rerun under the
    profiler."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    mode, quant = PHASE_MODE[phase]
    cfg = phase_cfg(phase).replace(kv_quant=quant)
    dev = torch.device("cuda")
    kw = dict(nodes=2, requests=8, max_new=8, seed=0, device=dev, mode=mode,
              spec_k=SPEC_K, params_fn=lambda i, c, d: params[i])
    seen = _seen()
    widths = collections.Counter()
    heads = collections.Counter()
    handoffs = []
    restore = recording_ops(ops, seen, widths, heads)
    unrecord = recording_handoffs(handoffs)
    try:
        ops.reset_launch_counts()
        out = serve.run(cfg, **kw)
        launches = ops.launch_counts()
        merges = ops.merge_launches()
    finally:
        restore()
        unrecord()
    wave = cfg.family in ("moe", "hybrid", "ssm")
    label = ("int8 " if quant else "") + ("wave" if wave else mode)
    check_launches(label, launches, widths, phase)
    if not PATHS[phase] and (any(launches.values()) or merges):
        raise AssertionError(f"the {label} path of {cfg.name} launched "
                             f"port kernels: {launches}, {merges} merges")
    log(f"  calls by (kernel, H, Hkv, D): "
        f"{ {'/'.join(map(str, k)): n for k, n in heads.items()} }")
    seen["heads"] = heads
    mine = {e: widths[k, d] for e, (k, d, _) in ENTRIES.items()
            if (k, d) in PATHS[phase]}
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
    # its floor is the weights' bytes over the memory rate; an xLSTM step
    # also reads and writes its recurrent state (max_batch 4 rows)
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params[0]))
    sbytes = 2 * 4 * ssm_state_bytes(cfg) if cfg.family == "ssm" else 0
    floor_ms = (wbytes + sbytes) / HBM_BYTES_PER_S * 1e3
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
        if mode == "disagg":
            steps[nid].update(handoffs=st.handoffs,
                              handoff_mb=st.handoff_bytes / 1e6)
            line += (f"; {st.handoffs} KV handoffs "
                     f"({st.handoff_bytes / 1e6:.3f} MB)")
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
            f"{total} (bf16: verify and decode GEMMs may round differently"
            f"{', and int8 pages hold other values' if quant else ''}; "
            f"exact equality is held in fp32 in phase 3)")
    if mode == "disagg":
        extra["handoffs"] = check_handoffs(out, handoffs)
    profile = profile_rerun(lambda: serve.run(cfg, verbose=False, **kw), out)
    if mode == "disagg":
        extra["trace"] = traced_rerun(serve, cfg, kw)
    log(f"serve_profile_{phase} " + json.dumps(dict(
        mode=label, steps=steps, weights_gb=wbytes / 1e9,
        state_gb=sbytes / 1e9, step_floor_ms=floor_ms,
        tok_per_s=out["tok_per_s"],
        wall_s=out["wall_s"], launches=launches,
        launches_by_width={f"{k}@{d}": n for (k, d), n in widths.items()},
        launches_by_heads={"/".join(map(str, k)): n
                           for k, n in heads.items()},
        config=dict(arch=cfg.name, layers=cfg.n_layers,
                    heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]),
        **extra, **profile)))
    return out, mine, seen


def ssm_state_bytes(cfg) -> int:
    """Bytes of one row's xLSTM decode state: each mLSTM block's C (H, dh,
    dh), n (H, dh) and m (H) in float32 and its conv window (cw - 1, ud)
    in the model's dtype; each sLSTM block's c, n, m, h (d) in float32."""
    import torch
    from repro_torch.models import xlstm
    n_groups, tail = xlstm.group_structure(cfg)
    kinds = list(xlstm.block_pattern(cfg)) * n_groups + list(tail)
    ud, h = xlstm._ud(cfg), cfg.n_heads
    dh = ud // h
    elem = torch.finfo(getattr(torch, cfg.dtype)).bits // 8
    m = 4 * h * (dh * dh + dh + 1) + elem * (cfg.conv_width - 1) * ud
    return kinds.count("m") * m + kinds.count("s") * 4 * 4 * cfg.d_model


def phase_serve_arch(phase):
    """[4h-4n] Seed the phase's weights (``PHASE_ARCH``: one set per node,
    or one shared; biases and norms perturbed), print its config and cut,
    serve it (``phase_serve``) and free the weights."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = phase_cfg(phase)
    arch, _, shared = PHASE_ARCH[phase]
    dev = torch.device("cuda")
    params = [perturb(serve.seeded_params(i, cfg, dev), 20 + i)
              for i in range(1 if shared else 2)]
    if shared:
        params = params * 2
    gb = sum(t.numel() * t.element_size() for t in _leaves(params[0])) / 1e9
    log(f"  {cfg.name}: {cfg.n_layers} of {get_config(arch).n_layers} "
        f"layers, bf16, {cfg.n_heads}/{cfg.n_kv_heads} heads at D="
        f"{cfg.head_dim}, {gb:.1f} GB of weights "
        f"{'shared by both nodes' if shared else 'per node'}")
    _, launches, seen = phase_serve(phase, params)
    del params
    _free()
    return launches, seen


def phase_whisper():
    """[4o] whisper-base, full width, bf16, seeded and perturbed, through
    the family interface (the driver's wave path passes no frames):
    ``registry`` ``prefill`` on B=4 seeded 1500-frame embeddings and
    32-token prompts, then 16 greedy ``decode_step``s.  Every row returns
    tokens in the vocabulary; each prefill launches row 1 at D=64 18 times
    (6 encoder, 6 decoder self, 6 cross layers) and each step row 4 at D=64
    12 times (6 self rings, 6 cross caches), each cross call also merging
    its splits; then the run again under the profiler."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.kernels.decode_split import decode_splits, target_blocks
    from repro_torch.models import registry
    from repro_torch.serving.sampling import masked_logits
    cfg = get_config("whisper-base").replace(dtype="bfloat16")
    fam = registry.get_family(cfg)
    params = perturb(registry.init(cfg, torch.Generator("cuda").manual_seed(
        20), "cuda"), 21)
    b, steps = 4, WHISPER_STEPS
    g = torch.Generator("cuda").manual_seed(30)
    batch = {"encoder_embeds": torch.randn(
        (b, WHISPER_FRAMES, cfg.d_model), generator=g, device="cuda").to(
            torch.bfloat16),
        "tokens": torch.randint(2, cfg.vocab_size, (b, WHISPER_PROMPT),
                                generator=g, device="cuda")}
    cap = WHISPER_PROMPT + steps

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = fam.prefill(params, cfg, batch, capacity=cap)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        out = []
        for _ in range(steps):
            nt = torch.argmax(masked_logits(logits[:, -1], cfg.vocab_size),
                              dim=-1)[:, None]
            out.append(nt)
            logits, cache = fam.decode_step(params, cfg, cache, nt)
        out.append(torch.argmax(masked_logits(logits[:, -1],
                                              cfg.vocab_size), dim=-1)[:, None])
        toks = torch.cat(out, dim=1).cpu().numpy()
        t2 = time.perf_counter()
        return dict(results={f"w{i}": toks[i] for i in range(b)},
                    wall_s=t2 - t0, prefill_s=t1 - t0, decode_s=t2 - t1)

    seen = _seen()
    widths, heads = collections.Counter(), collections.Counter()
    restore = recording_ops(ops, seen, widths, heads)
    try:
        ops.reset_launch_counts()
        out = run()
        launches, merges = ops.launch_counts(), ops.merge_launches()
    finally:
        restore()
    check_launches("whisper", launches, widths, "4o")
    seen["heads"] = heads
    split = decode_splits(b, cfg.n_kv_heads, WHISPER_FRAMES, target_blocks(
        cfg.head_dim))
    want = {("flash_attention", 64): cfg.n_encoder_layers + 2 * cfg.n_layers,
            ("flash_decode", 64): 2 * cfg.n_layers * steps}
    want_merges = cfg.n_layers * steps * (split > 1) + cfg.n_layers * steps \
        * (decode_splits(b, cfg.n_kv_heads, cap, target_blocks(64)) > 1)
    if dict(widths) != want or merges != want_merges or split < 2:
        raise AssertionError(f"whisper launches {dict(widths)}, {merges} "
                             f"merges; want {want}, {want_merges} merges "
                             f"(cross decode splits {split})")
    for rid, toks in out["results"].items():
        if not (len(toks) == steps + 1 and (toks >= 0).all()
                and (toks < cfg.vocab_size).all()):
            raise AssertionError(f"{rid}: bad tokens {toks}")
    wbytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    tokens = b * (steps + 1)
    log(f"  whisper-base bf16: {wbytes / 1e9:.2f} GB of weights; B={b} over "
        f"{WHISPER_FRAMES} frames, {WHISPER_PROMPT}-token prompts: {tokens} "
        f"tokens in {out['wall_s']:.3f}s ({tokens / out['wall_s']:.1f} "
        f"tok/s), prefill {out['prefill_s'] * 1e3:.2f} ms, "
        f"{steps} steps at {out['decode_s'] / steps * 1e3:.2f} ms; "
        f"launches {dict(widths)}, {merges} merges (cross decode "
        f"splits {split})")
    profile = profile_rerun(run, out)
    log("serve_profile_4o " + json.dumps(dict(
        mode="family interface", weights_gb=wbytes / 1e9,
        tok_per_s=tokens / out["wall_s"], wall_s=out["wall_s"],
        prefill_ms=out["prefill_s"] * 1e3,
        step_ms=out["decode_s"] / steps * 1e3, launches=launches,
        merges=merges, cross_splits=split,
        launches_by_width={f"{k}@{d}": n for (k, d), n in widths.items()},
        launches_by_heads={"/".join(map(str, k)): n
                           for k, n in heads.items()},
        config=dict(arch=cfg.name, layers=[cfg.n_encoder_layers,
                                           cfg.n_layers],
                    heads=[cfg.n_heads, cfg.n_kv_heads, cfg.head_dim]),
        **profile)))
    mine = {e: widths[k, d] for e, (k, d, _) in ENTRIES.items()
            if (k, d) in PATHS["4o"]}
    del params
    _free()
    return mine, seen


def phase_arch_shapes(seen) -> dict:
    """[5, phases 4h-4o] Each kernel of a new serve phase's path against
    its plain version at the shapes and head ratio that phase gave it
    (bfloat16): the most frequent prefill shape and the decode or verify
    step of median attended length."""
    out = {}
    for phase in [*PHASE_ARCH, "4o"]:
        heads = {(k, d): (h, hkv, d) for k, h, hkv, d in seen[phase]["heads"]}
        for kernel, d in sorted(PATHS[phase]):
            hd = heads[kernel, d]
            if kernel == "flash_attention":
                (b, s, _, _), causal, window, skv = _most_common_prefill(
                    seen[phase][kernel], d)
                r = prefill_case("main", b, s, "bfloat16", heads=hd,
                                 causal=causal, window=window, skv=skv,
                                 iters=100)
            elif kernel == "flash_decode":
                _, s, ln = _median([st for st in seen[phase][kernel]
                                    if st[0] == d],
                                   f"D={d} decode (phase {phase})")
                r = decode_case("main", s, [int(x) for x in ln], "bfloat16",
                                heads=hd, iters=100)
            elif kernel == "paged_decode":
                bt, ln = _median(seen[phase][kernel],
                                 f"paged decode (phase {phase})")
                r = paged_case("main", _dense_pages(bt), [int(x) for x in ln],
                               "bfloat16", iters=100, heads=hd)
            else:
                kq, bt, ln = _median(seen[phase][kernel],
                                     f"{kernel} (phase {phase})")
                r = verify_case("main", _dense_pages(bt),
                                [int(x) for x in ln], kq, "bfloat16",
                                iters=100, heads=hd)
            r = dict(with_ratios(r), phase=phase, heads=list(hd))
            show(f"{kernel}@{d} {phase}", r)
            out.setdefault(phase, {})[f"{kernel}@{d}"] = r
    log("arch_main_cases " + json.dumps(out))
    return out


def recording_handoffs(handoffs):
    """Note every KV handoff the engines extract (request, length, cached
    tokens, bytes) in ``handoffs``; returns a function that puts
    ``Engine.extract_handoffs`` back."""
    from repro_torch.serving import Engine
    orig = Engine.extract_handoffs

    def extract(self, cached_tokens_fn=None):
        out = orig(self, cached_tokens_fn)
        handoffs.extend(dict(rid=h.req.rid, length=h.length,
                             cached_tokens=h.cached_tokens,
                             kv_bytes=h.kv_bytes, who=self.owner)
                        for h in out)
        return out

    Engine.extract_handoffs = extract

    def restore():
        Engine.extract_handoffs = orig
    return restore


def check_handoffs(out, handoffs) -> dict:
    """[4g] Each node handed off at least every request that decoded past
    its first token (those cannot have finished on the prefill side), and
    every handoff carries ``_KV_BYTES_PER_TOKEN`` bytes per valid token
    (qwen3-8b bf16: 2 x 36 layers x 8 kv heads x 128 x 2 bytes), the
    prompt and the first token at least."""
    from repro_torch.sim.servicemodel import _KV_BYTES_PER_TOKEN
    by_node = collections.Counter(h["who"] for h in handoffs)
    for nid, st in out["stats"].items():
        decoded = sum(1 for rid in out["assigned"][nid]
                      if len(out["results"][rid]) > 1)
        if not (st.handoffs == by_node[nid] >= decoded):
            raise AssertionError(f"{nid}: {st.handoffs} handoffs counted, "
                                 f"{by_node[nid]} recorded, {decoded} "
                                 f"requests decoded past their first token")
    for h in handoffs:
        if h["cached_tokens"] or h["length"] < 25 or \
                h["kv_bytes"] != _KV_BYTES_PER_TOKEN * h["length"]:
            raise AssertionError(f"handoff {h}: expected "
                                 f"{_KV_BYTES_PER_TOKEN} B x length >= 25")
    nbytes = sum(h["kv_bytes"] for h in handoffs)
    lengths = sorted({h["length"] for h in handoffs})
    log(f"  {len(handoffs)} handoffs of {lengths} tokens, {nbytes} B in "
        f"all: {_KV_BYTES_PER_TOKEN} B per token each")
    return dict(count=len(handoffs), bytes=nbytes,
                bytes_per_token=_KV_BYTES_PER_TOKEN)


def traced_rerun(serve, cfg, kw) -> dict:
    """[4g] The scenario once more, untimed, with ``trace=`` a temporary
    file: the file must load with the sim-time and wall-time processes,
    each request's sim-clock stages must add up to its simulated latency
    within 1e-9 s, and one ``disagg.handoff`` event must be recorded per
    handoff."""
    import tempfile
    from repro_torch.obs import _SIM, latency_breakdown
    with tempfile.TemporaryDirectory() as tmp:
        path = pathlib.Path(tmp) / "trace.json"
        out = serve.run(cfg, verbose=False, trace=str(path), **kw)
        payload = json.loads(path.read_text())
    procs = {e["args"]["name"] for e in payload["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    if procs != {"sim-time", "wall-time"}:
        raise AssertionError(f"trace processes {procs}")
    spans = out["spans"]
    stages = latency_breakdown([s for s in spans if s.clock == _SIM])
    worst = 0.0
    for rid, latency in out["latency"].items():
        err = abs(sum(stages[rid]["stages"].values()) - latency)
        worst = max(worst, err)
        if err > 1e-9:
            raise AssertionError(f"{rid}: sim stages sum to "
                                 f"{sum(stages[rid]['stages'].values())} s, "
                                 f"latency {latency} s")
    events = sum(1 for s in spans
                 if s.name == "disagg.handoff" and s.clock != _SIM)
    handoffs = sum(st.handoffs for st in out["stats"].values())
    if events != handoffs:
        raise AssertionError(f"{events} disagg.handoff events for "
                             f"{handoffs} handoffs")
    log(f"  traced rerun: {len(spans)} spans, "
        f"{len(payload['traceEvents'])} trace events; sim stages "
        f"reconstruct all {len(out['latency'])} latencies (worst error "
        f"{worst:.1e} s); {events} disagg.handoff events for {handoffs} "
        f"handoffs")
    return dict(spans=len(spans), events=len(payload["traceEvents"]),
                worst_latency_error_s=worst, handoff_events=events)


def port_kernel_of(name: str):
    """The ops.KERNELS entry a profiled device kernel of a serve phase (all
    bf16) belongs to, read from its name ("merge" for
    decode_combine_kernel, which a split decode call of any decode entry
    launches after its kernel), or None for a kernel that is not the
    port's."""
    if "repro_torch" not in name:
        return None
    if "decode_combine_kernel" in name:
        return "merge"
    if "flash_wgmma_kernel" in name:
        return "flash_attention"
    if "verify_mma_kernel" in name:
        return "paged_verify_int8" if "Int8Pages" in name else "paged_verify"
    if "decode_mma_kernel" in name:
        if "ContiguousKv" in name:
            return "flash_decode"
        return "paged_decode_int8" if "DecodeInt8" in name else "paged_decode"
    raise AssertionError(f"a port kernel no bf16 entry point owns: {name}")


def profile_rerun(rerun, first, attempts: int = 4) -> dict:
    """Run the same scenario again (``rerun()`` returns its ``results`` and
    ``wall_s``) under ``torch.profiler`` and return the device's busy time
    over the replay, the kernels that take it, and each port kernel's
    device time and launches.  The launches the profiler saw of each port
    kernel are held to the host's counts of that rerun (``ops``' counters,
    zeroed just before it; the merges of split rows to
    ``ops.merge_launches()``): the profiler may drop records, and then the
    port kernels' times would be short.  On a mismatch the profiled rerun
    runs again, up to ``attempts`` in all; if none matches, the last one's
    times are kept and marked incomplete (``port_kernels_complete``), with
    both counts in ``port_launch_check``.  ``EDGE_SPINS`` spinning
    kernels on each side of the rerun take the records a session loses at
    its edges (phase 4o launches its first port kernel within the first
    milliseconds); they are left out of every sum."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    spins = spin_names()
    for attempt in range(1, attempts + 1):
        ops.reset_launch_counts()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(EDGE_SPINS):
                torch.cuda._sleep(EDGE_SPIN_CYCLES)
            again = rerun()
            for _ in range(EDGE_SPINS):
                torch.cuda._sleep(EDGE_SPIN_CYCLES)
            torch.cuda.synchronize()
        host = dict(ops.launch_counts(), merge=ops.merge_launches())
        kern = [e for e in prof.events() if e.device_type == DeviceType.CUDA
                and e.name not in spins]
        by_name, count = {}, collections.Counter()
        for e in kern:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us())
            count[e.name] += 1
        seen = collections.Counter()
        for name, n in count.items():
            kernel = port_kernel_of(name)
            if kernel is not None:
                seen[kernel] += n
        check = {k: dict(host_launches=host.get(k, 0),
                         profiler_launches=seen.get(k, 0))
                 for k in sorted(set(host) | set(seen))
                 if host.get(k, 0) or seen.get(k, 0)}
        complete = bool(kern) and all(
            c["host_launches"] == c["profiler_launches"]
            for c in check.values())
        if complete:
            break
        log(f"  profiled rerun {attempt} of {attempts}: the profiler's port "
            f"kernel launches differ from the host's: "
            + ", ".join(f"{k} {c['profiler_launches']} of "
                        f"{c['host_launches']}" for k, c in check.items()
                        if c["host_launches"] != c["profiler_launches"]))
    same = all((again["results"][r] == t).all() if len(t) == len(
        again["results"][r]) else False for r, t in first["results"].items())
    if not kern:
        log("  profiler saw no device activity: busy share not measured")
        return dict(busy_share=None, same_tokens=same,
                    port_kernels_complete=False, profile_attempts=attempt,
                    port_launch_check=check)
    busy_ms = sum(by_name.values()) / 1e3
    wall_ms = again["wall_s"] * 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    log(f"  profiled rerun (same tokens: {same}): device busy {busy_ms:.1f} "
        f"ms of {wall_ms:.1f} ms replay wall ({busy_ms / wall_ms:.1%}), "
        f"{len(kern)} kernel launches")
    for name, us in top:
        log(f"    {us / 1e3:9.2f} ms  {name[:90]}")
    # the port's own kernels, each with its launches in the replay
    port = {n[:160]: dict(ms=us / 1e3, launches=count[n],
                          kernel=port_kernel_of(n))
            for n, us in by_name.items() if port_kernel_of(n) is not None}
    for name, r in port.items():
        log(f"    port kernel {r['ms']:9.3f} ms in {r['launches']} launches"
            f"  {name}")
    log(f"  port kernel times {'complete' if complete else 'INCOMPLETE'} "
        f"after {attempt} profiled rerun(s): profiler / host launches "
        + ", ".join(f"{k} {c['profiler_launches']}/{c['host_launches']}"
                    for k, c in check.items()))
    return dict(busy_ms=busy_ms, profiled_wall_ms=wall_ms,
                busy_share=busy_ms / wall_ms, kernel_launches=len(kern),
                top_kernels_ms={n[:90]: us / 1e3 for n, us in top},
                port_kernels=port, port_kernels_complete=complete,
                profile_attempts=attempt, port_launch_check=check,
                same_tokens=same)


def phase_prefix(params):
    """[4f] The prefix cache on ``Engine(paged=True, prefix_cache=True)``,
    fp and int8 pages (full-width qwen3-8b, bf16, node 1's weights): a
    first wave of two requests sharing a page-aligned 48-token prefix
    registers its pages, and a second wave of four with 17-31 token
    suffixes must hit them, its warm prefill verifying K = 32 tokens per
    row over the 3 cached pages.  Launches are checked as in the serve
    phases; token equality with a cache-less engine is printed, not held
    (bf16: the warm prefill's verify and a cold prefill round
    differently)."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.serving import Engine, GenRequest
    base = get_config("qwen3-8b").replace(dtype="bfloat16")
    rng = np.random.default_rng(13)
    prefix = rng.integers(2, base.vocab_size, size=48)
    waves = [[np.concatenate([prefix, rng.integers(2, base.vocab_size,
                                                   size=n)]).astype(np.int32)
              for n in sizes] for sizes in ((20, 26), (17, 23, 29, 31))]

    def scenario(quant, prefix_cache=True):
        eng = Engine(base.replace(kv_quant=quant), params[0], max_batch=4,
                     bucket=32, paged=True, prefix_cache=prefix_cache)
        results = {}
        t0 = time.perf_counter()
        for w, wave in enumerate(waves):
            reqs = [GenRequest(rid=f"w{w}.{i}", tokens=p, max_new=8)
                    for i, p in enumerate(wave)]
            eng.serve(reqs)
            results.update({r.rid: r.result for r in reqs})
        torch.cuda.synchronize()
        return dict(results=results, wall_s=time.perf_counter() - t0,
                    engine=eng)

    def both():
        runs = {q: scenario(q) for q in (False, True)}
        return dict(results={f"{'int8 ' * q}{rid}": t for q, r in runs.items()
                             for rid, t in r["results"].items()},
                    wall_s=sum(r["wall_s"] for r in runs.values()),
                    runs=runs)

    seen, widths = _seen(), collections.Counter()
    restore = recording_ops(ops, seen, widths)
    try:
        ops.reset_launch_counts()
        out = both()
        launches = ops.launch_counts()
    finally:
        restore()
    check_launches("prefix-cache", launches, widths, "4f")
    for kernel in ("paged_verify", "paged_verify_int8"):
        ks = sorted({kq for kq, _, _ in seen[kernel]})
        if not ks or max(ks) <= 16:
            raise AssertionError(f"{kernel}: warm prefill verified K={ks}, "
                                 f"not more than 16 tokens")
        log(f"  {kernel}: warm prefill at K = {ks}")
    summary = {}
    for quant, run in out["runs"].items():
        eng, st = run["engine"], run["engine"].stats
        label = "int8" if quant else "fp"
        if eng.prefix_hit_tokens <= 0:
            raise AssertionError(f"{label} prefix engine never hit")
        for rid, toks in run["results"].items():
            if not (1 <= len(toks) <= 8 and (toks >= 0).all()
                    and (toks < base.vocab_size).all()):
                raise AssertionError(f"{label} {rid}: bad tokens {toks}")
        cold = scenario(quant, prefix_cache=False)["results"]
        same = sum(int(a == b) for rid, t in cold.items()
                   for a, b in zip(t.tolist(), run["results"][rid].tolist()))
        total = sum(len(t) for t in cold.values())
        summary[label] = dict(
            prefix_hit_tokens=eng.prefix_hit_tokens,
            prefix_lookup_tokens=eng.prefix_lookup_tokens,
            prefix_hit_rate=eng.prefix_hit_rate,
            prefill_batches=st.batches,
            prefill_ms=st.prefill_wall_s / max(1, st.batches) * 1e3,
            decode_steps=st.decode_steps,
            decode_ms=st.decode_wall_s / max(1, st.decode_steps) * 1e3,
            wall_s=run["wall_s"], tokens_equal_to_cold=same,
            tokens=total, pages=eng.debug_page_accounting())
        log(f"  {label}: {eng.prefix_hit_tokens} of "
            f"{eng.prefix_lookup_tokens} prompt tokens hit the cache; "
            f"{st.batches} prefill batches at "
            f"{summary[label]['prefill_ms']:.2f} ms, {st.decode_steps} decode"
            f" steps at {summary[label]['decode_ms']:.2f} ms; tokens equal to"
            f" a cache-less engine's: {same} of {total}; pages "
            f"{summary[label]['pages']}")
    profile = profile_rerun(both, out)
    log("serve_profile_4f " + json.dumps(dict(
        mode="prefix cache", engines=summary, launches=launches,
        launches_by_width={f"{k}@{d}": n for (k, d), n in widths.items()},
        **profile)))
    return launches, seen


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA card -- nothing to measure")
    from repro_torch.kernels import _build, ops   # needs the checkout's src/
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    t_all = time.perf_counter()
    logs = _build.build(force=True)
    build_s = time.perf_counter() - t_all

    def at() -> str:
        return f" (at {time.perf_counter() - t_all:.1f}s)"

    log(f"[1] built {list(_build.SOURCES)} in {build_s:.1f}s "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")
    ptxas = ptxas_report(logs, ("flash_wgmma_kernel", "verify_mma_kernel",
                                "decode_mma_kernel", "decode_combine_kernel",
                                "flash_fwd_kernel", "attend_kernel"))
    for name, r in ptxas.items():
        log(f"  ptxas {name}: {r}")
    check_no_spills(ptxas, NO_SPILLS)
    for name, counts in sass_check(_build.BUILD_DIR).items():
        log(f"  sass {name}: {counts}")
    log("[2] kernels vs their plain versions" + at())
    phase_kernels()
    log("[2, new head ratios] rows 1-4 at rep 9, 12, 8, 6, 7, D=64 rep 2 "
        "and rep 1 (whisper-base), D=256 rep 16" + at())
    phase_ratios()
    log("[3] model consistency: paged, slot and verify logits vs fresh "
        "prefills" + at())
    phase_consistency(n_layers=36)
    _free()
    for arch, n_layers, backends, cf, lens in ARCH_CONSISTENCY:
        log(f"[3, {arch}] {', '.join(backends)} logits vs fresh prefills"
            + at())
        phase_arch_consistency(arch, n_layers, backends, cf, lens)
        _free()
    log("[3, whisper-base] prefill and decode_step logits vs apply" + at())
    phase_whisper_consistency()
    _free()
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    cfg = get_config("qwen3-8b").replace(dtype="bfloat16")
    params = [serve.seeded_params(i, cfg, torch.device("cuda"))
              for i in range(2)]
    seen, launches = {}, {}
    log("[4] serve on paged engines" + at())
    paged_out, launches["4"], seen["4"] = phase_serve("4", params)
    log("[4b] serve on slot engines (the driver's default)" + at())
    _, launches["4b"], seen["4b"] = phase_serve("4b", params)
    log("[4c] serve on speculative paged engines, draft cfg.draft()"
        + at())
    _, launches["4c"], seen["4c"] = phase_serve("4c", params,
                                                first=paged_out)
    log("[4d] serve on int8 paged engines (--kv-quant)" + at())
    _, launches["4d"], seen["4d"] = phase_serve("4d", params,
                                                first=paged_out)
    log("[4e] serve on int8 speculative engines (--spec --kv-quant)"
        + at())
    _, launches["4e"], seen["4e"] = phase_serve("4e", params,
                                                first=paged_out)
    log("[4f] the prefix cache, fp and int8 pages" + at())
    launches_4f, seen["4f"] = phase_prefix(params)
    log("[4g] serve on disaggregated prefill/decode pairs (--disagg)"
        + at())
    _, launches["4g"], seen["4g"] = phase_serve("4g", params,
                                                first=paged_out)
    del params
    _free()
    for phase, title in (
            ("4h", "starcoder2-7b on paged engines (--paged)"),
            ("4i", "qwen3-32b on slot engines, one set of weights"),
            ("4j", "command-r-plus-104b on speculative engines (--spec), "
                   "one set of weights"),
            ("4k", "granite-moe-1b-a400m on wave engines"),
            ("4l", "qwen2-vl-7b on paged engines (--paged)"),
            ("4m", "recurrentgemma-9b on wave engines"),
            ("4n", "xlstm-1.3b on wave engines (no port kernel)")):
        log(f"[{phase}] serve {title}" + at())
        launches[phase], seen[phase] = phase_serve_arch(phase)
    log("[4o] whisper-base through the family interface" + at())
    launches["4o"], seen["4o"] = phase_whisper()
    log("[5] kernels vs their plain versions at the serve phases' shapes"
        + at())
    main_cases = phase_main_shapes(seen)
    arch_cases = phase_arch_shapes(seen)
    kernels = []
    for entry, (kernel, d, phase) in ENTRIES.items():
        meta = ops.KERNELS[kernel]
        # an entry of a new config's serve phase: read at that phase's shapes
        r = (main_cases[entry] if entry in main_cases
             else arch_cases[phase][f"{kernel}@{d}"])
        kernels.append(dict(
            name=entry, route="cuda", source=meta["source"],
            replaces=meta["replaces"], head_dim=d, phase=phase,
            launches=launches[phase][entry],
            launches_4f=launches_4f[kernel] if d == 128 else 0,
            launches_4g=launches["4g"].get(entry, 0),
            max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"],
            vs_library=r["vs_library"], bound_share=r["bound_share"],
            call_ms=r["call_ms"], timed_by=r["timed_by"], shape=r["shape"],
            dtype=r["dtype"],
            # the new configs' serve phases that run it, each with its
            # launches there and its times at that phase's shapes
            arch_phases={
                ph: dict(launches=launches[ph][entry],
                         **{k: cases[f"{kernel}@{d}"][k] for k in (
                             "heads", "shape", "max_abs_err", "ms",
                             "plain_ms", "library_ms", "bound_ms",
                             "bound_by", "vs_library", "bound_share")})
                for ph, cases in arch_cases.items()
                if f"{kernel}@{d}" in cases}))
    log(f"total {time.perf_counter() - t_all:.1f}s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
