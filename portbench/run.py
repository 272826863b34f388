"""Run one cell of the port's benchmark once, on the card, and print its
result as the last line of standard output.

    python portbench/run.py --workload cmdr-chat --seed 7 --seconds 45 \
        --trace 0

``--trace 0`` measures the cell's end-to-end metrics; ``--trace 1`` runs
the same traffic under ``torch.profiler`` slices spread over the window
and prints the cell's per-layer metrics, the device's busy time and the
breakdown.  Every run compares a sample of what it served with the plain
float32 reference and prints each number compared beside its limit, last
on standard error and last in the result line.  Without a card, with
fewer cards than the cell asks for, with a listed metric that has no
value, or with JAX or the JAX package loaded, it exits non-zero and
prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _line(o, device: dict, workload: str, seed: int) -> str:
    return json.dumps({
        "correct": o.correct, "attempted": o.attempted, "failed": o.failed,
        "metrics": o.metrics, "device": device,
        **({"breakdown": o.breakdown} if o.breakdown else {}),
        "workload": workload, "seed": seed, "notes": o.notes,
        "checks": o.checks})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python portbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    for p in (ROOT / "src", ROOT):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    os.environ.setdefault("USE_FLAX", "0")
    import torch
    from portbench.harness import cell
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = cell.spec_of(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs only on the card",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < spec.chips:
        print(f"{args.workload} needs {spec.chips} cards, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        o = cell.run(spec, args.seed, args.seconds, bool(args.trace), dev,
                     T_START)
    except cell.MissingMetric as e:
        print(str(e), file=sys.stderr)
        return 3
    bad = cell.forbidden_modules()
    if bad:
        print(f"loaded after the window: {bad} (JAX or the JAX package)",
              file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": spec.chips,
              "memory_peak_bytes": int(o.device["peak"]),
              **{k: o.device[k] for k in ("busy_s", "window_s")
                 if k in o.device}}
    for note in o.notes:
        print(f"note: {note}", file=sys.stderr)
    for name, c in o.checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(_line(o, device, args.workload, args.seed), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
