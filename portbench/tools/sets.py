"""Repeated runs of one cell through its command, for the bounds and the
seeds: each run a process of its own, as the check makes them, with its
result line kept in a JSON-lines file; then each end-to-end metric's
spread in each set (the distance between the quartiles as a share of the
median) and the bound five times the widest spread would give.

    python portbench/tools/sets.py --workload cmdr-chat --seconds 45 \
        --seeds 11,12,13,14,15,16 --sets 2 --out sets.jsonl

``--trace 1`` makes the runs traced instead (per-layer metrics).
"""

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]


def spread(xs):
    q1, med, q3 = statistics.quantiles(xs, n=4)
    return (q3 - q1) / med


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", required=True)
    a = ap.parse_args()
    seeds = [int(s) for s in a.seeds.split(",")]
    out = pathlib.Path(a.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    for k in range(a.sets):
        for seed in seeds:
            t = time.perf_counter()
            p = subprocess.run(
                [sys.executable, str(ROOT / "portbench" / "run.py"),
                 "--workload", a.workload, "--seed", str(seed),
                 "--seconds", f"{a.seconds:g}", "--trace", str(a.trace)],
                cwd=ROOT, capture_output=True, text=True)
            wall = time.perf_counter() - t
            last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() \
                else ""
            row = {"set": k, "seed": seed, "rc": p.returncode,
                   "wall_s": wall, "result": json.loads(last) if last
                   .startswith("{") else None,
                   "stderr_tail": p.stderr[-1500:]}
            rows.append(row)
            with out.open("a") as f:
                f.write(json.dumps(row) + "\n")
            r = row["result"] or {}
            print(f"set {k} seed {seed} rc {p.returncode} wall {wall:.1f}s "
                  f"correct {r.get('correct')} "
                  + " ".join(f"{n}={v['value']:.6g}" for n, v in
                             r.get("metrics", {}).items())
                  + " " + " ".join(f"{n}={c['value']:.4g}/{c['limit']:g}"
                                   for n, c in r.get("checks", {}).items()),
                  flush=True)
            if p.returncode:
                print(p.stderr[-3000:], flush=True)
    ok = [r for r in rows if r["result"]]
    names = sorted({n for r in ok for n in r["result"]["metrics"]})
    for n in names:
        per_set = []
        for k in range(a.sets):
            xs = [r["result"]["metrics"][n]["value"] for r in ok
                  if r["set"] == k and n in r["result"]["metrics"]]
            if len(xs) >= 2:
                per_set.append((statistics.median(xs), spread(xs)))
        if per_set:
            widest = max(s for _, s in per_set)
            print(f"SPREAD {a.workload} {n}: " + ", ".join(
                f"median {m:.6g} spread {s:.4f}" for m, s in per_set)
                + f"; 5x widest {5 * widest:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
