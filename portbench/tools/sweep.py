"""The rate sweep that finds a cell's knee, on the card: at each rate, one
run of the cell for each of ``--seeds``, each in its own process, with the
traffic file's rate replaced and its arrival schedule drawn from that seed
(so each rate is judged on as many different arrival draws as seeds).
Prints one line per run: the end-to-end metrics, the requests in flight
when the window opened and closed, and the growth of that backlog as a
share of the requests that arrived in the window.  A rate is sustained
where that growth, averaged over the seeds, is at most ``--growth`` (and
no request is left unfinished); the knee is the highest sustained rate
below the first that is not.

    python portbench/tools/sweep.py --workload cmdr-chat --seconds 51 \
        --seeds 11,12 --rates 5,6,7
"""

import argparse
import json
import pathlib
import re
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[2]
BACKLOG = re.compile(r"in flight at open / close (\d+) / (\d+)")


def one(workload: str, seed: int, seconds: float, rate: float) -> None:
    t_start = time.perf_counter()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench.harness import cell, traffic
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = cell.spec_of(bench, workload)
    mix = traffic.load(cell.HERE / "traffic" / f"{spec.traffic}.json")
    mix["rate_per_s"] = rate
    mix["schedule_seed"] = seed
    o = cell.run(spec, seed, seconds, False, torch.device("cuda", 0),
                 t_start, mix=mix)
    b = [BACKLOG.search(n) for n in o.notes]
    b_open, b_close = next((int(x[1]), int(x[2])) for x in b if x)
    print("SWEEP " + json.dumps({
        "workload": workload, "rate": rate, "seed": seed,
        "correct": o.correct, "metrics": {k: v["value"] for k, v in
                                          o.metrics.items()},
        "backlog": [b_open, b_close],
        "growth_share": (b_close - b_open) / max(1, o.attempted),
        "failed": o.failed, "attempted": o.attempted, "notes": o.notes,
        "checks": o.checks}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--growth", type=float, default=0.02)
    ap.add_argument("--one", type=float)
    a = ap.parse_args()
    if a.one is not None:
        one(a.workload, int(a.seeds), a.seconds, a.one)
        return 0
    seeds = [int(s) for s in a.seeds.split(",")]
    rows = []
    for r in (float(x) for x in a.rates.split(",")):
        for s in seeds:
            p = subprocess.run(
                [sys.executable, __file__, "--workload", a.workload,
                 "--seeds", str(s), "--seconds", str(a.seconds),
                 "--rates", a.rates, "--one", str(r)],
                capture_output=True, text=True)
            line = [x for x in p.stdout.splitlines()
                    if x.startswith("SWEEP ")]
            if p.returncode or not line:
                print(f"rate {r} seed {s}: rc {p.returncode}\n"
                      f"{p.stderr[-3000:]}", flush=True)
                continue
            print(line[-1], flush=True)
            rows.append(json.loads(line[-1][6:]))
    knee = None
    for r in sorted({x["rate"] for x in rows}):
        runs = [x for x in rows if x["rate"] == r]
        mean = sum(x["growth_share"] for x in runs) / max(1, len(runs))
        held = (len(runs) == len(seeds) and mean <= a.growth
                and all(x["failed"] == 0 for x in runs))
        print(f"RATE {r}: " + "; ".join(
            f"seed {x['seed']} backlog {x['backlog'][0]}->{x['backlog'][1]}"
            f" growth {x['growth_share']:.3f} " + " ".join(
                f"{k} {v:.5g}" for k, v in sorted(x["metrics"].items()))
            for x in runs) + f"; mean growth {mean:.4f}"
            + ("  held" if held else "  NOT held"),
            flush=True)
        if not held:
            break
        knee = r
    print(f"KNEE {a.workload} {knee}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
