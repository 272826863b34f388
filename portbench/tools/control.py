"""The control of the comparison, on the card at a cell's own size: the
reference computed in fp8 (e4m3), the nearest precision below the
configuration's bf16: every product's operands rounded to fp8, each
weight matrix with one scale and each activation row (a token) with one
scale of its own, as an fp8 matrix product takes them.  At each position
of the program's own sample (the same prompts and served tokens), the
token the control puts first is judged by the same comparison and limit
that decide the run's ``correct``, which has to come out false.  Each
seed is one short run of the cell at its own load (its window long
enough to finish the mix's longest requests), with the program's own
reading beside it, all seeds in one process.

    python portbench/tools/control.py --workload cmdr-chat \
        --seeds 101,102,103 --seconds 20
"""

import argparse
import json
import pathlib
import sys
import time
from typing import Dict, Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

import torch  # noqa: E402

FP8_MAX = 448.0          # largest finite float8_e4m3fn


def fp8(w: torch.Tensor) -> torch.Tensor:
    """``w`` rounded to float8 e4m3 with one scale for the whole tensor,
    back in float32."""
    w = w.float()
    scale = w.abs().max().clamp(min=1e-30) / FP8_MAX
    return (w / scale).to(torch.float8_e4m3fn).float() * scale


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale for each row."""
    x = x.float()
    scale = x.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def judge_control(spec, o, seed: int, device: torch.device,
                  dtype: str = "bfloat16", cfg: Optional[Dict] = None
                  ) -> Dict:
    """The control put in the program's place on the program's sample:
    the weights made again from the run's seed, the fp8 reference's first
    choices through ``cell.widest_gap`` and ``cell.verdict``.  Returns the
    control's checks and its ``correct``."""
    from portbench import families
    from portbench.harness import cell
    cfg = cfg or cell.load_config(spec.config)
    fam = families.load(cfg["family"])
    m = fam.dims(cfg)
    params = cell.node_weights(fam, m, cfg, seed, device, dtype)

    def first_choice(p, s):
        low = fam.served_logits(p, m, s.prompt, s.served, device,
                                cast=fp8, act=fp8_rows)
        return low.argmax(dim=1).tolist()

    gap = cell.widest_gap(fam, m, params, o.sample, device, first_choice)
    checks = {**o.checks, "max_gap_sd": {
        "value": gap, "limit": o.checks["max_gap_sd"]["limit"]}}
    return {"checks": checks, "correct": cell.verdict(checks)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    a = ap.parse_args()
    from portbench.harness import cell
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec = cell.spec_of(bench, a.workload)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in a.seeds.split(",")):
        o = cell.run(spec, seed, a.seconds, False, dev, time.perf_counter())
        torch.cuda.empty_cache()
        ctl = judge_control(spec, o, seed, dev)
        print("CONTROL " + json.dumps({
            "workload": a.workload, "seed": seed,
            "program": {"correct": o.correct, "checks": o.checks},
            "control": ctl, "notes": o.notes}), flush=True)
        del o, ctl
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
