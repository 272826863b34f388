"""One run of one cell: set-up, the measured window, the readings, the
comparison with the reference, and the result line's content.

Everything that belongs to one configuration, traffic mix, per-layer
metric or model family is found by name under this benchmark's folder:
``configs/<config>.json``, ``traffic/<traffic>.json`` and
``metrics/<metric>.py`` as ``BENCHMARK.json`` names them, and
``families/<family>`` as the configuration names it.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import pathlib
import sys
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from portbench import families
from portbench.harness import compare, roofline, stats, traffic

HERE = pathlib.Path(__file__).resolve().parents[1]     # portbench/
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class MissingMetric(RuntimeError):
    """A metric the cell lists has no value in this run."""


@dataclass
class Spec:
    """One cell of ``BENCHMARK.json`` with the entries that concern it."""
    name: str
    config: str
    traffic: str
    chips: int
    end_to_end: List[Dict]
    per_layer: List[Dict]


def spec_of(bench: Dict, workload: str) -> Spec:
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r}; known: {sorted(cells)}")
    w = cells[workload]

    def mine(entries: List[Dict]) -> List[Dict]:
        return [e for e in entries if workload in e.get("workloads",
                                                        [workload])]

    return Spec(w["name"], w["config"], w["traffic"], w["chips"],
                mine(bench["end_to_end"]), mine(bench["per_layer"]))


def forbidden_modules(names=None) -> List[str]:
    """Of ``names`` (default: the loaded modules), the top-level names
    (before the first dot) that are JAX's, its libraries' or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None
                                             else names)
                   if m.split(".")[0] in FORBIDDEN})


def metric_reader(name: str):
    path = HERE / "metrics" / f"{name}.py"
    sp = importlib.util.spec_from_file_location(f"portbench_metric_{name}",
                                                path)
    mod = importlib.util.module_from_spec(sp)
    sp.loader.exec_module(mod)
    return mod


def kernels_of(entries: List[Dict]) -> Dict:
    """The ``Kernel`` that each listed kernel metric declares, by name."""
    out = {}
    for e in entries:
        k = getattr(metric_reader(e["name"]), "KERNEL", None)
        if k is not None:
            out[e["name"]] = k
    return out


def read_metrics(entries: List[Dict], record: Dict) -> Dict[str, Dict]:
    """Every listed per-layer metric's value from the traced record, or
    ``MissingMetric`` naming the first that has none (never a 0 in its
    place).  A kernel metric's reader finds its own kernel's reading
    under ``record["kernel"]``."""
    out: Dict[str, Dict] = {}
    for e in entries:
        mod = metric_reader(e["name"])
        if mod.UNIT != e["unit"] or mod.MOVES != e["moves"]:
            raise ValueError(f"metric {e['name']}: reader says unit "
                             f"{mod.UNIT!r} moving {mod.MOVES!r}, the "
                             f"benchmark {e['unit']!r} moving {e['moves']!r}")
        rec = record
        if hasattr(mod, "KERNEL"):
            rec = {**record,
                   "kernel": record.get("kernels", {}).get(e["name"])}
        v = mod.read(rec)
        if v is None:
            raise MissingMetric(f"metric {e['name']} has no value in this "
                                f"traced run: {mod.__doc__.strip()}")
        out[e["name"]] = {"value": float(v), "unit": e["unit"]}
    return out


def node_seed(seed: int, i: int) -> int:
    return (seed * 1_000_003 + 7919 * (i + 1)) % (1 << 62)


def load_config(name: str) -> Dict:
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def node_weights(fam, m, cfg: Dict, seed: int, device: torch.device,
                 dtype: str) -> List[Dict]:
    """Each node's weights, made on ``device`` from the run's seed: the
    same tensors on every call with the same seed."""
    return [fam.make_weights(m, node_seed(seed, i), device,
                             getattr(torch, dtype))
            for i in range(len(cfg["deployment"]["nodes"]))]


@dataclass
class Sampled:
    """One finished request of the comparison's sample."""
    rid: str
    node: int                  # index into the deployment's nodes
    prompt: List[int]
    served: List[int]


@dataclass
class Outcome:
    metrics: Dict[str, Dict]
    checks: Dict[str, Dict]
    correct: bool
    attempted: int
    failed: int
    device: Dict
    breakdown: Optional[Dict]
    notes: List[str]
    sample: List[Sampled]


def run(spec: Spec, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float,
        dtype: str = "bfloat16", cfg: Optional[Dict] = None,
        mix: Optional[Dict] = None) -> Outcome:
    """One run of ``spec``; ``cfg`` and ``mix`` stand in for the files the
    cell names (the tests' small sizes, the rate sweep's rates)."""
    from portbench.harness import serve, trace as tr
    cfg = cfg or load_config(spec.config)
    mix = mix or traffic.load(HERE / "traffic" / f"{spec.traffic}.json")
    fam = families.load(cfg["family"])
    m = fam.dims(cfg)
    window = cfg.get("sliding_window")
    if window and mix["prompt"]["max"] + mix["output"]["max"] > window:
        raise ValueError(f"{spec.traffic} reaches past {cfg['name']}'s "
                         f"{window}-position window, which the port does "
                         f"not model")
    dep = cfg["deployment"]
    mc = fam.port_config(cfg, m, dtype)
    if dep.get("config_overrides"):
        mc = mc.replace(**dep["config_overrides"])
    arrivals = traffic.schedule(mix, seconds)
    prompts = traffic.prompt_tokens(arrivals, m.vocab_size, seed)
    notes: List[str] = []

    params = node_weights(fam, m, cfg, seed, device, dtype)
    nodes = serve.build_nodes(dep, mc, params)
    # the protocol draws with the schedule's seed: the dispatch is decided
    # ahead, in simulated time, from the schedule alone, as launch/serve.py
    # draws the requests and the network with one seed
    assign, offloaded = serve.dispatch(arrivals, dep,
                                       int(mix["schedule_seed"]))

    # warm-up: each node serves one request of the mix's longest prompt,
    # which builds the kernels where the checkout has none, allocates the
    # page pool, and takes the largest prefill's activations
    from repro_torch.serving import GenRequest
    longest = int(mix["prompt"]["max"])
    for i, n in enumerate(nodes.values()):
        toks = np.random.default_rng([seed, 3, i]).integers(
            2, m.vocab_size, size=longest).astype(np.int32)
        n.executor.admit(GenRequest(rid=f"warm-{n.nid}", tokens=toks,
                                    max_new=2))
        n.executor.drain()
    if device.type == "cuda":
        torch.cuda.synchronize(device)

    phases = slicer = recorder = tracer = None
    kernels = kernels_of(spec.per_layer) if trace else {}
    if trace:
        from repro_torch.obs import Tracer, set_tracer
        recorder = tr.Recorder(kernels)
        recorder.install()
        slicer = tr.Slicer(float(mix["warmup_s"]), seconds,
                           int(mix["trace_slices"]),
                           float(mix["trace_slice_s"]), recorder)
        slicer.warm()
        phases = tr.Phases()
        tracer = Tracer()
        set_tracer(tracer)

    rp = serve.Replay(
        nodes, arrivals, assign, prompts, float(mix["warmup_s"]), seconds,
        float(mix["drain_s"]), fam.flops(m), device,
        on_phase=(lambda n, a, b: phases.add(n, rp.t0 + a, rp.t0 + b))
        if trace else None,
        on_tick=slicer.tick if trace else None)
    rp.run()
    if trace:
        slicer.finish()
        recorder.uninstall()
        from repro_torch.obs import set_tracer, Tracer as _T
        set_tracer(_T(enabled=False))
    win = rp.window
    if win.close_t is None:
        raise RuntimeError("the window never closed")
    setup_s = rp.t0 + win.open_t - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    reqs = rp.window_requests()
    seen = [lv.seen for lv in reqs]
    n_failed = stats.failed(seen)
    e2e = stats.end_to_end(seen, win.tokens, win.seconds, rp.end)
    e2e["setup_s"] = setup_s
    c0, c1 = win.stats_open, win.stats_close
    delta = {k: c1[k] - c0[k] for k in c0}
    if delta["preempted"]:
        notes.append(f"{int(delta['preempted'])} preemptions in the window")
    batches = delta.get("batches", 0)
    notes.append(
        f"window {win.seconds:.3f} s, {len(reqs)} requests, {n_failed} "
        f"unfinished at the end; in flight at open / close "
        f"{win.backlog[0]} / {win.backlog[1]}; admissions up to "
        f"{win.late_s * 1e3:.1f} ms late; decode "
        f"{1e3 * delta['decode_wall_s'] / max(1, delta['decode_steps']):.2f}"
        f" ms a step over {int(delta['decode_steps'])} steps, prefill "
        f"{delta['prefill_wall_s']:.3f} s in {int(batches)} batches of "
        f"{int(delta['prefill_tokens'])} padded tokens; e2e "
        + ", ".join(f"{k} {v:.4g}" for k, v in sorted(e2e.items()))
        + "; ttft percentiles ms "
        + ", ".join(f"p{q} {stats.percentile(stats.ttft_values(seen, rp.end), q) * 1e3:.1f}"
                    for q in (50, 90, 95, 99)))

    record = {
        "counters": delta,
        "model_flops": {"prefill": win.prefill_flops,
                        "decode": win.decode_flops},
        "peak_flops": roofline.PEAK_FLOPS[dtype],
        "nodes": len(dep["nodes"]),
        "requests": [{
            "rid": lv.arrival.rid, "node": lv.node,
            "origin": lv.arrival.origin,
            "offloaded": offloaded[lv.arrival.rid],
            "prompt_len": lv.arrival.prompt_len,
            "output_len": lv.arrival.output_len, "due": lv.seen.due,
            "admitted": lv.admitted_at, "prefilled": lv.prefilled_at,
            "first": lv.seen.first, "finish": lv.seen.finish,
            "tokens": lv.seen.tokens} for lv in reqs],
    }
    breakdown = None
    dev_info: Dict = {}
    if trace:
        for s in tracer.spans:
            phases.add(s.name, s.t0, s.t1)
        phases.finalize()
        reading = tr.reduce(slicer.slices, slicer.spin_names,
                            phases.phase_of, kernels)
        record["kernels"] = reading.kernels
        record["device"] = {"busy_s": reading.busy_s,
                            "window_s": reading.window_s}
        dev_info = {"busy_s": reading.busy_s, "window_s": reading.window_s}
        breakdown = {"device_ops": [list(x) for x in reading.device_ops],
                     "idle_gaps": [list(x) for x in reading.idle_gaps]}
        notes.append(f"{reading.slices} profiled slices, {reading.window_s:.3f}"
                     f" s on the device clock; closing a slice held the "
                     f"host up to {max(slicer.overhead_s, default=0):.3f} s")
        if reading.skipped:
            notes.append(f"slices left out of a kernel's share (the "
                         f"profiler's launches differ from the host's): "
                         f"{reading.skipped} of {reading.slices}")
        metrics = read_metrics(spec.per_layer, record)
    else:
        metrics = {}
        for e in spec.end_to_end:
            if e["name"] not in e2e:
                raise MissingMetric(f"metric {e['name']} has no value")
            metrics[e["name"]] = {"value": float(e2e[e["name"]]),
                                  "unit": e["unit"]}

    # the program's state goes before the reference runs
    keep = [n.params for n in nodes.values()]
    for n in nodes.values():
        n.engine = n.executor = None
    del nodes, params
    rp.nodes = {}
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    picked = sample(reqs, int(mix["sample_requests"]), seed)
    sampled = [Sampled(lv.arrival.rid, dep["nodes"].index(lv.node),
                       lv.req.tokens.tolist(), lv.result.tolist())
               for lv in picked]
    checks = judge(cfg, fam, m, keep, sampled, rp, device)
    notes.append(f"{sum(len(s.served) for s in sampled)} served tokens "
                 f"compared")
    return Outcome(metrics, checks, verdict(checks), len(reqs), n_failed,
                   {"peak": peak, **dev_info}, breakdown, notes, sampled)


def sample(reqs: List, k: int, seed: int) -> List:
    """``k`` of the finished requests, drawn from the seed, the one with
    the most served tokens among them."""
    done = [lv for lv in reqs if lv.result is not None and len(lv.result)]
    if not done:
        return []
    longest = max(done, key=lambda lv: (len(lv.result), lv.arrival.rid))
    rest = [lv for lv in done if lv is not longest]
    rng = np.random.default_rng([seed, 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False)
    return [longest] + [rest[i] for i in sorted(pick)]


Chooser = Callable[[Dict, Sampled], Sequence[int]]


def widest_gap(fam, m, params: List[Dict], picked: Sequence[Sampled],
               device: torch.device, choose: Optional[Chooser] = None
               ) -> float:
    """The widest gap, over every position of the sample, of the chosen
    token's reference logit below the reference's best, in standard
    deviations of the position's reference logits.  The chosen tokens are
    the served ones, or ``choose(params, sampled)``'s (the control's)."""
    worst = 0.0
    for s in picked:
        p = params[s.node]
        ref = fam.served_logits(p, m, s.prompt, s.served, device)
        toks = s.served if choose is None else choose(p, s)
        worst = max(worst, float(compare.gaps_sd(ref, toks).max()))
        del ref
    return worst


def verdict(checks: Dict[str, Dict]) -> bool:
    """``correct``: every number compared within its limit."""
    return all(c["value"] <= c["limit"] for c in checks.values())


def judge(cfg: Dict, fam, m, params: List[Dict], picked: Sequence[Sampled],
          rp, device: torch.device) -> Dict[str, Dict]:
    """The checks, each with its limit: the widest gap of a served token
    below the reference's best over a sample of the window's finished
    requests; requests served twice, or by another node than the protocol
    assigned; a sample with no served token."""
    n_tok = sum(len(s.served) for s in picked)
    return {
        "max_gap_sd": {"value": widest_gap(fam, m, params, picked, device),
                       "limit": float(cfg["checks"]["max_gap_sd"])},
        "nothing_compared": {"value": float(n_tok == 0), "limit": 0.0},
        "served_twice": {"value": rp.served_twice, "limit": 0.0},
        "misrouted": {"value": rp.misrouted, "limit": 0.0},
    }
