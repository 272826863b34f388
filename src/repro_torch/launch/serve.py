"""End-to-end decentralized serving driver on PyTorch (the paper's system).

Port of ``repro.launch.serve``: spins up N WWW.Serve nodes, each backed by
a real PyTorch engine; users submit requests to the hot node; the
decentralized protocol (PoS routing, credit ledger, duels) redistributes
them in the event-loop simulation.  The protocol's executor assignments
are then replayed on the real engines behind the ``EngineExecutor``
interface (DESIGN.md §6.1): all engines are pumped step by step in
round-robin, so admissions interleave with decode as under live traffic.

The engines are slot engines by default, as in the reference; ``--paged``
backs the nodes with paged-KV engines and ``--spec`` with speculative
paged engines whose draft is ``cfg.draft()``.  ``--kv-quant`` stores the
KV as int8 with bf16 per-(token, head) scales (``cfg.kv_quant``); it
implies paged engines, and with ``--spec`` the target's pages are int8
while the draft keeps fp caches.  ``--disagg`` backs each node with a
disaggregated pair (``DisaggEngineExecutor``): a prefill engine and a
decode engine, sharing the node's weights, joined by page-granular KV
handoff.  ``--trace PATH`` records the protocol sim's and the replay's
lifecycle spans into one stream, writes them to PATH as a Perfetto
(Chrome ``trace_event``) JSON and prints the slowest requests' latency
breakdown.  ``--arch`` takes every config of the reference: the dense
family (qwen3-8b, the default, qwen3-32b, starcoder2-7b,
command-r-plus-104b) and the vlm family (qwen2-vl-7b) on every backend
above, and the moe family (granite-moe-1b-a400m, dbrx-132b), the hybrid
family (recurrentgemma-9b) and the ssm family (xlstm-1.3b), whose engines
serve left-padded waves and refuse the paged backends, as the reference's
do.  whisper-base (audio) builds wave engines too, but its prefill needs
``encoder_embeds`` that the wave path does not pass, so its first wave
raises ``KeyError('encoder_embeds')``, as the reference driver does; the
encoder-decoder is driven through ``models.registry`` instead.  On the
card (the default)
the nodes serve the full-width model in bfloat16, each with its own seeded
random weights; on the CPU (``--device cpu``) they serve the reduced
float32 config the reference driver runs, with the kernels' plain
versions::

    PYTHONPATH=src python -m repro_torch.launch.serve --nodes 2 --requests 8 --max-new 8
    PYTHONPATH=src python -m repro_torch.launch.serve --spec --device cpu
    PYTHONPATH=src python -m repro_torch.launch.serve --spec --kv-quant
    PYTHONPATH=src python -m repro_torch.launch.serve --disagg --trace t.json
    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-moe-1b-a400m
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-9b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch xlstm-1.3b
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import DuelParams, Network, Node, NodePolicy
from repro_torch.models import registry
from repro_torch.models.config import ModelConfig
from repro_torch.obs import (Tracer, breakdown_report, set_tracer, wall_now,
                             write_chrome_trace)
from repro_torch.serving import (DisaggEngineExecutor, Engine,
                                 EngineExecutor, GenRequest,
                                 SpecEngineExecutor)
from repro_torch.sim import make_profile
from repro_torch.sim.workload import Request

ParamsFn = Callable[[int, ModelConfig, torch.device], Dict]
DraftParamsFn = Callable[[ModelConfig, torch.device], Dict]
_MODES = ("slot", "paged", "spec", "disagg")


def require_device(device: str | torch.device) -> torch.device:
    """The device to run on; raises when it is a card this host lacks."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not "
                           f"available; pass device='cpu' to run the plain "
                           f"versions on the CPU")
    return dev


def seeded_params(i: int, cfg: ModelConfig, device: torch.device) -> Dict:
    """Node ``i``'s random weights, drawn on ``device`` from a generator
    seeded with ``i`` (the reference seeds ``jax.random.PRNGKey(i)``)."""
    return registry.init(cfg, torch.Generator(device).manual_seed(i), device)


def seeded_draft_params(cfg: ModelConfig, device: torch.device) -> Dict:
    """The draft's random weights, shared by every node, from a generator
    seeded with 10_000 (the reference seeds ``jax.random.PRNGKey(10_000)``)."""
    return registry.init(cfg, torch.Generator(device).manual_seed(10_000),
                         device)


def run(cfg: ModelConfig, *, nodes: int = 4, requests: int = 24,
        max_new: int = 16, duel_rate: float = 0.2, seed: int = 0,
        device: str | torch.device = "cuda", mode: str = "slot",
        spec_k: int = 4, params_fn: Optional[ParamsFn] = None,
        draft_params_fn: Optional[DraftParamsFn] = None,
        trace: Optional[str] = None, verbose: bool = True) -> Dict:
    """Run the scenario on ``mode`` engines (slot, paged, spec or disagg)
    and return what it produced: the protocol's assignment (node ->
    request ids), the credit balances, every request's tokens and its
    simulated latency, per-node engine stats (and, with spec, each node's
    ``expected_tokens_per_step``), the replay's wall time and tokens/s
    (the replay ends in a device synchronisation), and the recorded spans
    (``trace``: the path the Perfetto trace is written to; no spans
    without it)."""
    if mode not in _MODES:
        raise ValueError(f"mode {mode!r} not in {_MODES}")
    dev = require_device(device)
    params_fn = params_fn or seeded_params
    say = print if verbose else (lambda *a, **k: None)
    say(f"spinning up {nodes} nodes serving {cfg.name} on {dev}")
    spec_draft = None
    if mode == "spec":
        # one shared draft model across nodes (a tiny same-tokenizer
        # sibling; in a real deployment each node brings its own)
        draft_cfg = cfg.draft()
        spec_draft = (draft_cfg, (draft_params_fn or seeded_draft_params)(
            draft_cfg, dev))
    rng = np.random.default_rng(seed)
    net = Network(mode="decentralized", seed=seed,
                  duel=DuelParams(p_d=duel_rate, k_judges=1),
                  init_balance=100.0)
    executors: Dict[str, EngineExecutor] = {}
    for i in range(nodes):
        nid = f"node{i+1}"
        params = params_fn(i, cfg, dev)
        if mode == "disagg":
            # both phase engines serve from the node's one set of weights
            executors[nid] = DisaggEngineExecutor(
                Engine(cfg, params, max_batch=4, bucket=32, seed=i,
                       paged=True),
                Engine(cfg, params, max_batch=4, bucket=32, seed=1000 + i,
                       paged=True))
        else:
            engine = Engine(cfg, params, max_batch=4, bucket=32, seed=i,
                            paged=mode != "slot", spec_draft=spec_draft,
                            spec_k=spec_k)
            executors[nid] = (SpecEngineExecutor(engine) if mode == "spec"
                              else EngineExecutor(engine))
        executors[nid].owner = nid     # real-engine spans carry the node id
        prof = make_profile("qwen3-8b", "RTX3090", "sglang",
                            quality=0.4 + 0.15 * i)
        pol = NodePolicy(offload_util_threshold=0.15,
                         offload_queue_threshold=0, target_utilization=0.9)
        net.add_node(Node(nid, prof, policy=pol))

    # with a trace, the protocol sim (sim clock) and the real-engine
    # replay (wall clock) record into one stream; the exporter keeps the
    # two clock domains apart as separate Perfetto processes
    tracer = Tracer() if trace else None
    old_tracer = set_tracer(tracer) if tracer else None
    try:
        out = _scenario(cfg, net, executors, rng, dev, requests, max_new,
                        say)
    finally:
        if tracer:
            set_tracer(old_tracer)
    spans = tracer.spans if tracer else []
    if trace:
        payload = write_chrome_trace(spans, trace)
        say(breakdown_report(spans, limit=3))
        say(f"wrote {len(spans)} spans ({len(payload['traceEvents'])} "
            f"events) to {trace}")
    return {**out, "spans": spans}


def _scenario(cfg: ModelConfig, net: Network,
              executors: Dict[str, EngineExecutor], rng, dev: torch.device,
              requests: int, max_new: int, say) -> Dict:
    """Run the protocol over the requests, replay its assignment on the
    real engines and report what ``run`` returns (spans aside)."""
    prompt_len = 24
    # every user request goes to node1 (the hot node)
    prompts = [rng.integers(2, cfg.vocab_size, size=prompt_len)
               .astype(np.int32) for _ in range(requests)]
    sim_reqs = [Request(rid=f"r{i}", origin="node1", arrival=0.01 * i,
                        prompt_tokens=prompt_len, output_tokens=max_new,
                        slo_s=60.0) for i in range(requests)]
    m = net.run(sim_reqs, until=600.0)

    # replay the protocol's assignments on the real engines: admit through
    # the Executor interface, then pump all engines in round-robin
    by_exec: Dict[str, List[int]] = {}
    for c in m.completed:
        if not c.is_duel_extra:
            by_exec.setdefault(c.executor, []).append(int(c.rid[1:]))
    say(f"protocol assigned: { {k: len(v) for k, v in by_exec.items()} }")
    done_by_node: Dict[str, List[GenRequest]] = {nid: [] for nid in by_exec}
    t0 = wall_now()
    for nid, idxs in by_exec.items():
        ex = executors[nid]
        ex.bind(None, lambda r, st, ft, nid=nid: done_by_node[nid].append(r))
        for i in idxs:
            ex.admit(GenRequest(rid=f"r{i}", tokens=prompts[i],
                                max_new=max_new))
    busy = {nid for nid in by_exec if executors[nid].has_work()}
    while busy:
        for nid in sorted(busy):
            executors[nid].step()
        busy = {nid for nid in busy if executors[nid].has_work()}
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall_s = wall_now() - t0
    total_tokens = 0
    for nid in sorted(by_exec):
        ex, done = executors[nid], done_by_node[nid]
        ld, st = ex.load(), ex.engine_stats()
        total_tokens += sum(len(r.result) for r in done)
        spec = (f", spec accepted {st.spec_accepted}/{st.spec_drafted} "
                f"drafts over {st.spec_steps} verifies "
                f"(E[tok/step] {ld.expected_tokens_per_step:.2f})"
                if isinstance(ex, SpecEngineExecutor) else
                f", {st.handoffs} KV handoffs "
                f"({st.handoff_bytes / 1e6:.1f} MB)"
                if isinstance(ex, DisaggEngineExecutor) else "")
        say(f"  {nid}: served {len(done)} requests "
            f"({st.decode_tokens} decode tokens in {st.decode_steps} steps; "
            f"load: {ld.active_streams} active / {ld.queued_streams} queued, "
            f"prefill headroom {ld.prefill_headroom:.2f}, "
            f"decode headroom {ld.decode_headroom:.2f}{spec})")
    balances = {n: net.ledger_balance(n) for n in net.nodes}
    say(f"generated {total_tokens} tokens across {len(by_exec)} nodes in "
        f"{wall_s:.2f}s wall ({total_tokens / wall_s:.1f} tok/s)")
    say(f"sim SLO attainment: {m.slo_attainment():.3f}; "
        f"delegation rate: {m.delegation_rate():.2f}; "
        f"avg TTFT: {m.avg_ttft():.2f}s; "
        f"avg queue wait: {m.avg_queue_wait():.2f}s")
    say(f"credit balances: { {n: round(b, 1) for n, b in balances.items()} }")
    return {
        "assigned": {nid: [f"r{i}" for i in idxs]
                     for nid, idxs in by_exec.items()},
        "balances": balances,
        "results": {r.rid: np.asarray(r.result)
                    for done in done_by_node.values() for r in done},
        "stats": {nid: executors[nid].engine_stats() for nid in by_exec},
        "expected_tokens_per_step": {
            nid: executors[nid].load().expected_tokens_per_step
            for nid in by_exec},
        "tokens": total_tokens,
        "wall_s": wall_s,
        "tok_per_s": total_tokens / wall_s if wall_s > 0 else 0.0,
        "slo_attainment": m.slo_attainment(),
        "latency": {c.rid: c.latency for c in m.completed
                    if not c.is_duel_extra},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--nodes", type=int, default=4)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--duel-rate", type=float, default=0.2)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="back nodes with paged-KV engines (DESIGN.md "
                         "§6.1, paged backend)")
    ap.add_argument("--spec", action="store_true",
                    help="back nodes with speculative-decoding engines: a "
                         "tiny draft proposes --spec-k tokens per target "
                         "verify forward (DESIGN.md §6.1-spec; implies "
                         "paged)")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft tokens proposed per verify step")
    ap.add_argument("--disagg", action="store_true",
                    help="back nodes with disaggregated prefill/decode "
                         "engine pairs joined by page-granular KV handoff "
                         "(DESIGN.md §6.1-disagg; implies paged)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="store KV as int8 with per-token-per-head scale "
                         "pools: half the bytes per resident token, so the "
                         "same budget holds 2x the pages (DESIGN.md "
                         "§6.1-paged; implies paged)")
    ap.add_argument("--trace", metavar="PATH",
                    help="record lifecycle spans (DESIGN.md §Observability) "
                         "for the protocol sim AND the real-engine replay, "
                         "write a Perfetto/Chrome trace_event JSON to PATH, "
                         "and print the per-request latency breakdown")
    ap.add_argument("--device", default="cuda",
                    help="cuda: the full-width model in bfloat16 on the "
                         "hand-written kernels; cpu: the reduced float32 "
                         "config on their plain versions")
    args = ap.parse_args(argv)
    if args.spec and args.disagg:
        ap.error("--spec and --disagg are separate backends; pick one")
    if args.kv_quant and args.disagg:
        ap.error("--kv-quant is colocated-only: KV handoffs carry fp "
                 "pages (DESIGN.md §6.1-paged)")
    mode = ("spec" if args.spec else "disagg" if args.disagg else
            "paged" if args.paged or args.kv_quant else "slot")
    dev = require_device(args.device)
    cfg = get_config(args.arch)
    cfg = (cfg.replace(dtype="bfloat16") if dev.type == "cuda"
           else cfg.smoke().replace(dtype="float32"))
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)
    run(cfg, nodes=args.nodes, requests=args.requests, max_new=args.max_new,
        duel_rate=args.duel_rate, seed=args.seed, device=dev, mode=mode,
        spec_k=args.spec_k, trace=args.trace)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
