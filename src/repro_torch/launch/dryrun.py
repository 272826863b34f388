"""Dry run of the mesh layer on an H100 cluster's mesh: per-device
memory, FLOPs, collective bytes and roofline terms, with no card.

Port of ``repro.launch.dryrun``; run it as ``python -m
repro_torch.launch.dryrun --arch qwen3-8b --shape train_4k`` (the
reference's flags, plus ``--device``, the fake tensors' device, default
``cuda``).  Nothing is set at import: ``lower_one`` makes a fake process
group of 256 (or 512 with ``--multi-pod``) ranks, this process standing
as rank 0 (``meshenv.fake_process_group``), builds the H100 cluster mesh
of ``launch.mesh`` on it, and runs the step on fake tensors
(``FakeTensorMode``): DTensor places every shard and issues every
collective, no storage exists, and the collectives move nothing.  A
dispatch mode that lets DTensor run first sees only this rank's local
ops, and counts:

* ``flops``: the local matmul-like ops by ``torch.utils.flop_counter``'s
  formulas.  Where XLA's cost analysis counts elementwise work too, these
  count matmuls, convolutions and attention only.
* ``collective_bytes``: each functional collective's result bytes, by
  the reference's five kinds.
* ``hbm_traffic_bytes``: the rule of the reference's HBM estimate --
  operand plus result bytes of the ops that move memory on the card
  (matmuls, reductions, collectives, gather/scatter/index ops, sorts,
  copies) with elementwise ops taken as fused.  A kernel's plain version,
  which runs in its place on fake tensors (``kernels.ops``), counts as
  the kernel would: its operands and its result once.

DTensor's sharding propagation runs each new op once on global-shape
fake tensors of its own mode; the counts skip those.

``argument_bytes`` are the exact bytes of this rank's shards of the
step's inputs at full depth.  Every other number comes from runs at 1
and 2 layer groups, extrapolated linearly over the homogeneous layer
stack as the reference extrapolates its roofline: ``output_bytes`` (the
outputs' shards), ``temp_bytes`` (the peak that ``MemTracker`` sees
allocated during a second run, ``None`` where it cannot follow one; a kernel's
plain version allocates what the kernel would not, such as a prefill's
(B, H, S, S) scores, so this bounds the card's from above; the sLSTM
takes its parallel surrogate here too, whose (B, T, d) temporaries stand
for the loop's per-step ones),
``peak_bytes`` (temp plus arguments, as the reference adds them), and
the roofline's counts, taken with one microbatch as the reference's
are, against the H100 constants of ``launch.mesh``.

Perf variants with no counterpart in the
port (``qchunk*``, ``skip_blocks``) are accepted and listed under
``"no_counterpart"``; ``donate`` is the port's default, its caches
updating in place.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from typing import Dict, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.compat import meshenv
from repro_torch.configs import _INPUT_SHAPES, get_config, grid
from repro_torch.kernels import ops
from repro_torch.launch import sharding as sh
from repro_torch.launch.mesh import (_HBM_BW, _NVLINK_BW, _PEAK_FLOPS_BF16,
                                     make_production_mesh)
from repro_torch.launch.specs import input_specs, n_groups_of, reduced_depth
from repro_torch.launch.steps import (build_prefill_step, build_serve_step,
                                      build_train_step, microbatches_for)
from repro_torch.models import runtime

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")
# functional collectives (namespace _c10d_functional) -> kind
_FUNCOL_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}
# aten ops that read and write HBM on the card (the rest: fused)
_HEAVY = frozenset({
    "mm", "bmm", "addmm", "baddbmm", "convolution",
    "sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
    "_softmax", "_log_softmax", "var_mean", "topk", "argmax", "cumsum",
    "gather", "scatter", "scatter_add", "scatter_reduce", "index",
    "index_put", "_index_put_impl", "index_select", "index_add",
    "index_copy", "embedding", "searchsorted", "sort", "copy", "_to_copy",
    "clone", "cat", "stack", "roll", "constant_pad_nd",
})
_VARIANT_FLAGS = {"seqpar": "seq_parallel_", "lsedecode": "decode_seq_shard_",
                  "attnbatch": "attn_batch_only_", "gqanative": "gqa_native_",
                  "moea2a": "moe_a2a_"}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else 0


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of the tensors in ``tree``."""
    if isinstance(tree, dict):
        return sum(_local_bytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(_local_bytes(v) for v in tree)
    if isinstance(tree, DTensor):
        return _nbytes(tree.to_local())
    return _nbytes(tree)


class Counter(TorchDispatchMode):
    """Per-device counts of the ops a step runs on this rank's shards:
    FLOPs, collective result bytes by kind, and the HBM traffic rule.
    Ops on DTensors pass to DTensor first, which runs them here again on
    local shards."""

    def __init__(self, fake: FakeTensorMode):
        super().__init__()
        self.fake = fake
        self.flops = 0.0
        self.hbm = 0.0
        self.coll = {k: 0 for k in _COLLECTIVES}
        self._in_kernel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self._ours(out):
            return out        # DTensor's shape propagation, in its own mode
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        name = func._schema.name.split("::")[-1]
        if func.namespace == "_c10d_functional":
            kind = _FUNCOL_KIND.get(name)
            if kind is not None:
                self.coll[kind] += sum(_nbytes(t) for t in (
                    out if isinstance(out, (list, tuple)) else [out]))
        if self._in_kernel or name.rstrip("_") not in _HEAVY:
            return out
        tensors = [a for a in list(args) + list(kwargs.values())
                   if isinstance(a, torch.Tensor)]
        outs = out if isinstance(out, (list, tuple)) else [out]
        self.hbm += sum(_nbytes(t) for t in tensors + list(outs))
        return out

    def _ours(self, out) -> bool:
        outs = out if isinstance(out, (list, tuple)) else [out]
        return all(getattr(t, "fake_mode", self.fake) is self.fake
                   for t in outs if isinstance(t, torch.Tensor))

    @contextlib.contextmanager
    def kernel(self, name, inputs):
        """A kernel's plain version: its operands and its result (shaped
        as its first input, the queries) count once, nothing inside."""
        del name
        self.hbm += sum(_nbytes(t) for t in inputs) + _nbytes(inputs[0])
        self._in_kernel += 1
        try:
            yield
        finally:
            self._in_kernel -= 1


def _parse_variant(perf_variant: Optional[str]) -> Dict:
    kw: Dict = {}
    for part in (perf_variant or "").split("+"):
        if part in _VARIANT_FLAGS:
            kw[_VARIANT_FLAGS[part]] = True
        elif part == "skip_blocks":
            kw["skip_masked_blocks"] = True
        elif part == "tponly":
            kw["tp_only_params"] = True
        elif part == "donate":
            kw["donate_cache"] = True
        elif part == "kvint8":
            kw["kv_quant"] = True
        elif part.startswith("padheads"):
            kw["pad_heads"] = int(part[len("padheads"):])
        elif part.startswith("qchunk"):
            kw["q_chunk"] = kw["kv_chunk"] = int(part[len("qchunk"):])
        elif part.startswith("mb"):
            kw["microbatches"] = int(part[2:])
    return kw


def _no_counterpart(perf_variant: Optional[str]):
    return [p for p in (perf_variant or "").split("+")
            if p == "skip_blocks" or p.startswith("qchunk")]


def _setup(arch: str, shape_name: str, mesh, kw: Dict, device: str, fake,
           *, roofline: bool = False, k_groups: Optional[int] = None):
    """The config, input shape, step and sharded inputs of one (arch x
    shape) on ``mesh``, the inputs made in the ``fake`` mode; and the
    perf flags to run the step under."""
    kw = dict(kw)
    flags = {k: kw.pop(k) for k in list(kw) if k.endswith("_")}
    data_fsdp = not kw.pop("tp_only_params", False)
    kw.pop("donate_cache", None)
    pad_heads = kw.pop("pad_heads", None)
    cfg = get_config(arch, shape_name)
    if pad_heads:
        cfg = cfg.replace(n_heads=pad_heads)
    if kw.pop("kv_quant", False):
        cfg = cfg.replace(kv_quant=True)
    if k_groups is not None:
        cfg = reduced_depth(cfg, k_groups)
    if roofline:
        kw["microbatches"] = 1
    with fake:
        specs = input_specs(arch, shape_name, cfg_override=cfg, device=device)
    shp = specs["shape"]

    def params(tree):
        return sh.distribute(tree, sh.params_shardings(
            tree, mesh, data_fsdp=data_fsdp), mesh)

    def batch(tree):
        return sh.distribute(tree, sh.batch_shardings(tree, mesh), mesh)

    if shp.kind == "train":
        pshard = sh.params_shardings(specs["state"]["params"], mesh,
                                     data_fsdp=data_fsdp)
        args = (sh.distribute(specs["state"], {
            "params": pshard, "opt": sh.opt_shardings(pshard)}, mesh),
            batch(specs["batch"]))
        step = build_train_step(cfg, shp, **kw)
    elif shp.kind == "prefill":
        args = (params(specs["params"]), batch(specs["batch"]))
        step = build_prefill_step(cfg, shp, **{
            k: v for k, v in kw.items() if k.endswith("chunk")})
    else:
        args = (params(specs["params"]),
                sh.distribute(specs["cache"], sh.cache_shardings(
                    specs["cache"], mesh), mesh),
                batch({"token": specs["token"]})["token"])
        step = build_serve_step(cfg, shp)
    return cfg, shp, step, args, flags


def _run(arch: str, shape_name: str, mesh, kw: Dict, device: str, fake, *,
         roofline: bool = False, k_groups: Optional[int] = None,
         counter: Optional["Counter"] = None):
    """Run one (arch x shape) at ``k_groups`` layer groups: under
    ``counter`` when given (the roofline's counts), else once to fill
    DTensor's caches -- whose shape propagation would otherwise allocate
    global-shape tensors in the tracked run -- and once under
    ``MemTracker``.  Returns (output bytes, temp bytes or None)."""
    _, _, step, args, flags = _setup(arch, shape_name, mesh, kw, device,
                                     fake, roofline=roofline,
                                     k_groups=k_groups)
    # the sLSTM's loop of T steps, even on each rank's fake local tensors,
    # keeps xlstm-1.3b's train_4k over 30 minutes on a CPU: the memory
    # runs take its surrogate too (temp bytes: the surrogate's)
    ctx = (runtime.roofline_lowering() if roofline
           else runtime.surrogate_slstm())
    with runtime.perf_flags(**flags), ctx, meshenv.mesh_context(mesh):
        if counter is None:
            step(*args)
            return _tracked(step, args, device)
        with counter, ops.kernel_scope(counter.kernel):
            return _local_bytes(step(*args)), None


def _tracked(step, args, device: str):
    """(output bytes, temp bytes): the temp bytes are the peak that
    ``MemTracker`` sees allocated on ``device`` during the run (this rank's
    shards), None where it cannot follow the run."""
    try:
        from torch.distributed._tools.mem_tracker import MemTracker
        tracker = MemTracker()
        with tracker:
            out = step(*args)
    except Exception:  # noqa: BLE001 -- MemTracker cannot follow this run
        return _local_bytes(step(*args)), None
    return _local_bytes(out), sum(
        v.get("Total", 0) for d, v in
        tracker.get_tracker_snapshot("peak").items()
        if torch.device(d).type == torch.device(device).type)


def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              perf_variant: Optional[str] = None,
              with_roofline: Optional[bool] = None,
              device: str = "cuda") -> Dict:
    """Run one (arch x shape) on the H100 cluster's mesh of fake ranks and
    return its report.  Argument bytes are exact at full depth; output
    and temp bytes, FLOPs, HBM and collective bytes come from runs at 1
    and 2 layer groups, extrapolated linearly over the homogeneous layer
    stack as the reference extrapolates its roofline.  The roofline runs
    (with one microbatch, as the reference's) are skipped for
    ``multi_pod`` unless ``with_roofline``."""
    base = get_config(arch, shape_name)
    kw = _parse_variant(perf_variant)
    n_dev = 512 if multi_pod else 256
    if with_roofline is None:
        with_roofline = not multi_pod
    g = n_groups_of(base)

    def extrap(a, b):
        return max(a + (g - 1) * (b - a), 0)

    grad = (contextlib.nullcontext() if _INPUT_SHAPES[shape_name].kind
            == "train" else torch.no_grad())
    with meshenv.fake_process_group(n_dev), grad:
        # the mesh's rank table is real: built outside the fake mode.  The
        # inputs are made in the fake mode and the steps run outside it:
        # ops on fake tensors enter their mode themselves, while DTensor's
        # bookkeeping tensors stay real
        mesh = make_production_mesh(multi_pod=multi_pod, device_type=device)
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        t0 = time.time()
        cfg, shp, _, args, _ = _setup(arch, shape_name, mesh, kw, device,
                                      fake)
        arg_b = _local_bytes(args)
        del args
        (o1, t1), (o2, t2) = (_run(arch, shape_name, mesh, kw, device, fake,
                                   k_groups=k) for k in (1, 2))
        temp = None if t1 is None or t2 is None else extrap(t1, t2)
        report = {
            "arch": arch, "shape": shape_name, "kind": shp.kind,
            "mesh": "2x32x8" if multi_pod else "32x8",
            "perf_variant": perf_variant or "baseline",
            "compile_s": round(time.time() - t0, 1),
            "memory": {
                "argument_bytes": arg_b, "output_bytes": extrap(o1, o2),
                "temp_bytes": temp,
                "peak_bytes": None if temp is None else temp + arg_b,
            },
            "no_counterpart": _no_counterpart(perf_variant),
            "device": device,
        }
        if shp.kind == "train":
            report["microbatches"] = kw.get("microbatches") or \
                microbatches_for(cfg, shp)
        if not with_roofline:
            return report
        t0 = time.time()
        stats = []
        for k in (1, 2):
            c = Counter(fake)
            _run(arch, shape_name, mesh, kw, device, fake, roofline=True,
                 k_groups=k, counter=c)
            stats.append(c)
        t_roof = time.time() - t0
    s1, s2 = stats
    flops = extrap(s1.flops, s2.flops)
    bytes_acc = extrap(s1.hbm, s2.hbm)
    coll = {k: extrap(s1.coll[k], s2.coll[k]) for k in s1.coll}
    terms = {"compute_s": flops / _PEAK_FLOPS_BF16,
             "memory_s": bytes_acc / _HBM_BW,
             "collective_s": sum(coll.values()) / _NVLINK_BW}
    dominant = max(terms, key=terms.get)
    # model FLOPs: the useful-math floor of this step
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    model_flops = ((6.0 if shp.kind == "train" else 2.0)
                   * cfg.n_active_params() * tokens)
    hlo_flops_global = flops * n_dev
    report["roofline_compile_s"] = round(t_roof, 1)
    report["per_device"] = {"flops": flops, "bytes_accessed": bytes_acc}
    report["collective_bytes"] = coll
    report["roofline"] = {
        "compute_ms": round(terms["compute_s"] * 1e3, 4),
        "memory_ms": round(terms["memory_s"] * 1e3, 4),
        "collective_ms": round(terms["collective_s"] * 1e3, 4),
        "dominant": dominant.replace("_s", ""),
        "model_flops": model_flops,
        "hlo_flops_global": hlo_flops_global,
        "useful_fraction": round(model_flops / hlo_flops_global, 4)
        if hlo_flops_global else 0.0,
    }
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="H100-cluster dry run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None,
                    choices=list(_INPUT_SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) combination")
    ap.add_argument("--perf-variant", default=None)
    ap.add_argument("--out", default=None, help="append JSONL reports here")
    ap.add_argument("--device", default="cuda",
                    help="device of the fake tensors (cuda or cpu)")
    args = ap.parse_args(argv)

    combos = grid() if args.all else [(args.arch, args.shape)]
    failures = []
    for arch, shape in combos:
        try:
            rep = lower_one(arch, shape, multi_pod=args.multi_pod,
                            perf_variant=args.perf_variant,
                            device=args.device)
            line = json.dumps(rep)
            print(line, flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(line + "\n")
        except Exception as e:  # noqa: BLE001 -- report and continue
            failures.append((arch, shape, repr(e)))
            print(json.dumps({"arch": arch, "shape": shape,
                              "error": repr(e)[:500]}), flush=True)
    if failures:
        print(f"FAILED {len(failures)}/{len(combos)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
