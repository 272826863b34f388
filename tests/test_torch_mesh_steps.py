"""The mesh layer's steps and variants, in spawned gloo ranks on the CPU.

* On a (1, 1) mesh of one rank, the port's ``build_train_step``,
  ``build_prefill_step`` and ``build_serve_step`` on the float32 smoke
  configs of qwen3-8b and granite-moe-1b-a400m (capacity factor 8, as a
  moe decode needs to equal its prefill), fed DTensors sharded by
  ``launch.sharding``, equal the reference's steps jitted under
  ``repro.compat.meshenv.mesh_context(make_host_mesh())``: the loss within
  1e-5 and the grad norm within 1e-4 relative, the logits within 2e-5 of
  max|logit|, the greedy tokens equal.
* On a (2, 2) mesh of 4 ranks they equal the unsharded port: logits within
  1e-4 of max|logit|, every gradient within 1e-4 of its leaf's max|g|,
  greedy tokens equal -- qwen3-8b's serve steps also under
  ``decode_seq_shard``.
* ``decode_attention_seqsharded`` at m = 2 (the (2, 2) mesh) and m = 4 (a
  (1, 4) mesh), fp and int8, equals the unsharded decode within 2e-5, and
  each rank's ring write lands only on its own chunk; ``_moe_mlp_a2a`` at
  m = 2 with E = 4 at capacity factor 8 equals the einsum path within
  1e-5, through two all-to-alls, its aux the reference's per-shard aux
  averaged over the shards within 1e-6.
* At 2 microbatches on the (2, 2) mesh each microbatch holds the
  reference's rows (``_regroup_rows``, also over two mesh dims), so
  granite-moe's per-microbatch aux and CE equal the unsharded port's
  within 1e-5 and the step's loss and grad norm within 1e-4.
* With no mesh the variants fall back as the reference's do
  (``tests/test_perf_variants.py``: ``TestSeqShardedDecode``,
  ``TestInt8KV``'s seq-sharded case, ``TestFlagHygiene``, ``TestMoEA2A``),
  and ``gqa_native`` changes no value (the port has nothing to switch).

Weights: the JAX package's init with biases and norm scales perturbed
(``test_torch_dense_variants.perturbed``), bridged to the port.
"""

import contextlib
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import _InputShape
from repro_torch.models import runtime
from test_torch_dense_variants import both_params

ARCHS = ("qwen3-8b", "granite-moe-1b-a400m")
B, S, CAP, STEPS = 4, 16, 24, 3
LOSS_REL, GNORM_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _replace(arch):
    return {"capacity_factor": 8.0} if "moe" in arch else {}


def _shapes():
    return {"train": _InputShape("t", S, B, "train"),
            "prefill": _InputShape("p", CAP, B, "prefill"),
            "decode": _InputShape("d", CAP, B, "decode")}


def _tree_map(fn, t):
    return {k: _tree_map(fn, v) for k, v in t.items()} \
        if isinstance(t, dict) else fn(t)


def _full(t):
    from torch.distributed.tensor import DTensor
    return t.full_tensor() if isinstance(t, DTensor) else t


def _port_steps(cfg, params, batch, mesh, micro=None, seq_shard=False):
    """The port's three steps on ``params`` (plain, or sharded on
    ``mesh``): prefill logits, ``STEPS`` greedy serve steps, the train
    step's metrics and the gradients of ``loss_and_grads``."""
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step)
    from repro_torch.training import init_opt_state
    from repro_torch.training.train_step import loss_and_grads
    shp = _shapes()
    params = _tree_map(torch.clone, params)

    def put(tree, specs):
        return tree if mesh is None else sh.distribute(tree, specs, mesh)

    def ctx():
        return meshenv.mesh_context(mesh) if mesh is not None else \
            contextlib.nullcontext()

    out = {}
    with ctx(), runtime.perf_flags(decode_seq_shard_=seq_shard), \
            torch.no_grad():
        pspecs = None if mesh is None else sh.params_shardings(params, mesh)
        dp = put(_tree_map(torch.clone, params), pspecs)
        toks = {"tokens": batch["tokens"]}
        lg, cache = build_prefill_step(cfg, shp["prefill"])(
            dp, put(toks, None if mesh is None else
                    sh.batch_shardings(toks, mesh)))
        out["prefill"] = _full(lg)
        serve = build_serve_step(cfg, shp["decode"])
        tok, logits, toks_out = _full(lg).argmax(-1).to(torch.int32), [], []
        for _ in range(STEPS):
            t_in = tok if mesh is None else sh.distribute(
                tok, sh.batch_spec(tuple(tok.shape), mesh), mesh)
            lg, cache = serve(dp, cache, t_in)
            logits.append(_full(lg))
            tok = _full(lg).argmax(-1).to(torch.int32)
            toks_out.append(tok)
        out["serve"], out["tokens"] = torch.stack(logits), torch.stack(
            toks_out)
    if seq_shard:
        return out
    with ctx():
        bspecs = None if mesh is None else sh.batch_shardings(batch, mesh)
        _, _, grads = loss_and_grads(put(_tree_map(torch.clone, params),
                                         pspecs), cfg, put(batch, bspecs))
        out["grads"] = _tree_map(_full, grads)
        state = {"params": _tree_map(torch.clone, params)}
        state["opt"] = init_opt_state(state["params"])
        sspecs = None if mesh is None else {
            "params": pspecs, "opt": sh.opt_shardings(pspecs)}
        _, met = build_train_step(cfg, shp["train"], microbatches=micro)(
            put(state, sspecs), put(batch, bspecs))
        out["metrics"] = {k: float(_full(v)) for k, v in met.items()}
    return out


def _seqsharded_case(mesh, m, quant, seed):
    """decode_attention_seqsharded on ``mesh`` (model axis of ``m``)
    against the plain write-then-decode; returns errors and the ranks'
    chunk checks."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.models.attention import (decode_attention,
                                              decode_attention_seqsharded,
                                              kv_dequantize, kv_quantize)
    g = torch.Generator().manual_seed(seed)
    b, s, h, hkv, d = 4, 48, 4, 2, 16
    q = torch.randn(b, 1, h, d, generator=g)
    kc, vc = (torch.randn(b, s, hkv, d, generator=g) for _ in range(2))
    kn, vn = (torch.randn(b, 1, hkv, d, generator=g) for _ in range(2))
    slot, n_valid = torch.tensor(29), torch.tensor(30)
    caches, news = [kc, vc], [kn, vn]
    if quant:
        (kc, ks), (vc, vs) = kv_quantize(kc), kv_quantize(vc)
        (kn, kns), (vn, vns) = kv_quantize(kn), kv_quantize(vn)
        caches, news = [kc, vc, ks, vs], [kn, vn, kns, vns]
    want_caches = [c.clone() for c in caches]
    for c, n in zip(want_caches, news):
        c[:, 29] = n[:, 0]
    kf, vf = want_caches[:2]
    if quant:
        kf = kv_dequantize(kf, want_caches[2], torch.float32)
        vf = kv_dequantize(vf, want_caches[3], torch.float32)
    want = decode_attention(q, kf, vf, n_valid)
    spec = (tuple(a for a in ("data",) if a in mesh.mesh_dim_names)
            or None, "model", None, None)
    dcs = [sh.distribute(c.clone(), spec, mesh) for c in caches]
    before = [c.to_local().clone() for c in dcs]
    with meshenv.mesh_context(mesh):
        out = decode_attention_seqsharded(
            q, dcs[0], dcs[1], news[0], news[1], slot, n_valid,
            scales=(dcs[2], dcs[3], news[2], news[3]) if quant else None)
    shard = mesh.get_local_rank("model")
    lo, hi = shard * s // m, (shard + 1) * s // m
    changed = [bool((c.to_local() != b0).any()) for c, b0 in
               zip(dcs, before)]
    del Replicate, Shard
    return {"err": float((out[0].full_tensor() - want).abs().max()),
            "caches": all(torch.equal(c.full_tensor(), w)
                          for c, w in zip(dcs, want_caches)),
            "owns": lo <= 29 < hi, "changed": changed,
            "same_objects": all(a is c for a, c in zip(out[1:], dcs))}


_A2A_CFG = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_ff=32, vocab_size=512, head_dim=16,
                n_experts=4, top_k=2, capacity_factor=8.0, dtype="float32")


def _a2a_inputs():
    """The a2a case's config, params (seed 0) and input x (4, 16, 64)."""
    from repro_torch.models import moe
    from repro_torch.models.config import ModelConfig
    cfg = ModelConfig(**_A2A_CFG)
    params = moe.init(cfg, torch.Generator().manual_seed(0), "cpu")
    x = torch.randn(4, 16, 64, generator=torch.Generator().manual_seed(1))
    return cfg, params, x


def _a2a_case(mesh):
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.models import moe
    cfg, params, x = _a2a_inputs()
    lp = {k: v[0] for k, v in params["layers"].items()
          if not isinstance(v, dict)}
    want, plain_aux = moe.moe_mlp(cfg, lp, x)
    calls = []
    orig = moe.funcol.all_to_all_single_autograd

    def counted(*a, **k):
        calls.append(1)
        return orig(*a, **k)

    moe.funcol.all_to_all_single_autograd = counted
    try:
        specs = sh.params_shardings({"layers": params["layers"]}, mesh)
        dl = sh.distribute({"layers": params["layers"]}, specs, mesh)
        dlp = {k: v[0] for k, v in dl["layers"].items()
               if not isinstance(v, dict)}
        dx = sh.distribute(x, sh.batch_spec(tuple(x.shape), mesh), mesh)
        with meshenv.mesh_context(mesh), runtime.perf_flags(moe_a2a_=True):
            got, aux = moe.moe_mlp(cfg, dlp, dx)
        n_a2a = len(calls)
        with meshenv.mesh_context(mesh):
            _, einsum_aux = moe.moe_mlp(cfg, dlp, dx)
    finally:
        moe.funcol.all_to_all_single_autograd = orig
    return {"err": float((got.full_tensor() - want).abs().max()),
            "a2a_calls": n_a2a, "aux": float(aux.full_tensor()),
            "einsum_aux": float(einsum_aux.full_tensor()),
            "plain_aux": float(plain_aux)}


def _micro_case(cfg, params, batch, mesh, n):
    """The train step at ``n`` microbatches, on ``params`` sharded on
    ``mesh`` or plain, and each microbatch's rows and loss parts."""
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import init_opt_state
    from repro_torch.training.train_step import (_regroup_rows,
                                                 _split_microbatch, loss_fn)
    pspecs = None if mesh is None else sh.params_shardings(params, mesh)
    bspecs = None if mesh is None else sh.batch_shardings(batch, mesh)

    def put(tree, specs):
        return tree if mesh is None else sh.distribute(tree, specs, mesh)

    out = {"micro": []}
    with meshenv.mesh_context(mesh) if mesh is not None else \
            contextlib.nullcontext():
        dp = put(_tree_map(torch.clone, params), pspecs)
        rows = {k: _regroup_rows(v, n)
                for k, v in put(batch, bspecs).items()}
        with torch.no_grad():
            for i in range(n):
                mb = _split_microbatch(rows, n, i)
                _, parts = loss_fn(dp, cfg, mb)
                out["micro"].append({"tokens": _full(mb["tokens"]), **{
                    k: float(_full(v)) for k, v in parts.items()}})
        state = {"params": _tree_map(torch.clone, params)}
        state["opt"] = init_opt_state(state["params"])
        sspecs = None if mesh is None else {
            "params": pspecs, "opt": sh.opt_shardings(pspecs)}
        _, met = build_train_step(cfg, _shapes()["train"], microbatches=n)(
            put(state, sspecs), put(batch, bspecs))
        out["metrics"] = {k: float(_full(v)) for k, v in met.items()}
    return out


def _regroup_case():
    """``_regroup_rows`` on a (2, 2, 1) (pod, data, model) mesh, rows
    over two mesh dims: each microbatch's global rows at n = 1, 2, 4,
    and the error when the rows on a rank do not split."""
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.training.train_step import (_regroup_rows,
                                                 _split_microbatch)
    mesh = meshenv.make_mesh((2, 2, 1), ("pod", "data", "model"), "cpu")
    x = torch.arange(16 * 3, dtype=torch.int32).reshape(16, 3)
    dx = sh.distribute(x, sh.batch_spec(tuple(x.shape), mesh), mesh)
    got = {n: [_full(_split_microbatch({"t": _regroup_rows(dx, n)}, n,
                                       i)["t"]) for i in range(n)]
           for n in (1, 2, 4)}
    try:
        _regroup_rows(dx, 8)
        raised = False
    except ValueError:
        raised = True
    return {"x": x, "micro": got, "raised": raised}


def _rank_main(rank, world, store, inp, out):
    torch.set_num_threads(1)
    from repro_torch.compat import meshenv
    from repro_torch.configs import get_config
    data = torch.load(inp)
    res = {}
    with meshenv.process_group("gloo", rank, world, store):
        shape = (1, 1) if world == 1 else (2, 2)
        mesh = meshenv.make_mesh(shape, ("data", "model"), "cpu")
        for arch in ARCHS:
            cfg = get_config(arch).smoke().replace(dtype="float32",
                                                   **_replace(arch))
            d = data[arch]
            if world == 1:
                res[arch] = _port_steps(cfg, d["params"], d["batch"], mesh)
                continue
            res[arch] = {
                "sharded": _port_steps(cfg, d["params"], d["batch"], mesh,
                                       micro=1),
                "plain": _port_steps(cfg, d["params"], d["batch"], None,
                                     micro=1)}
            if arch == "qwen3-8b":
                res[arch]["seq_shard"] = _port_steps(
                    cfg, d["params"], d["batch"], mesh, seq_shard=True)
        if world == 4:
            mesh4 = meshenv.make_mesh((1, 4), ("data", "model"), "cpu")
            res["seqsharded"] = {
                (m, quant): _seqsharded_case(mm, m, quant, 3)
                for m, mm in ((2, mesh), (4, mesh4)) for quant in (False,
                                                                   True)}
            res["a2a"] = _a2a_case(mesh)
            cfg = get_config("granite-moe-1b-a400m").smoke().replace(
                dtype="float32", capacity_factor=8.0)
            d = data["granite-moe-1b-a400m"]
            res["micro2"] = {
                "sharded": _micro_case(cfg, d["params"], d["batch"], mesh, 2),
                "plain": _micro_case(cfg, d["params"], d["batch"], None, 2)}
            res["regroup"] = _regroup_case()
    torch.save(res, f"{out}.{rank}")


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """Per arch: the reference's params and config, the port's params and
    a batch of tokens and labels."""
    rng = np.random.default_rng(0)
    out = {}
    for arch in ARCHS:
        cfg_j, cfg_t, pj, pt = both_params(arch, 0, **_replace(arch))
        toks = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
        labs = rng.integers(0, cfg_t.vocab_size, (B, S)).astype(np.int32)
        out[arch] = dict(cfg_j=cfg_j, pj=pj, params=pt, batch={
            "tokens": torch.from_numpy(toks),
            "labels": torch.from_numpy(labs)})
    path = tmp_path_factory.mktemp("mesh") / "inputs.pt"
    torch.save({a: {"params": v["params"], "batch": v["batch"]}
                for a, v in out.items()}, path)
    return out, str(path)


def _spawn(world, inputs, tmp_path_factory):
    d = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(_rank_main, args=(world, str(d / "store"), inputs[1],
                               str(d / "out")), nprocs=world, join=True)
    return [torch.load(f"{d / 'out'}.{r}") for r in range(world)]


@pytest.fixture(scope="module")
def host(inputs, tmp_path_factory):
    return _spawn(1, inputs, tmp_path_factory)[0]


@pytest.fixture(scope="module")
def grid2x2(inputs, tmp_path_factory):
    return _spawn(4, inputs, tmp_path_factory)


def _reference(inp, arch):
    """The reference's steps, jitted under its (1, 1) host mesh."""
    from repro.compat import meshenv as jmeshenv
    from repro.configs import InputShape
    from repro.launch.mesh import make_host_mesh
    from repro.launch.steps import (build_prefill_step, build_serve_step,
                                    build_train_step)
    from repro.training import init_opt_state
    cfg, pj = inp["cfg_j"], inp["pj"]
    batch = {k: jnp.asarray(v.numpy()) for k, v in inp["batch"].items()}
    out = {}
    with jmeshenv.mesh_context(make_host_mesh()):
        lg, cache = jax.jit(build_prefill_step(
            cfg, InputShape("p", CAP, B, "prefill")))(
                pj, {"tokens": batch["tokens"]})
        out["prefill"] = np.asarray(lg)
        serve = jax.jit(build_serve_step(cfg, InputShape("d", CAP, B,
                                                         "decode")))
        tok, logits, toks = jnp.argmax(lg, -1).astype(jnp.int32), [], []
        for _ in range(STEPS):
            lg, cache = serve(pj, cache, tok)
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
            toks.append(np.asarray(tok))
        out["serve"], out["tokens"] = np.stack(logits), np.stack(toks)
        step = jax.jit(build_train_step(cfg, InputShape("t", S, B,
                                                        "train")))
        _, met = step({"params": pj, "opt": init_opt_state(pj)}, batch)
        out["metrics"] = {k: float(v) for k, v in met.items()}
    return out


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("arch", ARCHS)
def test_host_mesh_steps_equal_the_reference(inputs, host, arch):
    want, got = _reference(inputs[0][arch], arch), host[arch]
    assert _rel(got["prefill"].numpy(), want["prefill"]) <= 2e-5
    assert _rel(got["serve"].numpy(), want["serve"]) <= 2e-5
    np.testing.assert_array_equal(got["tokens"].numpy(), want["tokens"])
    for k in ("loss", "ce"):
        assert abs(got["metrics"][k] - want["metrics"][k]) <= \
            LOSS_REL * abs(want["metrics"][k])
    assert abs(got["metrics"]["grad_norm"] - want["metrics"]["grad_norm"]) \
        <= GNORM_REL * want["metrics"]["grad_norm"]
    assert got["metrics"]["lr"] == pytest.approx(want["metrics"]["lr"],
                                                 rel=1e-6)


def _leaves(t, p=""):
    return [x for k in sorted(t) for x in _leaves(t[k], f"{p}{k}/")] \
        if isinstance(t, dict) else [(p[:-1], t)]


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_steps_equal_the_unsharded_port(grid2x2, arch):
    for rank, res in enumerate(grid2x2):
        got, want = res[arch]["sharded"], res[arch]["plain"]
        assert _rel(got["prefill"], want["prefill"]) <= 1e-4, rank
        assert _rel(got["serve"], want["serve"]) <= 1e-4, rank
        assert torch.equal(got["tokens"], want["tokens"]), rank
        for (path, g), (_, w) in zip(_leaves(got["grads"]),
                                     _leaves(want["grads"])):
            assert _rel(g, w) <= 1e-4, (rank, path)
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                1e-4 * abs(want["metrics"][k]), (rank, k)


def test_2x2_seq_sharded_serve_equals_the_unsharded_port(grid2x2):
    for res in grid2x2:
        got, want = res["qwen3-8b"]["seq_shard"], res["qwen3-8b"]["plain"]
        assert _rel(got["serve"], want["serve"]) <= 1e-4
        assert torch.equal(got["tokens"], want["tokens"])


@pytest.mark.parametrize("m,quant", [(2, False), (2, True), (4, False),
                                     (4, True)])
def test_seqsharded_decode_equals_the_unsharded_decode(grid2x2, m, quant):
    owners = 0
    for res in grid2x2:
        case = res["seqsharded"][(m, quant)]
        assert case["err"] <= 2e-5
        assert case["caches"] and case["same_objects"]
        # a rank's chunk changes only where the write slot falls in it
        assert all(c == case["owns"] for c in case["changed"])
        owners += case["owns"]
    assert owners == 4 // m      # one owner per data shard


def test_moe_a2a_equals_the_einsum_path(grid2x2):
    for res in grid2x2:
        assert res["a2a"]["err"] <= 1e-5
        assert res["a2a"]["a2a_calls"] == 2


def test_moe_aux_on_the_2x2_mesh_equals_the_shards_aux(grid2x2):
    """The a2a aux is the reference's per-shard aux (``route`` on each
    rank's B/2 rows of S/2 tokens) averaged over the four shards; the
    einsum path's aux on the mesh is the unsharded aux."""
    from repro.models import moe as jmoe
    from repro.models.config import ModelConfig as JConfig
    _, params, x = _a2a_inputs()
    cfg_j = JConfig(**_A2A_CFG)
    router = jnp.asarray(params["layers"]["router"][0].numpy())
    xs = x.numpy()
    want = np.mean([float(jmoe.route(cfg_j, router, jnp.asarray(
        xs[2 * d:2 * d + 2, 8 * r:8 * r + 8]))[2])
        for d in range(2) for r in range(2)])
    whole = float(jmoe.route(cfg_j, router, jnp.asarray(xs))[2])
    assert abs(want - whole) > 1e-4       # the shards' mean is not the whole
    for res in grid2x2:
        assert abs(res["a2a"]["aux"] - want) <= 1e-6
        assert abs(res["a2a"]["einsum_aux"] - whole) <= 1e-6
        assert abs(res["a2a"]["plain_aux"] - whole) <= 1e-6


def test_2x2_microbatches_hold_the_reference_rows(grid2x2):
    """granite-moe at 2 microbatches on the (2, 2) mesh: each microbatch
    holds the unsharded port's rows (the reference's), so its aux loss,
    not linear in its rows, and its CE equal the unsharded ones, and the
    train step's loss and grad norm equal the unsharded step's."""
    for rank, res in enumerate(grid2x2):
        got, want = res["micro2"]["sharded"], res["micro2"]["plain"]
        for g, w in zip(got["micro"], want["micro"]):
            assert torch.equal(g["tokens"], w["tokens"]), rank
            for k in ("ce", "aux"):
                assert abs(g[k] - w[k]) <= 1e-5 * abs(w[k]), (rank, k)
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                1e-4 * abs(want["metrics"][k]), (rank, k)


def test_regroup_rows_over_two_mesh_dims(grid2x2):
    for res in grid2x2:
        case = res["regroup"]
        for n, mbs in case["micro"].items():
            rows = 16 // n
            for i, mb in enumerate(mbs):
                assert torch.equal(mb, case["x"][i * rows:(i + 1) * rows])
        assert case["raised"]       # 4 rows per rank, 8 microbatches


# ------------------------------------------------------ no-mesh fallbacks
def test_seqsharded_decode_no_mesh_fallback_matches_the_reference():
    from repro.models.attention import \
        decode_attention_seqsharded as jseqsharded
    from repro_torch.models.attention import decode_attention_seqsharded
    ks = jax.random.split(jax.random.PRNGKey(0), 5)
    b, s, h, hkv, d = 3, 48, 4, 2, 16
    arrs = [np.asarray(jax.random.normal(k, shp)) for k, shp in zip(ks, [
        (b, 1, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, 1, hkv, d),
        (b, 1, hkv, d)])]
    want, kc_j, _ = jseqsharded(*map(jnp.asarray, arrs),
                                jnp.asarray(20, jnp.int32),
                                jnp.asarray(21, jnp.int32))
    t = [torch.from_numpy(a.copy()) for a in arrs]
    got, kc_t, _ = decode_attention_seqsharded(*t, torch.tensor(20),
                                               torch.tensor(21))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_array_equal(kc_t.numpy(), np.asarray(kc_j))
    assert kc_t is t[1]          # written in place


def _decode_pair(arch, quant, flags):
    """(port, reference) logits of one decode step after a prefill, the
    step under ``flags`` (no mesh), on one perturbed tree."""
    from repro.models import registry as jregistry
    from repro.models import runtime as jruntime
    from repro_torch.models import registry
    cfg_j, cfg_t, pj, pt = both_params(arch, 0, kv_quant=quant)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 32))
    fj, ft = jregistry.get_family(cfg_j), registry.get_family(cfg_t)
    lg_j, c_j = fj.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                           q_chunk=32, kv_chunk=32, capacity=48)
    lg_t, c_t = ft.prefill(pt, cfg_t, {"tokens": torch.from_numpy(toks)},
                           capacity=48)
    nt = np.asarray(jnp.argmax(lg_j, -1)).astype(np.int32)
    base_t, _ = ft.decode_step(pt, cfg_t, copy.deepcopy(c_t),
                               torch.from_numpy(nt))
    with jruntime.perf_flags(**flags):
        alt_j, _ = fj.decode_step(pj, cfg_j, c_j, jnp.asarray(nt))
    with runtime.perf_flags(**flags):
        alt_t, _ = ft.decode_step(pt, cfg_t, c_t, torch.from_numpy(nt))
    return base_t.numpy(), alt_t.numpy(), np.asarray(alt_j)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_decode_step_under_seq_shard_flag_falls_back(quant):
    base, alt, ref = _decode_pair("qwen3-8b", quant,
                                  {"decode_seq_shard_": True})
    np.testing.assert_allclose(alt, base, atol=2e-4)
    np.testing.assert_allclose(alt, ref, atol=1e-3 if quant else 1e-4)


def test_flags_reset_after_context():
    assert not runtime.seq_parallel()
    with runtime.perf_flags(seq_parallel_=True, gqa_native_=True):
        assert runtime.seq_parallel() and runtime.gqa_native()
    assert not runtime.seq_parallel() and not runtime.gqa_native()
    with runtime.roofline_lowering():
        assert runtime.roofline_mode()
    assert not runtime.roofline_mode()


def test_decode_step_value_invariant_under_flags():
    base, alt, ref = _decode_pair("qwen3-8b", False,
                                  {"decode_seq_shard_": True,
                                   "gqa_native_": True})
    np.testing.assert_allclose(alt, base, atol=2e-4)
    np.testing.assert_allclose(alt, ref, atol=1e-4)


def test_gqa_native_changes_no_value():
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 40, 8, 32, generator=g)
    k, v = (torch.randn(2, 40, 2, 32, generator=g) for _ in range(2))
    for causal, window in ((True, None), (True, 16), (False, None)):
        base = ops.attention(q, k, v, causal=causal, window=window)
        with runtime.perf_flags(gqa_native_=True):
            alt = ops.attention(q, k, v, causal=causal, window=window)
        torch.testing.assert_close(alt, base, atol=2e-6, rtol=0)


def test_moe_a2a_no_mesh_fallback_matches_the_reference():
    from repro.models import moe as jmoe
    from repro.models import runtime as jruntime
    from repro.models.config import ModelConfig as JConfig
    from repro_torch.models import bridge, moe
    from repro_torch.models.config import ModelConfig
    kw = dict(name="m", family="moe", n_layers=2, d_model=64, n_heads=4,
              n_kv_heads=2, d_ff=32, vocab_size=512, head_dim=16,
              n_experts=4, top_k=2, capacity_factor=8.0, dtype="float32")
    cfg_j, cfg_t = JConfig(**kw), ModelConfig(**kw)
    pj = jmoe.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (2, 16, 64)))
    lpj = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    lpt = {k: v[0] for k, v in pt["layers"].items()
           if not isinstance(v, dict)}
    ref, _ = jmoe.moe_mlp(cfg_j, lpj, jnp.asarray(x))
    with jruntime.perf_flags(moe_a2a_=True):
        ref_a2a, _ = jmoe.moe_mlp(cfg_j, lpj, jnp.asarray(x))
    base, _ = moe.moe_mlp(cfg_t, lpt, torch.from_numpy(x))
    with runtime.perf_flags(moe_a2a_=True):
        out, _ = moe.moe_mlp(cfg_t, lpt, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), base.numpy(), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_a2a), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ref_a2a), np.asarray(ref),
                               atol=1e-6)
