"""The hybrid, ssm and audio families under the mesh, in spawned gloo
ranks on the CPU.

* On a (1, 1) mesh of one rank, the port's ``build_train_step``,
  ``build_prefill_step`` and ``build_serve_step`` for recurrentgemma-9b
  (five layers: one (rec, rec, attn) group and the two-layer recurrent
  tail, at the published head width 256), xlstm-1.3b (three layers of
  the pattern (m, s): one group and an mLSTM tail) and whisper-base,
  float32 smoke configs
  fed DTensors sharded by ``launch.sharding``, equal the reference's steps
  jitted under ``repro.compat.meshenv.mesh_context(make_host_mesh())``:
  the loss within 1e-5 and the grad norm within 1e-4 relative, the
  logits within 2e-5 of max|logit|, the greedy tokens equal.
* On a (2, 2) mesh of 4 ranks they equal the unsharded port
  (``tests/test_torch_mesh_families_2x2.py``, which shares this file's
  inputs and steps).
* The hybrid's prompt (80 tokens) is longer than its 64-position smoke
  window, so the prefill builds the ring from a wrapped window (80 % 64 =
  16, no ``roll``) and the serve steps write the ring in place.

Weights: the JAX package's init with biases and norm scales perturbed
(``test_torch_dense_variants.perturbed``), bridged to the port.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import _InputShape
from test_torch_dense_variants import both_params

ARCHS = ("recurrentgemma-9b", "xlstm-1.3b", "whisper-base")
B, S, CAP, STEPS = 2, 80, 96, 3
LOSS_REL, GNORM_REL = 1e-5, 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _replace(arch):
    return {"recurrentgemma-9b": dict(n_layers=5, head_dim=256),
            "xlstm-1.3b": dict(n_layers=3, xlstm_pattern=("m", "s"))
            }.get(arch, {})


def _shapes(b=B):
    return {"train": _InputShape("t", S, b, "train"),
            "prefill": _InputShape("p", CAP, b, "prefill"),
            "decode": _InputShape("d", CAP, b, "decode")}


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def _inputs_of(batch):
    return {k: v for k, v in batch.items() if k != "labels"}


def _port_steps(cfg, params, batch, mesh, micro=None):
    """The port's three steps on ``params`` (plain, or sharded on
    ``mesh``): prefill logits, ``STEPS`` greedy serve steps and the cache
    after them, the train step's metrics and the gradients of
    ``loss_and_grads``."""
    from repro_torch.compat import meshenv
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import (build_prefill_step,
                                          build_serve_step, build_train_step)
    from repro_torch.training import init_opt_state
    from repro_torch.training.train_step import loss_and_grads
    shp = _shapes(batch["tokens"].shape[0])

    def put(tree, specs):
        return tree if mesh is None else sh.distribute(tree, specs, mesh)

    def ctx():
        return meshenv.mesh_context(mesh) if mesh is not None else \
            contextlib.nullcontext()

    pspecs = None if mesh is None else sh.params_shardings(params, mesh)
    bspecs = None if mesh is None else sh.batch_shardings(batch, mesh)
    out = {}
    with ctx(), torch.no_grad():
        dp = put(_tree_map(torch.clone, params), pspecs)
        inp = _inputs_of(batch)
        lg, cache = build_prefill_step(cfg, shp["prefill"])(
            dp, put(inp, None if mesh is None else
                    sh.batch_shardings(inp, mesh)))
        out["prefill"] = sh.gather(lg)
        serve = build_serve_step(cfg, shp["decode"])
        tok, logits, toks_out = out["prefill"].argmax(-1).to(torch.int32), \
            [], []
        for _ in range(STEPS):
            t_in = tok if mesh is None else sh.distribute(
                tok, sh.batch_spec(tuple(tok.shape), mesh), mesh)
            lg, cache = serve(dp, cache, t_in)
            logits.append(sh.gather(lg))
            tok = logits[-1].argmax(-1).to(torch.int32)
            toks_out.append(tok)
        out["serve"], out["tokens"] = torch.stack(logits), torch.stack(
            toks_out)
        out["cache"] = sh.gather(cache)
    with ctx():
        _, _, grads = loss_and_grads(put(_tree_map(torch.clone, params),
                                         pspecs), cfg, put(batch, bspecs))
        out["grads"] = sh.gather(grads)
        state = {"params": _tree_map(torch.clone, params)}
        state["opt"] = init_opt_state(state["params"])
        sspecs = None if mesh is None else {
            "params": pspecs, "opt": sh.opt_shardings(pspecs)}
        _, met = build_train_step(cfg, shp["train"], microbatches=micro)(
            put(state, sspecs), put(batch, bspecs))
        out["metrics"] = {k: float(sh.gather(v)) for k, v in met.items()}
    return out


def _rank_main(rank, world, store, inp, out):
    torch.set_num_threads(1)
    from repro_torch.compat import meshenv
    from repro_torch.configs import get_config
    data = torch.load(inp)
    res = {}
    with meshenv.process_group("gloo", rank, world, store):
        shape = (1, 1) if world == 1 else (2, 2)
        mesh = meshenv.make_mesh(shape, ("data", "model"), "cpu")
        for case, d in data.items():
            cfg = get_config(d["arch"]).smoke().replace(dtype="float32",
                                                        **d["replace"])
            if world == 1:
                res[case] = _port_steps(cfg, d["params"], d["batch"], mesh)
                continue
            res[case] = {
                "sharded": _port_steps(cfg, d["params"], d["batch"], mesh,
                                       micro=1),
                "plain": _port_steps(cfg, d["params"], d["batch"], None,
                                     micro=1)}
    torch.save(res, f"{out}.{rank}")


def make_inputs(cases, tmp_path_factory):
    """Per case ``{name: (arch, config replacements, batch rows)}``: the
    reference's params and config, the port's params and a batch of
    tokens and labels (and whisper's frame embeddings); and the file the
    spawned ranks read them from."""
    rng = np.random.default_rng(0)
    out = {}
    for case, (arch, replace, b) in cases.items():
        cfg_j, cfg_t, pj, pt = both_params(arch, 0, **replace)
        batch = {k: rng.integers(0, cfg_t.vocab_size, (b, S)).astype(
            np.int32) for k in ("tokens", "labels")}
        if cfg_t.family == "audio":
            batch["encoder_embeds"] = rng.standard_normal(
                (b, cfg_t.encoder_seq, cfg_t.d_model)).astype(np.float32)
        out[case] = dict(arch=arch, replace=replace, cfg_j=cfg_j, pj=pj,
                         params=pt, batch={k: torch.from_numpy(v)
                                           for k, v in batch.items()})
    path = tmp_path_factory.mktemp("mesh") / "inputs.pt"
    torch.save({c: {k: v[k] for k in ("arch", "replace", "params", "batch")}
                for c, v in out.items()}, path)
    return out, str(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_inputs({a: (a, _replace(a), B) for a in ARCHS},
                       tmp_path_factory)


def spawn(world, inputs, tmp_path_factory, main=_rank_main):
    """``main(rank, world, store, inputs file, out prefix)`` on ``world``
    spawned ranks; each rank's saved results."""
    d = tmp_path_factory.mktemp(f"world{world}")
    mp.spawn(main, args=(world, str(d / "store"), inputs[1],
                               str(d / "out")), nprocs=world, join=True)
    return [torch.load(f"{d / 'out'}.{r}") for r in range(world)]


@pytest.fixture(scope="module")
def host(inputs, tmp_path_factory):
    return spawn(1, inputs, tmp_path_factory)[0]


def _reference(inp):
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
            cfg, InputShape("p", CAP, B, "prefill")))(pj, _inputs_of(batch))
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


def _leaves(t, p=""):
    if isinstance(t, dict):
        return [x for k in sorted(t) for x in _leaves(t[k], f"{p}{k}/")]
    if isinstance(t, list):
        return [x for i, v in enumerate(t) for x in _leaves(v, f"{p}{i}/")]
    return [(p[:-1], t)]


def check_against_plain(results, case):
    """Each rank's sharded steps of ``case`` against its unsharded ones:
    logits within 1e-4 of max|logit|, greedy tokens equal, every gradient
    within 1e-4 of its leaf's max|g|, the loss and grad norm within 1e-4
    relative."""
    for rank, res in enumerate(results):
        got, want = res[case]["sharded"], res[case]["plain"]
        assert _rel(got["prefill"], want["prefill"]) <= 1e-4, rank
        assert _rel(got["serve"], want["serve"]) <= 1e-4, rank
        assert torch.equal(got["tokens"], want["tokens"]), rank
        for (path, g), (_, w) in zip(_leaves(got["grads"]),
                                     _leaves(want["grads"])):
            assert _rel(g, w) <= 1e-4, (rank, path)
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                1e-4 * abs(want["metrics"][k]), (rank, k)


def check_cache_against_plain(results, case, want_paths):
    """Each rank's cache after the sharded prefill and ``STEPS`` serve
    steps of ``case`` against the unsharded one, leaf for leaf within
    1e-4 of its largest |value|; ``want_paths`` must be among its
    leaves."""
    for rank, res in enumerate(results):
        got = dict(_leaves(res[case]["sharded"]["cache"]))
        want = dict(_leaves(res[case]["plain"]["cache"]))
        assert sorted(got) == sorted(want) and want_paths <= set(want)
        for path, w in want.items():
            g = got[path]
            assert g.shape == w.shape and g.dtype == w.dtype, (rank, path)
            if path == "length":
                assert int(g) == int(w) == S + STEPS
                continue
            assert _rel(g, w) <= 1e-4, (rank, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_host_mesh_steps_equal_the_reference(inputs, host, arch):
    want, got = _reference(inputs[0][arch]), host[arch]
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
