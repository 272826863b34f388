"""Train batches whose rows the data axis does not divide, on a (2, 2)
mesh of 4 spawned gloo ranks on the CPU, against the unsharded port.

Where the rows of a batch (or of a microbatch) are not divisible by the
batch axes, the train step runs them whole along those axes, on the mesh
of the other dims (``train_step.loss_and_grads``); the reference's GSPMD
pads them instead.

* ``rows``: 3 rows, 1 microbatch, for the smoke configs of qwen3-8b,
  granite-moe-1b-a400m, recurrentgemma-9b, xlstm-1.3b and whisper-base
  (float32, biases and norms perturbed): the gradients of
  ``loss_and_grads`` within 1e-4 of each leaf's max|g|, and
  ``build_train_step``'s loss and grad norm within 1e-4 relative.
* ``micro``: 4 rows in 4 microbatches, one row each, fewer than the 2
  data shards, for granite-moe-1b-a400m (whose aux loss is not linear in
  a microbatch's rows) and qwen3-8b: the accumulated gradients
  (``microbatch_grads``) and the train step held the same way.
* ``microbatches_for`` is the reference's for every cell of
  ``configs.grid()``, and on the cluster's (32, 8) and (2, 32, 8) meshes
  (fake ranks) each train cell's microbatches have ``mb`` rows, sharded
  over the row axes that divide ``mb``.
"""

import numpy as np
import pytest
import torch

from test_torch_mesh_families import _leaves, _rel, make_inputs, spawn

_HYBRID = dict(n_layers=5, head_dim=256)
_SSM = dict(n_layers=3, xlstm_pattern=("m", "s"))
# case -> (arch, config replacements, rows, microbatches)
CASES = {
    "rows-qwen3-8b": ("qwen3-8b", {}, 3, 1),
    "rows-granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, 3, 1),
    "rows-recurrentgemma-9b": ("recurrentgemma-9b", _HYBRID, 3, 1),
    "rows-xlstm-1.3b": ("xlstm-1.3b", _SSM, 3, 1),
    "rows-whisper-base": ("whisper-base", {}, 3, 1),
    "micro-granite-moe-1b-a400m": ("granite-moe-1b-a400m", {}, 4, 4),
    "micro-qwen3-8b": ("qwen3-8b", {}, 4, 4),
}
TOL = 1e-4


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _tree_map(fn, t):
    if isinstance(t, dict):
        return {k: _tree_map(fn, v) for k, v in t.items()}
    if isinstance(t, list):
        return [_tree_map(fn, v) for v in t]
    return fn(t)


def _train(cfg, params, batch, mesh, micro):
    """The gradients of ``microbatch_grads`` (``loss_and_grads`` at one
    microbatch) and the metrics of ``build_train_step`` at ``micro``
    microbatches, on ``params`` and ``batch`` sharded on ``mesh`` or
    plain."""
    import contextlib
    from repro_torch.compat import meshenv
    from repro_torch.configs import _InputShape
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.steps import build_train_step
    from repro_torch.training import init_opt_state
    from repro_torch.training.train_step import microbatch_grads
    pspecs = None if mesh is None else sh.params_shardings(params, mesh)

    def put(tree, specs):
        return tree if mesh is None else sh.distribute(tree, specs, mesh)

    bt = put(batch, None if mesh is None else sh.batch_shardings(batch,
                                                                 mesh))
    out = {}
    with meshenv.mesh_context(mesh) if mesh is not None else \
            contextlib.nullcontext():
        loss, _, grads = microbatch_grads(
            put(_tree_map(torch.clone, params), pspecs), cfg, bt, micro)
        out["grads"], out["loss"] = sh.gather(grads), float(sh.gather(loss))
        state = {"params": _tree_map(torch.clone, params)}
        state["opt"] = init_opt_state(state["params"])
        sspecs = None if mesh is None else {
            "params": pspecs, "opt": sh.opt_shardings(pspecs)}
        shp = _InputShape("t", batch["tokens"].shape[1],
                          batch["tokens"].shape[0], "train")
        _, met = build_train_step(cfg, shp, microbatches=micro)(
            put(state, sspecs), bt)
        out["metrics"] = {k: float(sh.gather(v)) for k, v in met.items()}
    return out


def _rank_main(rank, world, store, inp, out):
    torch.set_num_threads(1)
    from repro_torch.compat import meshenv
    from repro_torch.configs import get_config
    data = torch.load(inp)
    res = {}
    with meshenv.process_group("gloo", rank, world, store):
        mesh = meshenv.make_mesh((2, 2), ("data", "model"), "cpu")
        for case, d in data.items():
            cfg = get_config(d["arch"]).smoke().replace(dtype="float32",
                                                        **d["replace"])
            micro = CASES[case][3]
            res[case] = {
                "sharded": _train(cfg, d["params"], d["batch"], mesh, micro),
                "plain": _train(cfg, d["params"], d["batch"], None, micro)}
    torch.save(res, f"{out}.{rank}")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    cases = {c: v[:3] for c, v in CASES.items()}
    return spawn(4, make_inputs(cases, tmp_path_factory), tmp_path_factory,
                 main=_rank_main)


@pytest.mark.parametrize("case", sorted(CASES))
def test_uneven_rows_train_equals_the_unsharded_port(grid, case):
    for rank, res in enumerate(grid):
        got, want = res[case]["sharded"], res[case]["plain"]
        pairs = list(zip(_leaves(got["grads"]), _leaves(want["grads"])))
        assert pairs and all(gp == wp for (gp, _), (wp, _) in pairs)
        for (path, g), (_, w) in pairs:
            assert g.shape == w.shape and _rel(g, w) <= TOL, (rank, path)
        assert abs(got["loss"] - want["loss"]) <= TOL * abs(want["loss"])
        for k in ("loss", "grad_norm"):
            assert abs(got["metrics"][k] - want["metrics"][k]) <= \
                TOL * abs(want["metrics"][k]), (rank, k)


def test_microbatches_for_is_the_references():
    from repro.configs import INPUT_SHAPES, get_config as jax_get_config
    from repro.launch.steps import microbatches_for as jax_microbatches_for
    from repro_torch.configs import _INPUT_SHAPES, get_config, grid
    from repro_torch.launch.steps import microbatches_for
    cells = grid()
    assert len(cells) == 40
    for arch, shape in cells:
        assert microbatches_for(get_config(arch, shape),
                                _INPUT_SHAPES[shape]) == \
            jax_microbatches_for(jax_get_config(arch, shape),
                                 INPUT_SHAPES[shape]), (arch, shape)
    # the three 8-microbatch archs keep 8 where the port once halved
    assert microbatches_for(get_config("dbrx-132b", "train_4k"),
                            _INPUT_SHAPES["train_4k"]) == 8


@pytest.mark.parametrize("multi_pod", [False, True])
def test_microbatch_rows_on_the_cluster_mesh(multi_pod):
    """Each train cell's microbatches on the cluster's mesh of fake ranks:
    microbatch i has ``mb`` rows, sharded over the row axes whose extents
    divide ``mb`` (the rows they hold are held on gloo ranks by
    ``tests/test_torch_mesh_steps.py``; fake ranks move nothing).  On
    (2, 32, 8) the 8-microbatch archs' 32 rows lie over ``data`` alone,
    whole along ``pod``."""
    from repro_torch.compat import meshenv
    from repro_torch.configs import _INPUT_SHAPES, get_config, grid
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import microbatches_for
    from repro_torch.training.train_step import (_microbatch_rows,
                                                 _row_shards,
                                                 _split_microbatch)
    with meshenv.fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        extents = [s for n, s in zip(mesh.mesh_dim_names, mesh.shape)
                   if n != "model"]
        seen = set()
        with meshenv.mesh_context(mesh):
            for arch, shape in grid():
                shp = _INPUT_SHAPES[shape]
                if shp.kind != "train":
                    continue
                n = microbatches_for(get_config(arch, shape), shp)
                mb = shp.global_batch // n
                keep = _row_shards(mb, extents)
                ranks = int(np.prod([extents[i] for i in keep]))
                assert mb % ranks == 0 and n * mb == shp.global_batch
                if n in seen:
                    continue
                seen.add(n)
                x = torch.arange(shp.global_batch, dtype=torch.int32)[:, None]
                dx = sh.distribute(x, sh.batch_spec(tuple(x.shape), mesh),
                                   mesh)
                rows = _microbatch_rows(dx, n)
                for i in range(n):
                    part = _split_microbatch({"t": rows}, n, i)["t"]
                    assert tuple(part.shape) == (mb, 1)
                    assert part.to_local().shape[0] == mb // ranks, (arch, i)
        if multi_pod:
            n = microbatches_for(get_config("dbrx-132b", "train_4k"),
                                 _INPUT_SHAPES["train_4k"])
            assert (n, _row_shards(256 // n, extents)) == (8, (1,))
