"""xlstm-1.3b's sharded steps where the (2, 2) mesh of 4 spawned gloo
ranks does not divide the cells' layout, against the unsharded port.

The mLSTM and sLSTM cells run on each rank's plain local tensors: their
batch rows over ``data`` and heads over ``model`` where those axes
divide them, else whole on every rank.  The cluster's (32, 8) mesh
takes the second form for the heads (4 heads over a ``model`` of 8).
``tests/test_torch_mesh_families_2x2.py`` runs the even split; here:

* ``heads``: one head, so ``model`` (2) does not divide the heads and
  every ``model`` rank runs the cells on the whole head.  The prefill,
  the serve steps and the train step are held as the even case is:
  logits within 1e-4 of max|logit|, greedy tokens equal, every gradient
  within 1e-4 of its leaf's max|g|, the loss and grad norm within 1e-4
  relative, and every leaf of the cache within 1e-4 of the unsharded
  one's largest |value|.
* ``rows``: 3 batch rows, so ``data`` (2) does not divide them and every
  rank runs the cells on every row.  The prefill, the serve steps and the
  train step (which runs the rows whole on the ``model`` sub-mesh) are
  held as above.  The gradients are also held at the cells
  (``xlstm._mlstm_cell``, ``xlstm._slstm_sharded``) on DTensors of 3 rows
  and 4 heads over ``model``: every input's gradient, and the sLSTM's
  recurrent matrices' (replicated over ``data`` here, where split rows
  make it a partial sum), within 1e-5 of its max|g|.
"""

import pytest
import torch

from test_torch_mesh_families import (_port_steps, _rel, check_against_plain,
                                      check_cache_against_plain, make_inputs,
                                      spawn)

_LAYERS = dict(n_layers=3, xlstm_pattern=("m", "s"))
CASES = {"heads": ("xlstm-1.3b", dict(_LAYERS, n_heads=1), 2),
         "rows": ("xlstm-1.3b", _LAYERS, 3)}
CELL_ROWS, CELL_T, CELL_HEADS, CELL_DH = 3, 40, 4, 16


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _cells(mesh):
    """The two cells' outputs and gradients, sharded on ``mesh`` and
    plain, on the same seeded inputs: q, k, v (B, T, H, dh), the gate
    pre-activations (B, T, H), the sLSTM's four gate inputs (B, T, H * dh)
    and its recurrent matrices (4, H, dh, dh), with B = 3 rows."""
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.compat import meshenv
    from repro_torch.models import xlstm
    gen = torch.Generator().manual_seed(0)
    b, t, nh, dh = CELL_ROWS, CELL_T, CELL_HEADS, CELL_DH

    def rnd(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen) * scale

    mq = [rnd(b, t, nh, dh) for _ in range(3)] + [rnd(b, t, nh),
                                                  rnd(b, t, nh) + 2.0]
    sp = [rnd(b, t, nh * dh) for _ in range(4)] + [
        rnd(4, nh, dh, dh, scale=0.1)]
    # the heads over "model" as the blocks hand them over; the 3 rows
    # stay whole on the data axis, which does not divide them
    heads = [2, 2, 2, 2, 2, 2, 2, 2, 2, 1]
    weights = None

    def run(sharded):
        nonlocal weights
        leaves = [a.clone() for a in mq + sp]
        if sharded:
            leaves = [distribute_tensor(a, mesh, meshenv.placed(
                mesh, {"model": d})) for a, d in zip(leaves, heads)]
        leaves = [a.requires_grad_(True) for a in leaves]
        h, mstate = xlstm._mlstm_cell(xlstm.mlstm_chunkwise, *leaves[:5],
                                      None, 16)
        cell = (xlstm._slstm_sharded if sharded else
                lambda *a: xlstm._slstm_loop(*a[1:]))
        hs, sstate = cell(xlstm._slstm_loop, leaves[5:9], leaves[9], None,
                          nh)
        outs = [h, *mstate, hs, *sstate]
        if sharded:
            outs = [o.full_tensor() for o in outs]
        if weights is None:
            weights = [rnd(*o.shape) for o in outs]
        loss = sum((o * w).sum() for o, w in zip(outs, weights))
        grads = torch.autograd.grad(loss, leaves)
        if sharded:
            grads = [g.full_tensor() for g in grads]
        return [o.detach() for o in outs], [g.detach() for g in grads]

    plain = run(False)
    return {"sharded": run(True), "plain": plain}


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
            res[case] = {
                "sharded": _port_steps(cfg, d["params"], d["batch"], mesh,
                                       micro=1),
                "plain": _port_steps(cfg, d["params"], d["batch"], None,
                                     micro=1)}
        res["cells"] = _cells(mesh)
    torch.save(res, f"{out}.{rank}")


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    return spawn(4, make_inputs(CASES, tmp_path_factory), tmp_path_factory,
                 main=_rank_main)


@pytest.mark.parametrize("case", sorted(CASES))
def test_uneven_layout_steps_equal_the_unsharded_port(grid, case):
    check_against_plain(grid, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_uneven_layout_serve_writes_the_states(grid, case):
    check_cache_against_plain(grid, case, {"tail/0/C", "tail/0/conv",
                                           "groups/blk1/h", "groups/blk0/m",
                                           "groups/blk1/c"})


def test_uneven_rows_cell_gradients_equal_the_plain_cells(grid):
    for rank, res in enumerate(grid):
        (go, gg), (wo, wg) = res["cells"]["sharded"], res["cells"]["plain"]
        for i, (g, w) in enumerate(zip(go, wo)):
            assert g.shape == w.shape and _rel(g, w) <= 1e-5, (rank, i)
        for i, (g, w) in enumerate(zip(gg, wg)):
            assert g.shape == w.shape and _rel(g, w) <= 1e-5, (rank, i)
            assert w.abs().max() > 0, (rank, i)
