"""The port's sharding rules against ``repro.launch.sharding``.

* ``param_spec`` (through ``params_shardings``, ``data_fsdp`` True and
  False), ``cache_spec`` (``cache_shardings``) and ``batch_spec``
  (``batch_shardings``) give the reference's spec leaf for leaf, for every
  param leaf of all 10 configs (``repro.models.registry.params_shape``)
  and every cache leaf of every family (``launch.specs.cache_struct``:
  the hybrid and ssm caches' stacked groups and ``tail`` lists, whisper's
  rings and cross K/V), on five meshes: (1, 1), (16, 16),
  (2, 16, 16), (32, 8) and (2, 32, 8).  The reference's rules read only a
  mesh's ``shape`` and ``axis_names``, so both take stand-ins of axis
  sizes; its ``*_shardings`` wrap each spec in a ``NamedSharding``, which
  is patched to return the spec.
* ``placements`` cuts the shards DTensor expects: on a spawned 2 x 2 gloo
  mesh, ``sharding.distribute`` of a qwen3-8b smoke tree gives every rank
  the local shard shapes the specs say, and the shards gather back to the
  tensors.
"""

import math
import os

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.launch import sharding as sh

MESHES = [(("data", "model"), (1, 1)), (("data", "model"), (16, 16)),
          (("pod", "data", "model"), (2, 16, 16)),
          (("data", "model"), (32, 8)),
          (("pod", "data", "model"), (2, 32, 8))]
ARCHS = ["qwen3-8b", "qwen3-32b", "starcoder2-7b", "command-r-plus-104b",
         "granite-moe-1b-a400m", "dbrx-132b", "qwen2-vl-7b",
         "recurrentgemma-9b", "xlstm-1.3b", "whisper-base"]
COVERED = ["qwen3-8b", "starcoder2-7b", "command-r-plus-104b",
           "qwen2-vl-7b", "granite-moe-1b-a400m", "dbrx-132b",
           "recurrentgemma-9b", "xlstm-1.3b", "whisper-base"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


class _StandIn:
    """A mesh as the reference's rules read it: axis names and sizes."""

    def __init__(self, names, sizes):
        self.axis_names = names
        self.shape = dict(zip(names, sizes))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k],
                                                       f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [p for i, v in enumerate(tree)
                for p in _paths(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


@pytest.fixture
def jsh(monkeypatch):
    import repro.launch.sharding as jsh
    monkeypatch.setattr(jsh, "NamedSharding", lambda mesh, spec: spec)
    return jsh


def _norm(spec):
    """A spec with one-name tuples as the name (JAX's ``PartitionSpec``
    writes ``("data",)`` as ``"data"``)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in spec)


def _specs_equal(got, want):
    g, w = dict(_paths(got)), dict(_paths(want))
    assert sorted(g) == sorted(w)
    for path in w:
        assert _norm(g[path]) == _norm(w[path]), path


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_the_reference(jsh, arch):
    from repro.configs import get_config as jget
    from repro.models import registry as jregistry
    shapes = jregistry.params_shape(jget(arch))
    tree = jax.tree_util.tree_map(lambda s: s, shapes)
    for names, sizes in MESHES:
        mesh = dict(zip(names, sizes))
        for fsdp in (True, False):
            want = jsh.params_shardings(tree, _StandIn(names, sizes),
                                        data_fsdp=fsdp)
            got = sh.params_shardings(_as_dict(tree), mesh, data_fsdp=fsdp)
            _specs_equal(got, _as_dict(want))


def _as_dict(tree):
    """A JAX pytree of dicts and lists as nested dicts (list index keys as
    strings, the path the reference joins); specs stay leaves."""
    if isinstance(tree, dict):
        return {k: _as_dict(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return {str(i): _as_dict(v) for i, v in enumerate(tree)}
    return tree


def _struct(tree):
    """``jax.ShapeDtypeStruct``s of a cache's shapes, its dicts and lists
    (the hybrid and ssm caches' ``tail``) kept."""
    if isinstance(tree, dict):
        return {k: _struct(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_struct(v) for v in tree]
    return jax.ShapeDtypeStruct(tuple(tree.shape), np.float32)


@pytest.mark.parametrize("arch", COVERED)
def test_cache_and_batch_specs_match_the_reference(jsh, arch):
    from repro_torch.configs import get_config
    from repro_torch.launch.specs import batch_struct, cache_struct
    cfg = get_config(arch, "decode_32k")
    cache = cache_struct(cfg, 128, 32768)
    jcache = _struct(cache)
    batch = batch_struct(cfg, 128, 4096, with_labels=True)
    jbatch = {k: jax.ShapeDtypeStruct(tuple(v.shape), np.int32)
              for k, v in batch.items()}
    for names, sizes in MESHES:
        stand_in, mesh = _StandIn(names, sizes), dict(zip(names, sizes))
        _specs_equal(sh.cache_shardings(cache, mesh),
                     jsh.cache_shardings(jcache, stand_in))
        _specs_equal(sh.batch_shardings(batch, mesh),
                     jsh.batch_shardings(jbatch, stand_in))
        for shape in [(7, 8), (64, 33, 5), (2,)]:
            assert _norm(sh.batch_spec(shape, mesh)) == _norm(
                jsh.batch_spec(shape, stand_in))


@pytest.mark.parametrize("path,shape", [
    ("layers/wq", (32, 4096, 4096)), ("layers/wo", (32, 4096, 4096)),
    ("embed", (151936, 4096)), ("layers/we_gate", (40, 16, 6144, 10752)),
    ("layers/we_down", (40, 16, 10752, 6144)), ("final_norm/scale", (4096,)),
    ("groups/blk0/r_z", (6, 4, 512, 512)), ("groups/blk0/conv_w", (6, 4, 8)),
    ("dec_pos", (448, 512)), ("layers/router", (24, 1024, 32)),
    ("layers/w_x", (2, 36, 4096, 4096))])
def test_param_spec_roles_and_trims(jsh, path, shape):
    """Every role of the rules, at shapes where some axes do not divide."""
    for names, sizes in MESHES + [(("data", "model"), (3, 7))]:
        assert _norm(sh.param_spec(path, shape, dict(zip(names, sizes)))) \
            == _norm(jsh.param_spec(path, shape, _StandIn(names, sizes)))


def test_placements_nest_pod_and_data():
    from torch.distributed.tensor import Replicate, Shard

    class Mesh:
        mesh_dim_names = ("pod", "data", "model")
        shape = (2, 32, 8)
    assert sh.placements((("pod", "data"), None, "model"), Mesh()) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sh.placements((), Mesh()) == [Replicate()] * 3
    with pytest.raises(ValueError, match="mesh order"):
        sh.placements((("data", "pod"),), Mesh())
    Mesh.shape = (1, 32, 1)      # a dim of one is whole on its one rank
    assert sh.placements((("pod", "data"), None, "model"), Mesh()) == \
        [Replicate(), Shard(0), Replicate()]


def _rank_shards(rank, world, path, out):
    """One rank of a 2 x 2 gloo mesh: distribute a qwen3-8b smoke tree by
    its specs, record each leaf's local shape, and gather each leaf
    back."""
    torch.set_num_threads(1)
    from repro_torch.compat import meshenv
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    with meshenv.process_group("gloo", rank, world, path):
        mesh = meshenv.make_mesh((2, 2), ("data", "model"), "cpu")
        params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
        specs = sh.params_shardings(params, mesh)
        dt = sh.distribute({k: v for k, v in params.items()}, specs, mesh)
        local = {p: tuple(t.to_local().shape) for p, t in _paths(dt)}
        same = all(torch.equal(a.full_tensor(), b) for (_, a), (_, b) in
                   zip(_paths(dt), _paths(params)))
        torch.save({"local": local, "same": same, "coord":
                    mesh.get_coordinate()}, f"{out}.{rank}")


def test_distribute_cuts_the_shards_the_specs_say(tmp_path):
    from repro_torch.configs import get_config
    from repro_torch.models import registry
    out = str(tmp_path / "shards")
    mp.spawn(_rank_shards, args=(4, str(tmp_path / "store"), out), nprocs=4,
             join=True)
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    params = registry.init(cfg, torch.Generator().manual_seed(0), "cpu")
    mesh = {"data": 2, "model": 2}
    specs = dict(_paths(sh.params_shardings(params, mesh)))
    for rank in range(4):
        got = torch.load(f"{out}.{rank}")
        assert got["same"]
        for p, t in _paths(params):
            want = list(t.shape)
            for d, entry in enumerate(specs[p]):
                axes = (entry,) if isinstance(entry, str) else entry or ()
                want[d] //= math.prod(mesh[a] for a in axes)
            assert got["local"][p] == tuple(want), (rank, p)
    assert os.path.exists(f"{out}.3")
