"""The port's dry run (mirrors ``tests/test_launch.py``
``TestCollectiveParser``), on fake process groups in this process.

* One ``all_gather`` on a fake 16-rank group counts its result bytes as
  an all-gather, and nothing else.
* An add followed by a 128 x 128 float32 matmul counts only the matmul's
  operands and result toward the HBM traffic, ``3 * 128*128*4``, and the
  matmul's 2 * 128^3 FLOPs.
* ``lower_one`` of ``("qwen3-8b", "train_4k")`` and
  ``("granite-moe-1b-a400m", "decode_32k")`` runs on the fake 256-rank
  (32, 8) mesh: the reports have the reference's keys and its microbatch
  counts, ``model_flops`` is the reference's formula exactly, and the
  per-device argument bytes are those of the local shards
  (``check_lower_one``, which ``tests/test_torch_dryrun_hybrid.py`` and
  ``tests/test_torch_dryrun_ssm_audio.py`` hold the other families to,
  each file a worker's share of the time).
* ``sharding.cache_shardings``, ``distribute`` and ``gather`` walk the
  hybrid cache's ``tail`` list, its index the path component.
"""

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.compat import meshenv
from repro_torch.configs import _INPUT_SHAPES, get_config
from repro_torch.launch import dryrun

REPORT_KEYS = {"arch", "shape", "kind", "mesh", "perf_variant", "compile_s",
               "memory", "roofline_compile_s", "per_device",
               "collective_bytes", "roofline"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
ROOFLINE_KEYS = {"compute_ms", "memory_ms", "collective_ms", "dominant",
                 "model_flops", "hlo_flops_global", "useful_fraction"}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def test_all_gather_counts_its_result_bytes():
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    with meshenv.fake_process_group(16):
        fake = FakeTensorMode(allow_non_fake_inputs=True)
        with fake:
            x = torch.empty(2, 1024, dtype=torch.bfloat16)
        c = dryrun.Counter(fake)
        with c:
            out = funcol.all_gather_single(x, 0, dist.group.WORLD)
            out = funcol.wait_tensor(out)
    assert tuple(out.shape) == (32, 1024)
    assert c.coll == {"all-gather": 32 * 1024 * 2, "all-reduce": 0,
                      "reduce-scatter": 0, "all-to-all": 0,
                      "collective-permute": 0}
    assert c.flops == 0


def test_hbm_rule_skips_elementwise():
    fake = FakeTensorMode()
    with fake:
        p0, p1 = torch.empty(128, 128), torch.empty(128, 128)
    c = dryrun.Counter(fake)
    with c:
        (p0 + p1) @ p1
    assert c.hbm == 3 * 128 * 128 * 4
    assert c.flops == 2 * 128 ** 3
    assert sum(c.coll.values()) == 0


def _model_flops(arch, shape):
    """The reference's formula (``repro.launch.dryrun``)."""
    from repro.configs import INPUT_SHAPES, get_config as jget
    cfg, shp = jget(arch, shape), INPUT_SHAPES[shape]
    tokens = shp.global_batch * (shp.seq_len if shp.kind != "decode" else 1)
    return (6.0 if shp.kind == "train" else 2.0) * cfg.n_active_params() \
        * tokens


@pytest.mark.parametrize("arch,shape", [("qwen3-8b", "train_4k"),
                                        ("granite-moe-1b-a400m",
                                         "decode_32k")])
def test_lower_one_reports_on_the_h100_mesh(arch, shape):
    check_lower_one(arch, shape)


def check_lower_one(arch, shape):
    """``lower_one(arch, shape)``'s report on the (32, 8) mesh: the
    reference's keys and microbatch count and ``model_flops``, positive
    counts, collectives of FSDP and of ``model``, and argument bytes equal
    to one rank's shards of the inputs."""
    from repro.launch.steps import TRAIN_MICROBATCHES
    rep = dryrun.lower_one(arch, shape, device="cpu")
    assert REPORT_KEYS <= set(rep)
    assert set(rep["memory"]) == MEMORY_KEYS
    assert set(rep["roofline"]) == ROOFLINE_KEYS
    assert set(rep["collective_bytes"]) == set(dryrun._COLLECTIVES)
    assert rep["mesh"] == "32x8" and rep["kind"] == _INPUT_SHAPES[shape].kind
    assert rep.get("microbatches") == (TRAIN_MICROBATCHES[arch]
                                       if shape == "train_4k" else None)
    assert rep["roofline"]["model_flops"] == _model_flops(arch, shape)
    assert rep["roofline"]["hlo_flops_global"] == \
        rep["per_device"]["flops"] * 256
    assert rep["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rep["per_device"]["flops"] > 0
    assert rep["per_device"]["bytes_accessed"] > 0
    # the step gathers FSDP weights over "data" and sums over "model"
    assert rep["collective_bytes"]["all-gather"] > 0
    assert rep["collective_bytes"]["all-reduce"] > 0
    mem = rep["memory"]
    assert mem["peak_bytes"] == mem["temp_bytes"] + mem["argument_bytes"]
    # argument bytes: each input leaf over the mesh axes of its spec
    from repro_torch.launch.specs import input_specs
    specs = input_specs(arch, shape)
    assert mem["argument_bytes"] == _shard_bytes(specs)
    if arch in ("qwen3-8b", "granite-moe-1b-a400m"):
        # the whole inputs over the shards, within what the unshardable
        # leaves (norm scales, the replicated step count) add; in the
        # hybrid, ssm and audio families the leaves that shard over one
        # axis or none (positional tables, ``lam``, biases, a batch-1
        # cache) weigh more than 5%
        total = sum(t.numel() * t.element_size() for t in _tensors(specs))
        assert total / 256 <= mem["argument_bytes"] <= total / 256 * 1.05


def _shard_bytes(specs):
    """Bytes of one rank's shards of the step's inputs on the (32, 8)
    mesh, from ``launch.sharding``'s specs."""
    from repro_torch.launch import sharding as sh
    mesh = {"data": 32, "model": 8}

    def local(tree, spec):
        if isinstance(tree, dict):
            return sum(local(v, spec[k]) for k, v in tree.items())
        if isinstance(tree, list):
            return sum(local(v, s) for v, s in zip(tree, spec))
        n = 1
        for entry in spec:
            for a in ((entry,) if isinstance(entry, str) else entry or ()):
                n *= mesh[a]
        return tree.numel() * tree.element_size() // n

    if "state" in specs:
        ps = sh.params_shardings(specs["state"]["params"], mesh)
        return local(specs["state"], {"params": ps,
                                      "opt": sh.opt_shardings(ps)}) + \
            local(specs["batch"], sh.batch_shardings(specs["batch"], mesh))
    out = local(specs["params"], sh.params_shardings(specs["params"], mesh))
    if "batch" in specs:
        return out + local(specs["batch"],
                           sh.batch_shardings(specs["batch"], mesh))
    tok = specs["token"]
    return out + local(specs["cache"], sh.cache_shardings(
        specs["cache"], mesh)) + local(tok, sh.batch_spec(tuple(tok.shape),
                                                          mesh))


def _tensors(specs):
    out = []

    def walk(t):
        if isinstance(t, dict):
            for v in t.values():
                walk(v)
        elif isinstance(t, list):
            for v in t:
                walk(v)
        elif isinstance(t, torch.Tensor):
            out.append(t)
    walk({k: v for k, v in specs.items() if k not in ("cfg", "shape")})
    return out


def test_cache_shardings_walk_the_tail_list():
    """recurrentgemma-9b at five layers: a group of (rec, rec, attn) and a
    tail list of two recurrent layers.  Each tail entry's spec is
    ``cache_spec`` of its ``tail/<index>/<name>`` path, and ``distribute``
    then ``gather`` on a one-rank mesh return every leaf, lists kept."""
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.specs import cache_struct
    cfg = get_config("recurrentgemma-9b").smoke().replace(n_layers=5)
    cache = cache_struct(cfg, 4, 96)
    assert isinstance(cache["tail"], list) and len(cache["tail"]) == 2
    mesh = {"data": 2, "model": 2}
    specs = sh.cache_shardings(cache, mesh)
    assert isinstance(specs["tail"], list) and len(specs["tail"]) == 2
    for i, st in enumerate(cache["tail"]):
        assert set(st) == {"h", "conv"}
        for name, t in st.items():
            assert specs["tail"][i][name] == sh.cache_spec(
                f"tail/{i}/{name}", tuple(t.shape), mesh)
    assert specs["groups"]["blk2"]["k"] == (None, ("data",), "model", None,
                                            None)
    real = {"tail": [{"h": torch.randn(4, 8)}, {"h": torch.randn(4, 8)}],
            "length": torch.tensor(3)}
    with meshenv.fake_process_group(1):
        m = meshenv.make_mesh((1, 1), ("data", "model"), "cpu")
        back = sh.gather(sh.distribute(real, sh.cache_shardings(real, m), m))
    assert isinstance(back["tail"], list)
    assert all(torch.equal(a["h"], b["h"])
               for a, b in zip(back["tail"], real["tail"]))


@pytest.mark.parametrize("multi_pod,want", [(False, 8), (True, 8)])
def test_microbatches_divide_each_ranks_rows(multi_pod, want):
    """train_4k's 256 rows are 8 a rank on (32, 8) and 4 on (2, 32, 8):
    the 8-microbatch archs keep the reference's 8 on both.  On (2, 32, 8)
    a microbatch's 32 rows, fewer than the 64 row shards, lie over
    ``data`` alone (``train_step._row_shards``): one row of each
    microbatch on each rank, as on (32, 8)."""
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.launch.steps import microbatches_for
    from repro_torch.training.train_step import _row_shards
    shp = _INPUT_SHAPES["train_4k"]
    with meshenv.fake_process_group(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        extents = [s for n, s in zip(mesh.mesh_dim_names, mesh.shape)
                   if n != "model"]
        for arch in ("dbrx-132b", "qwen3-32b", "command-r-plus-104b"):
            n = microbatches_for(get_config(arch, "train_4k"), shp)
            assert n == want
            keep = _row_shards(shp.global_batch // n, extents)
            assert [extents[i] for i in keep] == [32]
        assert microbatches_for(get_config("qwen3-8b", "train_4k"),
                                shp) == 4
