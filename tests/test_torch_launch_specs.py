"""The port's input specs against ``repro.launch.specs`` (mirrors
``tests/test_launch.py`` ``TestInputSpecs``).

The reference's six (arch x shape) cases, one for each arch they
leave out and one more cache for each of the hybrid, ssm and audio
families: the structure ``TestInputSpecs`` checks, and every leaf's
shape and dtype equal to the reference's ``input_specs`` (the port's are
fake tensors, the reference's ``ShapeDtypeStruct``s).  ``grid()`` has the
reference's 40 entries; qwen3-8b's ``long_500k`` cache is a 4096 ring;
xlstm-1.3b's is O(1) in the sequence; ``reduced_depth``,
``n_groups_of`` and ``state_shape`` equal the reference's.
"""

import jax
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.configs import _INPUT_SHAPES, get_config, grid
from repro_torch.launch.specs import (input_specs, n_groups_of,
                                      reduced_depth)
from repro_torch.training.train_step import state_shape

CASES = [("qwen3-8b", "train_4k"), ("dbrx-132b", "decode_32k"),
         ("whisper-base", "prefill_32k"), ("xlstm-1.3b", "long_500k"),
         ("qwen2-vl-7b", "train_4k"), ("recurrentgemma-9b", "decode_32k"),
         # the archs the reference's cases leave out
         ("starcoder2-7b", "decode_32k"), ("granite-moe-1b-a400m",
                                            "train_4k"),
         ("qwen3-32b", "prefill_32k"), ("command-r-plus-104b", "long_500k"),
         # the hybrid, ssm and audio families' other caches
         ("recurrentgemma-9b", "long_500k"), ("xlstm-1.3b", "decode_32k"),
         ("whisper-base", "decode_32k")]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                        f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tuple(tree.shape),
             str(tree.dtype).replace("torch.", ""))]


def _jax_leaves(tree):
    return [(p, s, "bfloat16" if d == "bfloat16" else str(np.dtype(d)))
            for p, s, d in _leaves(jax.tree_util.tree_map(lambda a: a,
                                                          tree))]


@pytest.mark.parametrize("arch,shape", CASES)
def test_struct_shapes_match_the_reference(arch, shape):
    from repro.launch.specs import input_specs as jinput_specs
    specs = input_specs(arch, shape)
    shp = _INPUT_SHAPES[shape]
    if shp.kind == "train":
        b = specs["batch"]
        lead = (b.get("tokens") if "tokens" in b else b["embeds"]).shape[0]
        assert lead == shp.global_batch
        assert b["labels"].shape[1] == shp.seq_len
        assert "state" in specs
    elif shp.kind == "decode":
        assert tuple(specs["token"].shape) == (shp.global_batch, 1)
        assert all(isinstance(t, FakeTensor)
                   for _, t in _fake_leaves(specs["cache"]))
    want = jinput_specs(arch, shape)
    assert specs["cfg"] == specs["cfg"].replace()
    for key in ("state", "params", "batch", "cache", "token"):
        assert (key in specs) == (key in want)
        if key in want:
            assert _leaves(specs[key]) == _jax_leaves(want[key]), key


def _fake_leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _fake_leaves(tree[k],
                                                             f"{prefix}{k}/")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in _fake_leaves(v, f"{prefix}{i}/")]
    return [(prefix[:-1], tree)]


def test_long500k_dense_gets_window():
    cfg = get_config("qwen3-8b", "long_500k")
    assert cfg.sliding_window == 4096
    specs = input_specs("qwen3-8b", "long_500k")
    assert specs["cache"]["k"].shape[2] == 4096


def test_long500k_ssm_native():
    assert get_config("xlstm-1.3b", "long_500k").sliding_window is None
    specs = input_specs("xlstm-1.3b", "long_500k")
    n = sum(t.numel() for _, t in _fake_leaves(specs["cache"]))
    assert n < 1e9


def test_grid_is_the_reference_grid():
    from repro.configs import grid as jgrid
    assert len(grid()) == 40
    assert grid() == jgrid()


@pytest.mark.parametrize("arch", sorted(dict(grid())))
def test_reduced_depth_and_groups_match_the_reference(arch):
    import dataclasses
    from repro.configs import get_config as jget
    from repro.launch.specs import n_groups_of as jn_groups_of
    from repro.launch.specs import reduced_depth as jreduced_depth
    cfg, jcfg = get_config(arch), jget(arch)
    for k in (1, 2, 3):
        assert dataclasses.asdict(reduced_depth(cfg, k)) == \
            dataclasses.asdict(jreduced_depth(jcfg, k))
    assert n_groups_of(cfg) == jn_groups_of(jcfg) >= 2
    assert reduced_depth(cfg, 2).n_layers > reduced_depth(cfg, 1).n_layers


@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "whisper-base", "xlstm-1.3b",
                                  "recurrentgemma-9b"])
def test_state_shape_matches_the_reference(arch):
    from repro.configs import get_config as jget
    from repro.training.train_step import state_shape as jstate_shape
    got = state_shape(get_config(arch))
    assert _leaves(got) == _jax_leaves(jstate_shape(jget(arch)))
    assert all(isinstance(t, FakeTensor) for _, t in _fake_leaves(got))
