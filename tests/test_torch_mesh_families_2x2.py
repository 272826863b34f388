"""The hybrid, ssm and audio families' sharded steps on a (2, 2) mesh of
4 spawned gloo ranks on the CPU, against the unsharded port
(``tests/test_torch_mesh_families.py`` holds the (1, 1) mesh against the
reference, and the inputs and steps both files run).

* recurrentgemma-9b, xlstm-1.3b and whisper-base, float32 smoke configs:
  logits within 1e-4 of max|logit|, every gradient within 1e-4 of its
  leaf's max|g|, greedy tokens equal.
* After the prefill and the serve steps every leaf of the cache -- the
  group states stacked on groups, the tail list's states, the rings, the
  cross K/V -- is within 1e-4 of its largest |value| of the unsharded
  one: the sharded steps write the stacked caches in place, each rank
  its own shard, the ring sharded over ``model``.
"""

import pytest
import torch

from test_torch_mesh_families import (ARCHS, check_against_plain,
                                      check_cache_against_plain, inputs,
                                      spawn)  # noqa: F401


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def grid2x2(inputs, tmp_path_factory):
    return spawn(4, inputs, tmp_path_factory)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_steps_equal_the_unsharded_port(grid2x2, arch):
    check_against_plain(grid2x2, arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_2x2_serve_writes_the_stacked_and_tail_states(grid2x2, arch):
    """After the prefill and ``STEPS`` sharded serve steps the cache --
    group states stacked on groups, the tail list's, the rings, the cross
    K/V -- holds what the unsharded steps wrote, leaf for leaf."""
    check_cache_against_plain(grid2x2, arch, {
        "recurrentgemma-9b": {"tail/0/h", "tail/1/conv", "groups/blk2/k",
                              "groups/blk0/h"},
        "xlstm-1.3b": {"tail/0/C", "tail/0/conv", "groups/blk1/h",
                       "groups/blk0/m"},
        "whisper-base": {"k", "cross_v"}}[arch])
