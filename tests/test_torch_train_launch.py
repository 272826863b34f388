"""The port's training launcher against the JAX package's, on the CPU.

``repro.launch.train`` and ``repro_torch.launch.train`` with ``--smoke``
(the port's with ``--device cpu``) run 2 steps on the same weights: the
reference's ``init_state`` draws them from ``jax.random`` and the port's
is handed the same tree through the bridge.  The losses they print must
be equal within 1e-5, for qwen3-8b, qwen2-vl-7b (one-hot embeddings of
``tokens % d_model``) and whisper-base (zero ``encoder_embeds``).  The
port's launcher writes a checkpoint that the reference restores.
"""

import re

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import train as jtrain
from repro.models import registry as jregistry
from repro.training import checkpoint as jckpt
from repro.training import init_state as jinit_state
from repro_torch.launch import train as ttrain
from repro_torch.models import bridge
from repro_torch.training import init_opt_state

LOSS_ATOL = 1e-5
FLAGS = ["--steps", "2", "--batch", "2", "--seq", "32", "--smoke",
         "--seed", "4"]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _losses(out: str) -> list:
    return [float(x) for x in re.findall(r"loss=([-0-9.]+)", out)]


@pytest.mark.parametrize("arch", ["qwen3-8b", "qwen2-vl-7b",
                                  "whisper-base"])
def test_launcher_losses_match_reference(arch, capsys, monkeypatch,
                                         tmp_path):
    assert jtrain.main(["--arch", arch, *FLAGS]) == 0
    want = _losses(capsys.readouterr().out)
    cfg_j = jax_get_config(arch).smoke().replace(dtype="float32")
    tree = jax.tree_util.tree_map(
        np.asarray, jregistry.init(jax.random.PRNGKey(4), cfg_j))

    def same_weights(cfg, generator, device):
        params = bridge.params_from_jax(tree, cfg, device)
        return {"params": params, "opt": init_opt_state(params)}

    monkeypatch.setattr(ttrain, "init_state", same_weights)
    path = str(tmp_path / "state.msgpack")
    assert ttrain.main(["--arch", arch, *FLAGS, "--device", "cpu",
                        "--checkpoint", path]) == 0
    got = _losses(capsys.readouterr().out)
    assert len(got) == len(want) == 2
    np.testing.assert_allclose(got, want, atol=LOSS_ATOL, rtol=0)
    like = jinit_state(jax.random.PRNGKey(4), cfg_j)
    restored, step = jckpt.restore(path, like)
    assert step == 2
    assert jax.tree_util.tree_structure(restored) == \
        jax.tree_util.tree_structure(like)
