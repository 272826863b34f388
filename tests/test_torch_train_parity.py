"""The port's training against the JAX package's, on the CPU.

* One ``make_train_step`` a step for 3 steps on the same bridged float32
  weights (norm scales and biases perturbed, so a dropped bias gradient
  cannot read as zero = zero) and the same pipeline batches, for a dense
  (qwen3-8b), a dense with biases (starcoder2-7b), a moe
  (granite-moe-1b-a400m) and a hybrid (recurrentgemma-9b) smoke config:
  the loss within 1e-5 relative, ``grad_norm`` within 1e-4 relative and
  ``lr`` equal at every step; the first step's first moments -- the
  clipped gradients -- element by element; and every param within 1e-5
  absolute after the third, but where AdamW's eps dominates the update.
* Checkpoints cross both ways: a JAX train state saved by
  ``repro.training.checkpoint`` restores into the port's tree equal to the
  bridged params (float32 and bfloat16 leaves, the int32 step), and the
  port's save restores in JAX equal; the two write the same bytes.
* ``lr_schedule`` equals the reference's on a grid of steps, and the
  pipeline's batches are bit-equal to the reference's.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JDataConfig
from repro.models import registry as jregistry
from repro.data import TokenPipeline as JTokenPipeline
from repro.training import AdamWConfig as JAdamWConfig
from repro.training import checkpoint as jckpt
from repro.training import init_opt_state as jinit_opt_state
from repro.training import lr_schedule as jlr_schedule
from repro.training import make_train_step as jmake_train_step
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.train import model_batch
from repro_torch.models import bridge
from repro_torch.training import (AdamWConfig, init_opt_state, lr_schedule,
                                  make_train_step)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.tree import leaves
from test_torch_dense_variants import both_params

LOSS_REL, GNORM_REL, PARAM_ATOL = 1e-5, 1e-4, 1e-5
# step 1's first moment (1 - b1) x clip x gradient of each element: within
# MU_RTOL of itself plus MU_ATOL of its leaf's largest, the float32
# summation noise of a leaf's gradient (the two frameworks sum in other
# orders; below it neither package's sign is determined)
MU_RTOL, MU_ATOL = 1e-4, 4e-6
# an element whose RMS gradient at some step is nonzero but below 100 x
# AdamW's eps: eps is at least 1% of its update's denominator
EPS_DOMINATED = 1e-6


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "starcoder2-7b",
                                  "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_train_steps_match_reference(arch):
    """Each element's gradient is held through step 1's first moment
    ``mu``, taken before the params can part.  Where a step's RMS gradient
    ``sqrt(nu_t / bc2_t)`` is above 0 but below ``EPS_DOMINATED`` (100 x
    AdamW's eps) in both packages, the update ``mu_hat / (sqrt(nu_hat) +
    eps)`` turns a gradient difference of 1e-9 into a param difference
    above 1e-5: those elements' params are counted and printed, every
    other param is held to ``PARAM_ATOL``.  The second moments of every
    element stay within 1e-3 of their leaf's largest, and the zero
    gradients of the two packages fall on the same elements."""
    cfg_j, cfg_t, pj, pt = both_params(arch, 11)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=10)
    jopt = JAdamWConfig(**kw)
    jstep = jax.jit(jmake_train_step(cfg_j, jopt, q_chunk=32, kv_chunk=32))
    tstep = make_train_step(cfg_t, AdamWConfig(**kw), q_chunk=32,
                            kv_chunk=32)
    sj = {"params": pj, "opt": jinit_opt_state(pj)}
    st = {"params": pt, "opt": init_opt_state(pt)}
    pipe = TokenPipeline(DataConfig(vocab_size=cfg_t.vocab_size, seq_len=32,
                                    global_batch=4, seed=2))
    masks = None
    for i in range(3):
        raw = pipe.batch(i)
        sj, mj = jstep(sj, {k: jnp.asarray(v) for k, v in raw.items()})
        st, mt = tstep(st, model_batch(cfg_t, raw, torch.device("cpu")))
        assert float(mt["loss"]) == pytest.approx(float(mj["loss"]),
                                                  rel=LOSS_REL), i
        assert float(mt["grad_norm"]) == pytest.approx(
            float(mj["grad_norm"]), rel=GNORM_REL), i
        assert float(mt["lr"]) == pytest.approx(float(mj["lr"]), rel=1e-6)
        assert float(mt["aux"]) == pytest.approx(float(mj["aux"]), rel=1e-4,
                                                 abs=1e-7)
        if i == 0:
            for a, b in zip(jax.tree_util.tree_leaves(sj["opt"]["mu"]),
                            leaves(st["opt"]["mu"])):
                a = np.asarray(a)
                np.testing.assert_allclose(
                    b.numpy(), a, rtol=MU_RTOL,
                    atol=MU_ATOL * np.abs(a).max())
        step_masks = []
        for a, b in zip(jax.tree_util.tree_leaves(sj["opt"]["nu"]),
                        leaves(st["opt"]["nu"])):
            a, b = np.asarray(a), b.numpy()
            np.testing.assert_array_less(np.abs(b - a),
                                         1e-3 * a.max() + 1e-30)
            np.testing.assert_array_equal(a == 0, b == 0)
            tiny = EPS_DOMINATED ** 2 * (1 - jopt.b2 ** (i + 1))
            step_masks.append((a > 0) & (a < tiny) & (b < tiny))
        masks = step_masks if masks is None else [
            x | y for x, y in zip(masks, step_masks)]
    masked = worst = 0
    for a, b, m in zip(jax.tree_util.tree_leaves(sj["params"]),
                       leaves(st["params"]), masks):
        diff = np.abs(b.numpy() - np.asarray(a))
        np.testing.assert_array_less(diff[~m], PARAM_ATOL)
        masked += int(m.sum())
        worst = max(worst, float(diff[m].max(initial=0.0)))
    total = sum(x.numel() for x in leaves(st["params"]))
    print(f"{arch}: {masked} of {total} elements eps-dominated, largest "
          f"difference there {worst:.3g}")


def test_adamw_update_matches_reference_on_the_same_grads():
    """The optimizer alone, on identical gradients (a tenth of them near
    zero, 1e-9, where eps dominates the update): every param and moment
    within ``PARAM_ATOL`` after 3 steps, fp32 and bf16 params."""
    from repro.training import adamw_update as jadamw_update
    from repro_torch.training import adamw_update
    rng = np.random.default_rng(3)
    shapes = {"w": (6, 8, 5), "b": (9,), "n": {"scale": (3, 7)}}

    def draw(tree, tiny=False):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = draw(v, tiny)
                continue
            x = rng.standard_normal(v).astype(np.float32)
            if tiny:
                x = np.where(rng.random(v) < 0.1, x * 1e-9, x * 1e-3)
            out[k] = x.astype(np.float32)
        return out

    for dtype in (jnp.float32, jnp.bfloat16):
        params = draw(shapes)
        kw = dict(lr=1e-2, warmup_steps=1, total_steps=5)
        pj = jax.tree_util.tree_map(lambda x: jnp.asarray(x, dtype), params)
        pt = jax.tree_util.tree_map(
            lambda x: torch.from_numpy(np.array(
                jnp.asarray(x, dtype).astype(jnp.float32))).to(
                torch.float32 if dtype == jnp.float32 else torch.bfloat16),
            params)
        sj, st = jinit_opt_state(pj), init_opt_state(pt)
        for _ in range(3):
            g = draw(shapes, tiny=True)
            pj, sj, mj = jadamw_update(JAdamWConfig(**kw), pj, jax.tree_util
                                       .tree_map(jnp.asarray, g), sj)
            pt, st, mt = adamw_update(AdamWConfig(**kw), pt, jax.tree_util
                                      .tree_map(torch.from_numpy, g), st)
            assert float(mt["grad_norm"]) == pytest.approx(
                float(mj["grad_norm"]), rel=1e-6)
        for a, b in zip(jax.tree_util.tree_leaves((pj, sj["mu"], sj["nu"])),
                        leaves({"0": pt, "1": st["mu"], "2": st["nu"]})):
            np.testing.assert_allclose(b.float().numpy(),
                                       np.asarray(a, np.float32),
                                       atol=PARAM_ATOL, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_both_ways(dtype):
    cfg_j = jax_get_config("qwen3-8b").smoke() \
        .replace(dtype=dtype)
    tree = jax.tree_util.tree_map(
        np.asarray, jregistry.init(jax.random.PRNGKey(12), cfg_j))
    pj = jax.tree_util.tree_map(jnp.asarray, tree)
    pt = bridge.params_from_jax(tree, get_config("qwen3-8b").smoke()
                                .replace(dtype=dtype), "cpu")
    sj = {"params": pj, "opt": jinit_opt_state(pj)}
    sj["opt"]["step"] = jnp.asarray(5, jnp.int32)
    st = {"params": pt, "opt": init_opt_state(pt)}
    st["opt"]["step"] = torch.tensor(5, dtype=torch.int32)
    with tempfile.TemporaryDirectory() as tmp:
        jpath, tpath = f"{tmp}/j.msgpack", f"{tmp}/t.msgpack"
        jckpt.save(jpath, sj, step=9)
        ckpt.save(tpath, st, step=9)
        with open(jpath, "rb") as a, open(tpath, "rb") as b:
            assert a.read() == b.read()
        got, step = ckpt.restore(jpath, st)
        assert step == 9
        for x, y in zip(leaves(got), leaves(st)):
            assert x.dtype == y.dtype and torch.equal(x, y)
        back, step = jckpt.restore(tpath, sj)
        assert step == 9
        for x, y in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(sj)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(np.asarray(x, np.float32),
                                          np.asarray(y, np.float32))
    assert str(got["params"]["layers"]["wq"].dtype) == f"torch.{dtype}"


def test_lr_schedule_matches_reference():
    for kw in (dict(lr=1e-3, warmup_steps=10, total_steps=100),
               dict(lr=0.3, warmup_steps=0, total_steps=7,
                    min_lr_ratio=0.0)):
        for step in (0, 1, 5, 10, 11, 50, 99, 100, 150):
            want = float(jlr_schedule(JAdamWConfig(**kw),
                                      jnp.asarray(step)))
            got = float(lr_schedule(AdamWConfig(**kw), torch.tensor(step)))
            assert got == pytest.approx(want, rel=1e-6, abs=1e-12), step


@pytest.mark.parametrize("cfg", [dict(vocab_size=512, seq_len=128,
                                      global_batch=8, seed=0),
                                 dict(vocab_size=151936, seq_len=64,
                                      global_batch=3, seed=5,
                                      copy_fraction=0.5),
                                 dict(vocab_size=64, seq_len=40,
                                      global_batch=2, seed=9, zipf_a=1.5,
                                      copy_span=4)])
def test_pipeline_batches_bit_equal_to_reference(cfg):
    pj, pt = JTokenPipeline(JDataConfig(**cfg)), TokenPipeline(
        DataConfig(**cfg))
    for step in (0, 1, 17):
        bj, bt = pj.batch(step), pt.batch(step)
        assert set(bj) == set(bt)
        for k in bj:
            assert bj[k].dtype == bt[k].dtype
            np.testing.assert_array_equal(bj[k], bt[k])
