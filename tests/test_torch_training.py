"""The port's training substrate alone: AdamW, the train step, checkpoints
and the data pipeline.

Mirrors every case of ``tests/test_training_data.py`` on
``repro_torch`` (AdamW on a quadratic, gradient clipping, warmup then
cosine, decay skipping vectors, microbatch equivalence at 3e-5, a loss
that drops, the checkpoint round trip and its shape guard, the pipeline's
determinism and token range), and adds what the port does its own way:
decay hits the stacked (L, d) norm scales, a param the loss never reaches
(qwen2-vl-7b's ``embed`` under embedding inputs) decays with zero moments,
the update overwrites the params and moments it was given, bfloat16
leaves round-trip through a checkpoint, whose leaves follow
``jax.tree.flatten``'s sorted-key order.
"""

import tempfile

import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch.configs import get_config
from repro_torch.data import DataConfig, TokenPipeline
from repro_torch.launch.train import model_batch
from repro_torch.training import (AdamWConfig, adamw_update, init_opt_state,
                                  init_state, lr_schedule, make_train_step)
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.tree import flatten, leaves

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def clone(tree):
    return flatten(tree)[1]([x.clone() for x in leaves(tree)])


def _batch(cfg, seq, batch, step=0, seed=0):
    pipe = TokenPipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                                    global_batch=batch, seed=seed))
    return model_batch(cfg, pipe.batch(step), CPU)


class TestAdamW:
    def test_descends_quadratic(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=0.0, warmup_steps=0,
                          total_steps=1000, min_lr_ratio=1.0)
        params = {"w": torch.tensor([5.0, -3.0])}
        state = init_opt_state(params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}
            params, state, _ = adamw_update(cfg, params, grads, state)
        assert float(params["w"].abs().max()) < 0.3
        assert int(state["step"]) == 200

    def test_grad_clip(self):
        cfg = AdamWConfig(grad_clip=1.0)
        params = {"w": torch.ones((4, 4))}
        state = init_opt_state(params)
        _, _, m = adamw_update(cfg, params, {"w": torch.full((4, 4), 100.0)},
                               state)
        assert float(m["grad_norm"]) == pytest.approx(400.0)

    def test_warmup_cosine(self):
        cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                          min_lr_ratio=0.1)
        assert float(lr_schedule(cfg, torch.tensor(5))) == pytest.approx(
            0.5, rel=0.05)
        assert float(lr_schedule(cfg, torch.tensor(100))) == pytest.approx(
            0.1, rel=0.05)
        assert lr_schedule(cfg, torch.tensor(5)).dtype == torch.float32

    def test_weight_decay_skips_vectors(self):
        cfg = AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
        params = {"w": torch.ones((2, 2)), "b": torch.ones((2,))}
        state = init_opt_state(params)
        zero = {"w": torch.zeros((2, 2)), "b": torch.zeros((2,))}
        new, _, _ = adamw_update(cfg, params, zero, state)
        assert float(new["w"][0, 0]) < 1.0      # decayed
        assert float(new["b"][0]) == pytest.approx(1.0)   # not decayed

    def test_decay_hits_stacked_norms_not_final_norm(self):
        """Layers are stacked on L: a stacked norm scale (L, d) has ndim 2
        and decays, as in the reference; ``final_norm`` (d,) does not."""
        cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
        state = init_state(cfg, torch.Generator().manual_seed(0), CPU)
        p = state["params"]
        before = (p["layers"]["ln1"]["scale"].clone(),
                  p["final_norm"]["scale"].clone())
        zero = flatten(p)[1]([torch.zeros_like(x) for x in leaves(p)])
        opt = AdamWConfig(lr=0.1, weight_decay=1.0, warmup_steps=0)
        adamw_update(opt, p, zero, state["opt"])
        assert p["layers"]["ln1"]["scale"].ndim == 2
        torch.testing.assert_close(p["layers"]["ln1"]["scale"],
                                   before[0] * (1 - 0.1 * 1.0))
        torch.testing.assert_close(p["final_norm"]["scale"], before[1],
                                   rtol=0, atol=0)

    def test_update_is_in_place(self):
        """The params and moments are overwritten, not copied: the returned
        trees hold the tensors that were passed in, and they moved."""
        rng = np.random.default_rng(0)
        shapes = {"a": (7, 5, 3), "b": (11,)}
        params = {k: torch.tensor(rng.standard_normal(s), dtype=dt)
                  for (k, s), dt in zip(shapes.items(),
                                        (torch.float32, torch.bfloat16))}
        grads = {k: torch.tensor(rng.standard_normal(s), dtype=torch.float32)
                 for k, s in shapes.items()}
        before = clone(params)
        st_ = init_opt_state(params)
        ins = leaves({"p": params, "mu": st_["mu"], "nu": st_["nu"]})
        p, st2, _ = adamw_update(AdamWConfig(lr=0.05, warmup_steps=0),
                                 params, grads, st_)
        outs = leaves({"p": p, "mu": st2["mu"], "nu": st2["nu"]})
        assert all(x is y for x, y in zip(ins, outs))
        for k in shapes:
            assert not torch.equal(p[k], before[k])
            assert float(st2["nu"][k].min()) > 0


class TestTrainStep:
    def test_microbatch_equivalence(self):
        cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
        opt = AdamWConfig(lr=1e-3)
        state = init_state(cfg, torch.Generator().manual_seed(0), CPU)
        batch = _batch(cfg, 32, 8)
        outs = []
        for mb in (1, 2, 4):
            step = make_train_step(cfg, opt, microbatches=mb, q_chunk=32,
                                   kv_chunk=32)
            new, m = step(clone(state), batch)
            outs.append(new["params"])
            if mb > 1:      # the reference's metrics quirk
                assert float(m["aux"]) == 0.0
                assert float(m["ce"]) == float(m["loss"])
        for other in outs[1:]:
            for a, b in zip(leaves(outs[0]), leaves(other)):
                np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5)

    def test_loss_decreases(self):
        cfg = get_config("starcoder2-7b").smoke().replace(dtype="float32")
        opt = AdamWConfig(lr=2e-3, warmup_steps=3, total_steps=50)
        state = init_state(cfg, torch.Generator().manual_seed(0), CPU)
        step = make_train_step(cfg, opt, q_chunk=32, kv_chunk=32)
        losses = []
        for i in range(25):
            state, m = step(state, _batch(cfg, 64, 8, step=i))
            losses.append(float(m["loss"]))
        assert losses[-1] < losses[0] - 0.3

    def test_unreached_param_decays_with_zero_moments(self):
        """qwen2-vl-7b on embedding inputs never reads ``embed``: its
        gradient is zero, not None, so it still decays and its moments
        still update (to zero), as in JAX."""
        cfg = get_config("qwen2-vl-7b").smoke().replace(dtype="float32")
        state = init_state(cfg, torch.Generator().manual_seed(0), CPU)
        embed = state["params"]["embed"].clone()
        wq = state["params"]["layers"]["wq"].clone()
        opt = AdamWConfig(lr=1e-2, weight_decay=0.5, warmup_steps=0)
        state, m = make_train_step(cfg, opt)(state, _batch(cfg, 16, 2))
        lr = float(m["lr"])
        torch.testing.assert_close(state["params"]["embed"],
                                   embed - lr * 0.5 * embed)
        assert float(state["opt"]["mu"]["embed"].abs().max()) == 0.0
        assert not torch.equal(state["params"]["layers"]["wq"], wq)
        assert int(state["opt"]["step"]) == 1
        assert not state["params"]["embed"].requires_grad


class TestCheckpoint:
    def test_roundtrip_and_shape_guard(self):
        tree = {"a": torch.arange(6).reshape(2, 3).float(),
                "b": {"c": torch.ones((4,), dtype=torch.int32)},
                "d": torch.randn(3, 5).to(torch.bfloat16),
                "s": torch.zeros((), dtype=torch.int32)}
        with tempfile.NamedTemporaryFile(suffix=".msgpack") as f:
            ckpt.save(f.name, tree, step=7)
            restored, step = ckpt.restore(f.name, tree)
            assert step == 7
            for x, y in zip(leaves(tree), leaves(restored)):
                assert x.dtype == y.dtype and torch.equal(x, y)
            bad = {"a": torch.zeros((3, 2)),
                   "b": {"c": torch.ones((4,))},
                   "d": torch.zeros(3, 5), "s": torch.zeros(())}
            with pytest.raises(ValueError):
                ckpt.restore(f.name, bad)

    def test_leaf_order_is_sorted_keys(self):
        tree = {"params": {"blk2": torch.zeros(1), "blk10": torch.ones(1)},
                "opt": {"step": torch.full((1,), 2.0),
                        "mu": torch.full((1,), 3.0)}}
        assert [float(x) for x in leaves(tree)] == [3.0, 2.0, 1.0, 0.0]


class TestPipeline:
    def test_deterministic_and_shifted(self):
        cfg = DataConfig(vocab_size=100, seq_len=32, global_batch=4, seed=1)
        p1, p2 = TokenPipeline(cfg), TokenPipeline(cfg)
        b1, b2 = p1.batch(3), p2.batch(3)
        np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
        np.testing.assert_array_equal(b1["tokens"][:, 1:],
                                      b1["labels"][:, :-1])

    @given(st.integers(0, 50))
    @settings(max_examples=15, deadline=None)
    def test_tokens_in_range(self, step):
        cfg = DataConfig(vocab_size=64, seq_len=16, global_batch=2, seed=0)
        b = TokenPipeline(cfg).batch(step)
        assert b["tokens"].min() >= 0
        assert b["tokens"].max() < 64


def test_model_batch_feeds_each_family():
    """Zero frames for the audio family, one-hot embeddings of ``tokens %
    d_model`` in place of tokens for an ``embeds_input`` config."""
    raw = TokenPipeline(DataConfig(vocab_size=512, seq_len=8,
                                   global_batch=2, seed=0)).batch(0)
    audio = get_config("whisper-base").smoke()
    b = model_batch(audio, raw, CPU)
    assert b["encoder_embeds"].shape == (2, audio.encoder_seq, audio.d_model)
    assert float(b["encoder_embeds"].abs().max()) == 0.0
    vlm = get_config("qwen2-vl-7b").smoke()
    b = model_batch(vlm, raw, CPU)
    assert "tokens" not in b and b["embeds"].dtype == torch.float32
    hot = b["embeds"].argmax(-1).numpy()
    np.testing.assert_array_equal(hot, raw["tokens"] % vlm.d_model)
    assert float(b["embeds"].sum()) == raw["tokens"].size
