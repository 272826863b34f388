"""Port dense model vs ``repro.models.dense`` on the same weights (CPU).

The JAX param pytree of the qwen3-8b smoke config (fp32) crosses into the
port through ``repro_torch.models.bridge``; the same numpy tokens go
through both.  Prefill logits and KV (right-padded, ``last_positions``)
and several paged decode steps with a riding-along row must agree to
1e-4 absolute (float32 matmuls summed in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import common as jcm
from repro.models import dense as jdense
from repro.models import registry as jregistry
from repro_torch.configs import get_config
from repro_torch.models import bridge, dense
from repro_torch.models import common as cm

ATOL = 1e-4


@pytest.fixture(scope="module")
def model():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(3), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _prompts(rng, lens, plen, vocab, eos):
    toks = np.full((len(lens), plen), eos, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, vocab, size=n)
    return toks, np.asarray([n - 1 for n in lens], np.int32)


def test_bridge_copies_every_leaf(model):
    cfg_j, _, pj, pt = model
    flat_j = jax.tree_util.tree_leaves_with_path(pj)
    assert len(flat_j) == len(jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: 0, pt)))
    np.testing.assert_array_equal(np.asarray(pj["layers"]["wq"]),
                                  pt["layers"]["wq"].numpy())
    assert pt["lm_head"].shape == (cfg_j.d_model, cfg_j.padded_vocab)


@pytest.mark.parametrize("op", ["rms_norm", "layer_norm", "apply_rope"])
def test_common_ops_match_reference(op):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    pos = rng.integers(0, 5000, size=(2, 5)).astype(np.int32)
    args_j = {"rms_norm": (scale,), "layer_norm": (scale, bias),
              "apply_rope": (pos, 1e6)}[op]
    want = getattr(jcm, op)(jnp.asarray(x), *(
        jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args_j))
    got = getattr(cm, op)(torch.from_numpy(x), *(
        torch.from_numpy(a) if isinstance(a, np.ndarray) else a
        for a in args_j))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_logits_and_kv_match(model):
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(0)
    toks, last = _prompts(rng, (20, 9, 32), 32, cfg_j.vocab_size,
                          cfg_j.eos_id)
    lj, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                            capacity=48, last_positions=jnp.asarray(last))
    lt, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                           capacity=48,
                           last_positions=torch.from_numpy(last))
    assert lt.shape == lj.shape == (3, 1, cfg_j.padded_vocab)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for name in ("k", "v"):
        assert ct[name].shape == cj[name].shape
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=ATOL)
    assert ct["length"] == int(cj["length"]) == 32


def test_paged_decode_steps_with_rider_match(model):
    """Two real rows, one of whose writes crosses into its next page, and
    a length-0 rider whose table points at the scratch page 0: five paged
    decode steps (the pieces ``PagedDecodeGraphs`` composes, run eagerly),
    logits of the real rows and the KV on their pages must agree."""
    cfg_j, cfg_t, pj, pt = model
    page, n_pages = 16, 8
    rng = np.random.default_rng(1)
    toks, last = _prompts(rng, (20, 14), 32, cfg_j.vocab_size, cfg_j.eos_id)
    _, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                           capacity=32, last_positions=jnp.asarray(last))
    _, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                          capacity=32, last_positions=torch.from_numpy(last))
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j = jdense.prefill_to_pages(
        jdense.init_paged_pools(cfg_j, n_pages, page),
        {"k": cj["k"], "v": cj["v"]}, jnp.asarray(phys))
    pools_t = dense.prefill_to_pages(
        dense.init_paged_pools(cfg_t, n_pages, page), ct,
        torch.from_numpy(phys))
    bt = np.asarray([[1, 2, 4, 0], [3, 5, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([20, 14, 0], np.int32)
    cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
               "lengths": jnp.asarray(lens)}
    cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
               "lengths": torch.from_numpy(lens)}
    for step in range(5):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = jdense.paged_decode_step(pj, cfg_j, cache_j,
                                               jnp.asarray(tok))
        lt, cache_t = dense.paged_decode_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   atol=ATOL, err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_t["lengths"].numpy(),
                                      np.asarray(cache_j["lengths"]))
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(cache_t[name][:, 1:6].numpy(),
                                   np.asarray(cache_j[name])[:, 1:6],
                                   atol=ATOL)


def test_seeded_init_draws_the_reference_distributions():
    """The card's weights come from the port's own seeded init (no JAX
    there): same shapes, dtypes and scales as the reference's init."""
    cfg = get_config("qwen3-8b").smoke().replace(dtype="float32")
    g = torch.Generator().manual_seed(0)
    p = dense.init(cfg, g, "cpu")
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    shapes_j = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jax.eval_shape(
            lambda: jregistry.init(jax.random.PRNGKey(0), cfg_j)))
    shapes_t = jax.tree_util.tree_map(lambda t: tuple(t.shape), p)
    assert shapes_t == shapes_j
    assert abs(p["layers"]["wq"].std().item() - cfg.d_model ** -0.5) < 2e-3
    assert abs(p["embed"].std().item() - 0.02) < 2e-4
    assert torch.equal(p["layers"]["q_norm"], torch.ones_like(
        p["layers"]["q_norm"]))
    again = dense.init(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["lm_head"], p["lm_head"])


def test_slot_decode_steps_match(model):
    """Slot decode with per-row lengths: rows of different depths, one at
    length 0 (an empty slot riding along), five steps; logits, lengths and
    the written cache must agree."""
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(2)
    toks, last = _prompts(rng, (20, 9, 32), 32, cfg_j.vocab_size,
                          cfg_j.eos_id)
    _, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                           capacity=48, last_positions=jnp.asarray(last))
    _, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                          capacity=48, last_positions=torch.from_numpy(last))
    lens = np.asarray([20, 9, 0], np.int32)
    cache_j = {"k": cj["k"], "v": cj["v"], "length": jnp.asarray(lens)}
    cache_t = {"k": ct["k"].clone(), "v": ct["v"].clone(),
               "length": torch.from_numpy(lens)}
    for step in range(5):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = jdense.decode_step(pj, cfg_j, cache_j, jnp.asarray(tok))
        lt, cache_t = dense.decode_step(pt, cfg_t, cache_t,
                                        torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=2e-5,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_t["length"].numpy(),
                                      np.asarray(cache_j["length"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), atol=2e-5)
    empty = dense.init_cache(cfg_t, 3, 40)
    assert empty["k"].shape == tuple(jdense.init_cache(cfg_j, 3, 40)["k"]
                                     .shape)


def test_paged_verify_steps_match(model):
    """Two verify steps of K = 5 tokens over pages with a rider row whose
    lengths + K pass its table (its writes clamp into the last column):
    logits at every position, and the KV on the real rows' pages."""
    cfg_j, cfg_t, pj, pt = model
    page, n_pages, kq = 16, 8, 5
    rng = np.random.default_rng(5)
    toks, last = _prompts(rng, (20, 14), 32, cfg_j.vocab_size, cfg_j.eos_id)
    _, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                           capacity=32, last_positions=jnp.asarray(last))
    _, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                          capacity=32, last_positions=torch.from_numpy(last))
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j = jdense.prefill_to_pages(
        jdense.init_paged_pools(cfg_j, n_pages, page),
        {"k": cj["k"], "v": cj["v"]}, jnp.asarray(phys))
    pools_t = dense.prefill_to_pages(
        dense.init_paged_pools(cfg_t, n_pages, page), ct,
        torch.from_numpy(phys))
    bt = np.asarray([[1, 2, 4], [3, 5, 0], [0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 44], np.int32)
    for step in range(2):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, kq)).astype(np.int32)
        cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
                   "lengths": jnp.asarray(lens)}
        cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
                   "lengths": torch.from_numpy(lens)}
        lj, cache_j = jdense.paged_verify_step(pj, cfg_j, cache_j,
                                               jnp.asarray(tok))
        lt, cache_t = dense.paged_verify_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        pools_j = {n: cache_j[n] for n in ("k_pool", "v_pool")}
        assert lt.shape == lj.shape == (3, kq, cfg_j.padded_vocab)
        np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                                   atol=2e-5, err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_t["lengths"].numpy(), lens)
        lens = lens + np.asarray([2, 1, 0], np.int32)   # accepted + pending
    for name in ("k_pool", "v_pool"):
        np.testing.assert_allclose(pools_t[name][:, 1:6].numpy(),
                                   np.asarray(pools_j[name])[:, 1:6],
                                   atol=2e-5)
