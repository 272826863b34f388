"""Port dense variants vs ``repro.models.dense`` on the same weights (CPU).

starcoder2-7b (LayerNorm, GeLU, biases), qwen3-32b (qk-norm, 64/8 heads)
and command-r-plus-104b (LayerNorm, parallel block, tied embeddings) at
their smoke configs in fp32.  The reference starts every bias and
LayerNorm bias at zero and every norm scale at one, where a bias dropped
or added in the wrong place cannot show, so the JAX param tree is
perturbed first (``perturbed``: seeded numpy noise on every norm scale,
norm bias and bias) and the same numpy tree goes to both packages.  The
full-sequence ``apply``, ``prefill`` logits and KV, slot ``decode_step``
with (B,) lengths and with one scalar length (the lock-step wave), and
``paged_decode_step`` / ``paged_verify_step`` over fp pools must agree to
1e-4 absolute, the tolerance of ``tests/test_torch_dense.py``.  Over int8
pools the two packages' fp32 projections differ by ~1e-6, so a value at a
rounding boundary may quantize one int8 code apart on write (one of the
~10^5 written values does here), which moves the logits that attend it by
up to ~4e-4.  So after every step the pools of the real rows are compared
first: their scales must agree to 1e-4 and their int8 codes exactly, or
else at no more than ``MAX_CODE_STEPS`` values, each one code apart; the
step's logits are held to 1e-4 where the codes agree exactly, and to 1e-3
(``tests/test_torch_quant.py``'s bound) only where such a code step was
found.  ``gelu`` and ``layer_norm`` are held to ``repro.models.common``.
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
from repro_torch.models import bridge, dense, registry
from repro_torch.models import common as cm

# the reference's steps, compiled once per config and shape (a config is a
# frozen dataclass, so it can be a static argument)
_J_DECODE = jax.jit(jdense.decode_step, static_argnums=1)
_J_PAGED = jax.jit(jdense.paged_decode_step, static_argnums=1)
_J_VERIFY = jax.jit(jdense.paged_verify_step, static_argnums=1)

ATOL = 1e-4
INT8_LOGIT_ATOL = 1e-3     # tests/test_torch_quant.py's LOGIT_ATOL
MAX_CODE_STEPS = 4         # int8 values of the pools one code apart, at most
ARCHS = ("starcoder2-7b", "qwen3-32b", "command-r-plus-104b")
_SCALES = ("scale", "q_norm", "k_norm")
_BIASES = ("bias", "bq", "bk", "bv", "bo", "b_up", "b_down", "conv_b")


def perturbed(tree, seed: int):
    """The numpy param tree with seeded noise on every norm scale (1 +
    N(0, 0.2)), norm bias and bias (N(0, 0.1)); other leaves as they are."""
    rng = np.random.default_rng(seed)

    def walk(t):
        out = {}
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                out[k] = walk(v)
                continue
            v = np.asarray(v)
            if k in _SCALES or k in _BIASES:
                sd = 0.2 if k in _SCALES else 0.1
                v = (v + sd * rng.standard_normal(v.shape)).astype(v.dtype)
            out[k] = v
        return out

    return walk(tree)


def both_params(arch: str, seed: int, **replace):
    """(cfg_j, cfg_t, JAX params, port params) for ``arch``'s smoke config
    in fp32 (plus ``replace``), on one perturbed numpy tree."""
    cfg_j = jax_get_config(arch).smoke().replace(dtype="float32", **replace)
    cfg_t = get_config(arch).smoke().replace(dtype="float32", **replace)
    tree = perturbed(jax.tree_util.tree_map(
        np.asarray, jregistry.init(jax.random.PRNGKey(seed), cfg_j)), seed)
    return (cfg_j, cfg_t, jax.tree_util.tree_map(jnp.asarray, tree),
            bridge.params_from_jax(tree, cfg_t, "cpu"))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    torch.set_num_threads(2)
    return both_params(request.param, 3)


@pytest.fixture(scope="module", params=[(a, q) for a in ARCHS
                                        for q in ("fp", "int8")],
                ids=lambda p: "-".join(p))
def pmodel(request):
    """``model`` with fp or int8 KV (``cfg.kv_quant``), for the paged
    steps."""
    torch.set_num_threads(2)
    arch, kv = request.param
    return both_params(arch, 4, kv_quant=kv == "int8")


def _prompts(rng, lens, plen, vocab, eos):
    toks = np.full((len(lens), plen), eos, np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(2, vocab, size=n)
    return toks, np.asarray([n - 1 for n in lens], np.int32)


def _prefill_both(model, seed, lens, plen, capacity):
    cfg_j, cfg_t, pj, pt = model
    toks, last = _prompts(np.random.default_rng(seed), lens, plen,
                          cfg_j.vocab_size, cfg_j.eos_id)
    lj, cj = jdense.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                            capacity=capacity,
                            last_positions=jnp.asarray(last))
    lt, ct = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                           capacity=capacity,
                           last_positions=torch.from_numpy(last))
    return lj, cj, lt, ct


@pytest.mark.parametrize("op", ["gelu", "layer_norm"])
def test_gelu_and_layer_norm_match_reference(op):
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32) * 3
    scale = rng.standard_normal(64).astype(np.float32)
    bias = rng.standard_normal(64).astype(np.float32)
    args = () if op == "gelu" else (scale, bias)
    want = getattr(jcm, op)(jnp.asarray(x), *map(jnp.asarray, args))
    got = getattr(cm, op)(torch.from_numpy(x), *map(torch.from_numpy, args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_and_bridge_take_every_layout(arch):
    """The port's seeded init makes the reference's leaves with their
    shapes (no ``lm_head`` when tied, no ``ln2`` in a parallel block, the
    biases, ``{scale, bias}`` LayerNorms), biases and LayerNorm biases at
    zero; the bridge copies every leaf and refuses a missing one."""
    cfg_j = jax_get_config(arch).smoke().replace(dtype="float32")
    cfg_t = get_config(arch).smoke().replace(dtype="float32")
    shapes_j = jax.tree_util.tree_map(
        lambda a: tuple(a.shape), jax.eval_shape(
            lambda: jregistry.init(jax.random.PRNGKey(0), cfg_j)))
    pt = registry.init(cfg_t, torch.Generator().manual_seed(0), "cpu")
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape), pt) == shapes_j
    lyr = pt["layers"]
    assert ("lm_head" in pt) == (not cfg_t.tie_embeddings)
    assert ("ln2" in lyr) == (not cfg_t.parallel_block)
    for name in ("bq", "bk", "bv", "bo", "b_up", "b_down"):
        assert (name in lyr) == cfg_t.use_bias
        if name in lyr:
            assert not lyr[name].any()
    if cfg_t.norm_type == "layernorm":
        assert not lyr["ln1"]["bias"].any() and not pt["final_norm"][
            "bias"].any()
    _, _, pj, pb = both_params(arch, 1)
    assert len(jax.tree_util.tree_leaves(pj)) == len(
        jax.tree_util.tree_leaves(jax.tree_util.tree_map(lambda t: 0, pb)))
    np.testing.assert_array_equal(np.asarray(pj["layers"]["ln1"]["scale"]),
                                  pb["layers"]["ln1"]["scale"].numpy())
    tree = jax.tree_util.tree_map(np.asarray, pj)
    del tree["layers"]["wo"]
    with pytest.raises(KeyError):
        bridge.params_from_jax(tree, cfg_t, "cpu")


def test_apply_matches(model):
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.default_rng(7).integers(
        2, cfg_j.vocab_size, size=(2, 24)).astype(np.int32)
    want = jregistry.apply_logits(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    got = registry.apply_logits(pt, cfg_t,
                                {"tokens": torch.from_numpy(toks).long()})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_prefill_logits_and_kv_match(model):
    lj, cj, lt, ct = _prefill_both(model, 0, (20, 9, 32), 32, 48)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=ATOL)
    assert int(ct["length"]) == int(cj["length"]) == 32


@pytest.mark.parametrize("scalar", [False, True], ids=["rows", "scalar"])
def test_slot_decode_steps_match(model, scalar):
    """Five decode steps: per-row lengths (one row at 0), or one scalar
    length shared by every row (the wave's lock-step decode); logits,
    lengths and the written cache must agree."""
    cfg_j, cfg_t, pj, pt = model
    _, cj, _, ct = _prefill_both(model, 2, (20, 9, 32), 32, 48)
    lens = (np.asarray(32, np.int32) if scalar
            else np.asarray([20, 9, 0], np.int32))
    cache_j = {"k": cj["k"], "v": cj["v"], "length": jnp.asarray(lens)}
    cache_t = {"k": ct["k"].clone(), "v": ct["v"].clone(),
               "length": torch.from_numpy(lens)}
    rng = np.random.default_rng(2)
    for step in range(5):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = _J_DECODE(pj, cfg_j, cache_j, jnp.asarray(tok))
        lt, cache_t = dense.decode_step(pt, cfg_t, cache_t,
                                        torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(cache_t["length"].numpy(),
                                      np.asarray(cache_j["length"]))
    for name in ("k", "v"):
        np.testing.assert_allclose(cache_t[name].numpy(),
                                   np.asarray(cache_j[name]), atol=ATOL)


def _paged_both(model, seed, phys, n_pages, page):
    cfg_j, cfg_t, _, _ = model
    _, cj, _, ct = _prefill_both(model, seed, (20, 9), 32, 32)
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in cj]
    pools_j = jdense.prefill_to_pages(
        jdense.init_paged_pools(cfg_j, n_pages, page),
        {n: cj[n] for n in names}, jnp.asarray(phys))
    pools_t = dense.prefill_to_pages(
        dense.init_paged_pools(cfg_t, n_pages, page), ct,
        torch.from_numpy(phys))
    return pools_j, pools_t


def _code_steps(pools_t, pools_j, pages) -> int:
    """The int8 values on ``pages`` that differ between the two packages'
    pools, after holding every difference to one code, their number to
    ``MAX_CODE_STEPS``, and fp pools and scales to ATOL."""
    steps = 0
    for name, a in pools_t.items():
        got, want = a[:, pages].float().numpy(), np.asarray(
            pools_j[name][:, np.asarray(pages)]).astype(np.float32)
        if a.dtype != torch.int8:
            np.testing.assert_allclose(got, want, atol=ATOL, err_msg=name)
            continue
        assert np.abs(got - want).max() <= 1, name
        steps += int(np.count_nonzero(got != want))
    assert steps <= MAX_CODE_STEPS, steps
    return steps


def _logits_close(lt, lj, pools_t, pools_j, pages, step):
    """The real rows' logits of a step: to ATOL over pools that agree, to
    INT8_LOGIT_ATOL where an int8 value of the pools was one code apart."""
    steps = _code_steps(pools_t, pools_j, pages)
    np.testing.assert_allclose(lt[:2].numpy(), np.asarray(lj)[:2],
                               atol=INT8_LOGIT_ATOL if steps else ATOL,
                               err_msg=f"step {step}, {steps} code steps")


def test_paged_decode_steps_match(pmodel):
    """Two real rows and a length-0 rider on the scratch page: five paged
    decode steps over fp or int8 pools; logits of the real rows and the KV
    on their pages must agree."""
    cfg_j, cfg_t, pj, pt = m = pmodel
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j, pools_t = _paged_both(m, 1, phys, 8, 16)
    bt = np.asarray([[1, 2, 4, 0], [3, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 0], np.int32)
    cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
               "lengths": jnp.asarray(lens)}
    cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
               "lengths": torch.from_numpy(lens)}
    rng = np.random.default_rng(1)
    for step in range(5):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cache_j = _J_PAGED(pj, cfg_j, cache_j, jnp.asarray(tok))
        lt, cache_t = dense.paged_decode_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        _logits_close(lt, lj, {n: cache_t[n] for n in pools_t}, cache_j,
                      [1, 2, 3, 4], step)


def test_paged_verify_steps_match(pmodel):
    """Two verify steps of K = 5 tokens with a rider whose lengths + K pass
    its table: logits at every position of the real rows, and their KV."""
    cfg_j, cfg_t, pj, pt = m = pmodel
    phys = np.asarray([[1, 2], [3, 0]], np.int32)
    pools_j, pools_t = _paged_both(m, 5, phys, 8, 16)
    bt = np.asarray([[1, 2, 4], [3, 5, 0], [0, 0, 0]], np.int32)
    lens = np.asarray([20, 9, 44], np.int32)
    rng = np.random.default_rng(5)
    for step in range(2):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 5)).astype(np.int32)
        cache_j = {**pools_j, "block_tables": jnp.asarray(bt),
                   "lengths": jnp.asarray(lens)}
        cache_t = {**pools_t, "block_tables": torch.from_numpy(bt),
                   "lengths": torch.from_numpy(lens)}
        lj, cache_j = _J_VERIFY(pj, cfg_j, cache_j, jnp.asarray(tok))
        lt, cache_t = dense.paged_verify_step(pt, cfg_t, cache_t,
                                              torch.from_numpy(tok).long())
        pools_j = {n: cache_j[n] for n in pools_t}
        _logits_close(lt, lj, pools_t, pools_j, [1, 2, 3, 4, 5], step)
        lens = lens + np.asarray([2, 1, 0], np.int32)   # accepted + pending
