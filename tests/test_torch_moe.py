"""Port MoE family vs ``repro.models.moe`` on the same weights (CPU, fp32).

granite-moe-1b-a400m (RMSNorm, 16/8 heads at D=64) and dbrx-132b
(LayerNorm) at their smoke configs (4 experts, top-2).  The JAX param tree
is perturbed as in ``tests/test_torch_dense_variants.py`` (every norm
scale and norm bias) before it goes to both packages; the router stays
float32.  ``route`` (gates, experts, aux loss), ``_dispatch`` (slot
tokens, gates, gathered inputs) on a batch that overflows the experts'
capacity, ``_combine``, ``moe_mlp``, ``apply`` (logits and aux loss),
``prefill`` logits and KV and the lock-step ``decode_step`` must agree to
1e-4 absolute; the load-balance loss is at least 1 - 1e-3 (Cauchy-Schwarz,
as ``tests/test_models.py`` holds it).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import moe as jmoe
from repro.models import registry as jregistry
from repro_torch.models import moe, registry
from test_torch_dense_variants import both_params

ATOL = 1e-4
ARCHS = ("granite-moe-1b-a400m", "dbrx-132b")


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    torch.set_num_threads(2)
    return both_params(request.param, 5)


def _x(cfg, b, s, seed):
    return np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)


def test_family_and_init_layout(model):
    """The moe family registers with an aux loss and no slot, paged or
    verify capability; the port's init makes the reference's leaves and
    shapes, the router in float32 whatever ``cfg.dtype`` is."""
    cfg_j, cfg_t, _, _ = model
    fam = registry.get_family(cfg_t)
    assert fam.has_aux and not fam.slot_decode
    assert fam.paged_decode is None and fam.paged_verify is None
    cfg_b = cfg_t.replace(dtype="bfloat16")
    pt = registry.init(cfg_b, torch.Generator().manual_seed(0), "cpu")
    shapes_j = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)), jax.eval_shape(
            lambda: jregistry.init(jax.random.PRNGKey(0),
                                   cfg_j.replace(dtype="bfloat16"))))
    shapes_t = jax.tree_util.tree_map(
        lambda t: (tuple(t.shape), str(t.dtype).split(".")[-1]), pt)
    assert shapes_t == shapes_j
    assert pt["layers"]["router"].dtype == torch.float32


def test_route_matches(model):
    cfg_j, cfg_t, pj, pt = model
    x = _x(cfg_j, 2, 24, 0)
    gj, ej, aj = jmoe.route(cfg_j, pj["layers"]["router"][0], jnp.asarray(x))
    gt, et, at = moe.route(cfg_t, pt["layers"]["router"][0],
                           torch.from_numpy(x))
    np.testing.assert_array_equal(et.numpy(), np.asarray(ej))
    np.testing.assert_allclose(gt.numpy(), np.asarray(gj), atol=ATOL)
    np.testing.assert_allclose(float(at), float(aj), atol=ATOL)


def test_dispatch_and_combine_match_when_capacity_overflows(model):
    """At capacity factor 0.5 each expert takes C = 8 of the 32 tokens'
    64 assignments, so entries are dropped: the slot tokens (the pad row
    S where empty), the gates and the gathered inputs must be the
    reference's, and the combine of the same expert outputs too."""
    cfg_j, cfg_t, pj, pt = model
    cfg_j, cfg_t = (c.replace(capacity_factor=0.5) for c in (cfg_j, cfg_t))
    b, s = 2, 32
    x = _x(cfg_j, b, s, 1)
    xin_j, disp_j, gsel_j, _ = jmoe._dispatch(
        cfg_j, pj["layers"]["router"][0], jnp.asarray(x))
    xin_t, disp_t, gsel_t, _ = moe._dispatch(
        cfg_t, pt["layers"]["router"][0], torch.from_numpy(x))
    cap = moe.expert_capacity(cfg_t, s)
    assert cap == jmoe.expert_capacity(cfg_j, s) == 8
    kept = int((disp_t < s).sum())
    assert kept < b * s * cfg_t.top_k            # capacity overflowed
    np.testing.assert_array_equal(disp_t.numpy(), np.asarray(disp_j))
    np.testing.assert_allclose(gsel_t.numpy(), np.asarray(gsel_j), atol=ATOL)
    np.testing.assert_allclose(xin_t.numpy(), np.asarray(xin_j), atol=ATOL)
    eout = np.random.default_rng(2).standard_normal(
        tuple(xin_t.shape)).astype(np.float32)
    want = jmoe._combine(jnp.asarray(x), jnp.asarray(eout), disp_j, gsel_j)
    got = moe._combine(torch.from_numpy(x), torch.from_numpy(eout), disp_t,
                       gsel_t)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_moe_mlp_matches(model):
    cfg_j, cfg_t, pj, pt = model
    x = _x(cfg_j, 2, 20, 3)
    lp_j = jax.tree_util.tree_map(lambda a: a[0], pj["layers"])
    lp_t = {k: (v[0] if not isinstance(v, dict) else v)
            for k, v in pt["layers"].items()}
    oj, aj = jmoe.moe_mlp(cfg_j, lp_j, jnp.asarray(x))
    ot, at = moe.moe_mlp(cfg_t, lp_t, torch.from_numpy(x))
    np.testing.assert_allclose(ot.numpy(), np.asarray(oj), atol=ATOL)
    np.testing.assert_allclose(float(at), float(aj), atol=ATOL)


def test_apply_logits_and_aux_match(model):
    """``apply`` returns (logits, aux); ``apply_logits`` drops the aux,
    ``apply_with_aux`` keeps it, and the aux is at least 1 - 1e-3."""
    cfg_j, cfg_t, pj, pt = model
    toks = np.random.default_rng(4).integers(
        2, cfg_j.vocab_size, size=(2, 64)).astype(np.int32)
    lj, aj = jregistry.apply_with_aux(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    batch = {"tokens": torch.from_numpy(toks).long()}
    lt, at = registry.apply_with_aux(pt, cfg_t, batch)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    np.testing.assert_allclose(float(at), float(aj), atol=ATOL)
    assert float(at) >= 1.0 - 1e-3
    assert torch.equal(registry.apply_logits(pt, cfg_t, batch), lt)


def test_prefill_and_lockstep_decode_match(model):
    """A left-padded prefill (pads attended and routed, as the wave path
    runs it) and five lock-step decode steps at one scalar length: logits,
    lengths and the written cache must agree."""
    cfg_j, cfg_t, pj, pt = model
    rng = np.random.default_rng(6)
    toks = np.full((3, 32), cfg_j.eos_id, np.int32)
    for i, n in enumerate((32, 20, 9)):
        toks[i, 32 - n:] = rng.integers(2, cfg_j.vocab_size, size=n)
    lj, cj = jmoe.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                          capacity=48)
    lt, ct = moe.prefill(pt, cfg_t, torch.from_numpy(toks).long(),
                         capacity=48)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=ATOL)
    assert int(ct["length"]) == int(cj["length"]) == 32
    for step in range(5):
        tok = rng.integers(2, cfg_j.vocab_size, size=(3, 1)).astype(np.int32)
        lj, cj = jmoe.decode_step(pj, cfg_j, cj, jnp.asarray(tok))
        lt, ct = moe.decode_step(pt, cfg_t, ct, torch.from_numpy(tok).long())
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL,
                                   err_msg=f"step {step}")
        assert int(ct["length"]) == int(cj["length"])
    for name in ("k", "v"):
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]),
                                   atol=ATOL)
    empty = moe.init_cache(cfg_t, 3, 40)
    assert tuple(empty["k"].shape) == tuple(
        jmoe.init_cache(cfg_j, 3, 40)["k"].shape)
