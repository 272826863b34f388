"""Port ssm family (xlstm-1.3b: mLSTM and sLSTM) vs the JAX package (CPU).

* The cells against ``repro.models.xlstm``'s on the same numpy inputs in
  fp32 (1e-5 absolute on h and the states): ``mlstm_chunkwise`` with T
  not a multiple of the chunk (a padded last chunk), with a carried-in
  state, and with input gates so negative that the stabilizer ``m_t``
  sits far below zero, where ``max(|den|, exp(-m_t))`` is inf and h is 0
  in both packages; ``mlstm_recurrent_step`` (also against one chunkwise
  step) and ``_slstm_block`` with and without an incoming state.
* ``apply``, ``prefill`` and lock-step ``decode_step`` on the same
  perturbed, bridged weights in fp32 (1e-4 on the logits and the caches,
  ``tests/test_torch_dense.py``'s tolerance) at the smoke width on two
  configs whose ``n_layers`` leave a tail: the 7:1 pattern at 10 layers
  (one group, tail m, m) and the pattern (s, m) at 3 layers (tail s).
  The prompt of 90 tokens runs two chunks, the second padded.
* The bridge: the float32 leaves (``w_i``, ``w_f``, ``b_f``, ``r_*``)
  stay float32 in a bf16 tree, the others keep the tree's dtype, and a
  missing leaf raises; the port's own init makes the reference's tree at
  its shapes and dtypes; the registry has every family of the
  reference's with the same capabilities.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro.models import xlstm as jxlstm
from repro_torch.configs import get_config
from repro_torch.models import bridge, registry, xlstm
from test_torch_dense_variants import both_params

_J_APPLY = jax.jit(jxlstm.apply, static_argnums=1)
_J_PREFILL = jax.jit(jxlstm.prefill, static_argnums=1)
_J_DECODE = jax.jit(jxlstm.decode_step, static_argnums=1)

ATOL = 1e-4
CELL_ATOL = 1e-5
CONFIGS = {"7:1 pattern, tail m m": dict(n_layers=10),
           "(s, m) pattern, tail s": dict(n_layers=3,
                                          xlstm_pattern=("s", "m"))}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def model(request):
    torch.set_num_threads(2)
    return both_params("xlstm-1.3b", 5, **CONFIGS[request.param])


def _np_inputs(seed, b, t, h, dh, i_shift=0.0):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32)
               for _ in range(3))
    it = (rng.standard_normal((b, t, h)) + i_shift).astype(np.float32)
    ft = (rng.standard_normal((b, t, h)) + 2.0).astype(np.float32)
    return q, k, v, it, ft


def _np_state(seed, b, h, dh):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, dh, dh)).astype(np.float32) * 0.1,
            rng.standard_normal((b, h, dh)).astype(np.float32) * 0.1,
            rng.standard_normal((b, h)).astype(np.float32))


def _close(got, want, atol=CELL_ATOL, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=atol,
                               rtol=1e-5, err_msg=what)


@pytest.mark.parametrize("t,chunk,carried,i_shift", [
    (50, 16, False, 0.0), (50, 16, True, 0.0), (64, 64, True, 0.0),
    (37, 64, False, 0.0), (40, 16, False, -200.0)],
    ids=["padded", "padded-carried", "one-chunk-carried", "short",
         "m-far-below-zero"])
def test_mlstm_chunkwise_matches_reference(t, chunk, carried, i_shift):
    b, h, dh = 2, 3, 8
    arrs = _np_inputs(t + chunk, b, t, h, dh, i_shift)
    st = _np_state(7, b, h, dh) if carried else None
    hj, sj = jxlstm.mlstm_chunkwise(
        *(jnp.asarray(a) for a in arrs),
        None if st is None else tuple(jnp.asarray(a) for a in st), chunk)
    ht, stt = xlstm.mlstm_chunkwise(
        *(torch.from_numpy(a) for a in arrs),
        None if st is None else tuple(torch.from_numpy(a) for a in st),
        chunk)
    assert ht.dtype == torch.float32 and tuple(ht.shape) == (b, t, h, dh)
    _close(ht, hj, what="h")
    for name, a, w in zip("Cnm", stt, sj):
        _close(a, w, atol=CELL_ATOL * max(1.0, float(np.abs(w).max())),
               what=name)
    if i_shift < -100:      # h underflows to 0 through the inf denominator
        assert float(ht.abs().max()) == 0.0 == float(np.abs(hj).max())


def test_mlstm_recurrent_step_matches_reference_and_one_chunk():
    b, h, dh = 2, 3, 8
    arrs = _np_inputs(11, b, 1, h, dh)
    st = _np_state(12, b, h, dh)
    hj, sj = jxlstm.mlstm_recurrent_step(*(jnp.asarray(a) for a in arrs),
                                         tuple(jnp.asarray(a) for a in st))
    tin = [torch.from_numpy(a) for a in arrs]
    ts = tuple(torch.from_numpy(a) for a in st)
    ht, stt = xlstm.mlstm_recurrent_step(*tin, ts)
    _close(ht, hj, what="h")
    for name, a, w in zip("Cnm", stt, sj):
        _close(a, w, what=name)
    hc, sc = xlstm.mlstm_chunkwise(*tin, ts, chunk=1)
    torch.testing.assert_close(ht, hc, atol=CELL_ATOL, rtol=1e-5)
    for a, c in zip(stt, sc):
        torch.testing.assert_close(a, c, atol=CELL_ATOL, rtol=1e-5)


@pytest.mark.parametrize("with_state", [False, True])
def test_slstm_block_matches_reference(model, with_state):
    cfg_j, cfg_t, pj, pt = model
    where = "tail" if cfg_t.xlstm_pattern == ("s", "m") else "groups"
    sj = pj[where]["blk0"] if where == "tail" else jax.tree_util.tree_map(
        lambda a: a[0], pj["groups"]["blk7"])
    st = (pt["tail"]["blk0"] if where == "tail"
          else xlstm._index(pt["groups"]["blk7"], 0))
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, cfg_t.d_model)).astype(np.float32)
    state = None
    if with_state:
        d = cfg_t.d_model
        state = tuple(rng.standard_normal((2, d)).astype(np.float32)
                      for _ in range(4))
    yj, stj = jxlstm._slstm_block(
        sj, cfg_j, jnp.asarray(x),
        None if state is None else tuple(jnp.asarray(a) for a in state))
    yt, stt = xlstm._slstm_block(
        st, cfg_t, torch.from_numpy(x),
        None if state is None else tuple(torch.from_numpy(a) for a in state))
    _close(yt, yj, atol=ATOL, what="x + ffn")
    for name, a, w in zip("cnmh", stt, stj):
        assert a.dtype == torch.float32
        _close(a, w, atol=ATOL, what=name)


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s)) \
        .astype(np.int32)


def test_apply_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(5, 2, 90, cfg_j.vocab_size)
    want = _J_APPLY(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    got = registry.apply_logits(pt, cfg_t, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    _, aux = registry.apply_with_aux(pt, cfg_t,
                                     {"tokens": torch.from_numpy(toks)})
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def _caches_close(ct, cj):
    for blk, st in cj["groups"].items():
        for name, a in st.items():
            np.testing.assert_allclose(ct["groups"][blk][name].numpy(),
                                       np.asarray(a), atol=ATOL, rtol=1e-5,
                                       err_msg=f"groups.{blk}.{name}")
    assert len(ct["tail"]) == len(cj["tail"])
    for i, st in enumerate(cj["tail"]):
        assert set(ct["tail"][i]) == set(st)
        for name, a in st.items():
            np.testing.assert_allclose(ct["tail"][i][name].numpy(),
                                       np.asarray(a), atol=ATOL, rtol=1e-5,
                                       err_msg=f"tail.{i}.{name}")
    assert int(ct["length"]) == int(cj["length"])


def test_prefill_and_decode_match_reference(model):
    cfg_j, cfg_t, pj, pt = model
    toks = _tokens(6, 2, 90, cfg_j.vocab_size)
    lj, cj = _J_PREFILL(pj, cfg_j, {"tokens": jnp.asarray(toks)})
    lt, ct = xlstm.prefill(pt, cfg_t, torch.from_numpy(toks), capacity=128)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
    _caches_close(ct, cj)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for _ in range(6):
        lj, cj = _J_DECODE(pj, cfg_j, cj, jnp.asarray(tok))
        lt, ct = xlstm.decode_step(pt, cfg_t, ct, torch.from_numpy(tok))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=ATOL)
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    _caches_close(ct, cj)


def test_prefill_then_decode_matches_apply(model):
    """One decode step after a prefill equals the full-sequence forward's
    last position (the chunkwise and recurrent forms agree)."""
    _, cfg, _, pt = model
    toks = torch.from_numpy(_tokens(8, 2, 70, cfg.vocab_size)).long()
    lg, cache = xlstm.prefill(pt, cfg, toks)
    nt = torch.argmax(lg, -1)
    lg2, _ = xlstm.decode_step(pt, cfg, cache, nt)
    full = xlstm.apply(pt, cfg, {"tokens": torch.cat([toks, nt], dim=1)})
    np.testing.assert_allclose(lg2.numpy(), full[:, -1:].numpy(), atol=2e-4,
                               rtol=2e-3)


def _pairs(tj, tt, where=""):
    """(path, numpy leaf, tensor leaf) of two trees of the same keys."""
    assert set(tj) == set(tt), where
    for k in tj:
        if isinstance(tj[k], dict):
            yield from _pairs(tj[k], tt[k], f"{where}.{k}")
        else:
            yield f"{where}.{k}", tj[k], tt[k]


def test_bridge_keeps_fp32_leaves_and_checks_keys():
    """A bf16 tree crosses over leaf for leaf: the same values, shapes and
    dtypes, so the gate weights ``w_i``/``w_f``/``b_f`` of the mLSTM and
    ``r_*``/``b_f`` of the sLSTM stay float32; a missing leaf raises."""
    cfg_j = jax_get_config("xlstm-1.3b").smoke().replace(n_layers=10)
    cfg_t = get_config("xlstm-1.3b").smoke().replace(n_layers=10)
    assert cfg_t.dtype == "bfloat16"
    tree = jax.tree_util.tree_map(np.asarray, jregistry.init(
        jax.random.PRNGKey(3), cfg_j))
    pt = bridge.params_from_jax(tree, cfg_t, "cpu")
    assert xlstm.group_structure(cfg_t) == (1, ("m", "m"))
    n_fp32 = 0
    for path, a, t in _pairs(tree, pt):
        assert str(t.dtype).replace("torch.", "") == a.dtype.name, path
        assert tuple(t.shape) == a.shape, path
        np.testing.assert_array_equal(t.float().numpy(),
                                      a.astype(np.float32), err_msg=path)
        n_fp32 += t.dtype == torch.float32
    # 9 mLSTM blocks x (w_i, w_f, b_f) + 1 sLSTM x (4 r_* + b_f)
    assert n_fp32 == 9 * 3 + 5
    del tree["tail"]["blk1"]["w_up"]
    with pytest.raises(KeyError, match="tail.blk1"):
        bridge.params_from_jax(tree, cfg_t, "cpu")


def test_registry_init_has_the_reference_tree_and_dtypes():
    """The port's own init (the card's weights) makes the reference's
    leaves at the reference's shapes and dtypes."""
    cfg_j = jax_get_config("xlstm-1.3b").smoke().replace(n_layers=10)
    cfg_t = get_config("xlstm-1.3b").smoke().replace(n_layers=10)
    want = jax.tree_util.tree_map(
        lambda a: (tuple(a.shape), str(a.dtype)),
        jax.eval_shape(functools.partial(jregistry.init, cfg=cfg_j),
                       jax.random.PRNGKey(0)))
    got = registry.init(cfg_t, torch.Generator().manual_seed(0), "cpu")

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, list):
            return [shapes(v) for v in t]
        return (tuple(t.shape), str(t.dtype).replace("torch.", ""))

    assert shapes(got) == want


def test_registry_has_every_family_with_the_reference_capabilities():
    """Every family of ``repro.models.registry`` is in the port's, with the
    same capabilities: the ssm and audio families (like hybrid) have no
    aux loss, no slot decode and no paged or verify path."""
    want = {name: (f.has_aux, f.slot_decode, f.paged_decode is not None,
                   f.paged_verify is not None)
            for name, f in jregistry.FAMILIES.items()}
    got = {name: (f.has_aux, f.slot_decode, f.paged_decode is not None,
                  f.paged_verify is not None)
           for name, f in registry.FAMILIES.items()}
    assert got == want
    assert got["ssm"] == got["audio"] == (False, False, False, False)
