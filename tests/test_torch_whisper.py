"""Port audio family (whisper-base: encoder-decoder) vs the JAX package (CPU).

On the same bridged weights in fp32 at the smoke width (2 encoder and 2
decoder layers over 64 frames, head width 64), with every bias, LayerNorm
bias and scale moved off its start (``tests/test_torch_dense_variants.py``'s
``perturbed``) and the positional tables ``enc_pos``/``dec_pos`` moved by
N(0, 0.1) too, both at the smoke config's 4/2 heads (rep 2) and at 4/4
(rep 1, whisper-base's own ratio): ``encode``, ``apply``, ``prefill``
(logits and caches) and lock-step ``decode_step`` past a wrap of the
self-attention ring, each held to the reference to 1e-4 absolute
(``tests/test_torch_dense.py``'s tolerance); prefill-then-decode against
``apply`` over the whole sequence; and a prefill given tokens alone (what
the engine's wave path passes) raising ``KeyError('encoder_embeds')`` in
both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import whisper as jwhisper
from repro_torch.models import registry, whisper
from test_torch_dense_variants import both_params

_J_ENCODE = jax.jit(jwhisper.encode, static_argnums=1)
_J_APPLY = jax.jit(jwhisper.apply, static_argnums=1)
_J_PREFILL = jax.jit(jwhisper.prefill, static_argnums=1,
                     static_argnames=("capacity",))
_J_DECODE = jax.jit(jwhisper.decode_step, static_argnums=1)

ATOL = 1e-4
HEADS = {"rep2": {}, "rep1": dict(n_kv_heads=4)}


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module", params=sorted(HEADS))
def model(request):
    torch.set_num_threads(2)
    cfg_j, cfg_t, pj, pt = both_params("whisper-base", 9,
                                       **HEADS[request.param])
    rng = np.random.default_rng(10)
    for name in ("enc_pos", "dec_pos"):
        moved = (np.asarray(pj[name])
                 + 0.1 * rng.standard_normal(pj[name].shape)).astype(
                     np.float32)
        pj = {**pj, name: jnp.asarray(moved)}
        pt[name] = torch.from_numpy(moved)
    assert cfg_t.n_heads // cfg_t.n_kv_heads == int(request.param[-1])
    return cfg_j, cfg_t, pj, pt


def _inputs(seed, cfg, b, s):
    rng = np.random.default_rng(seed)
    emb = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(2, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return ({"encoder_embeds": jnp.asarray(emb), "tokens": jnp.asarray(toks)},
            {"encoder_embeds": torch.from_numpy(emb),
             "tokens": torch.from_numpy(toks)})


def _close(got, want, what=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=1e-5, err_msg=what)


def test_encode_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _inputs(1, cfg_t, 2, 8)
    _close(whisper.encode(pt, cfg_t, bt["encoder_embeds"]),
           _J_ENCODE(pj, cfg_j, bj["encoder_embeds"]))


def test_apply_matches_reference(model):
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _inputs(2, cfg_t, 2, 21)
    got = registry.apply_logits(pt, cfg_t, bt)
    assert tuple(got.shape) == (2, 21, cfg_t.padded_vocab)
    _close(got, _J_APPLY(pj, cfg_j, bj))
    _, aux = registry.apply_with_aux(pt, cfg_t, bt)
    assert aux.dtype == torch.float32 and float(aux) == 0.0


def test_prefill_and_decode_past_a_ring_wrap_match_reference(model):
    """A 10-token prompt in a ring of 16: the 12 decode steps write slots
    10-15, then wrap to 0-5, attending all 16."""
    cfg_j, cfg_t, pj, pt = model
    bj, bt = _inputs(3, cfg_t, 2, 10)
    lj, cj = _J_PREFILL(pj, cfg_j, bj, capacity=16)
    lt, ct = whisper.prefill(pt, cfg_t, bt, capacity=16)
    assert tuple(ct["k"].shape) == (cfg_t.n_layers, 2, 16, cfg_t.n_kv_heads,
                                    cfg_t.head_dim)
    assert tuple(ct["cross_k"].shape[2:3]) == (cfg_t.encoder_seq,)
    _close(lt, lj, "prefill logits")
    for name in ("k", "v", "cross_k", "cross_v"):
        _close(ct[name], cj[name], name)
    tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for step in range(12):
        lj, cj = _J_DECODE(pj, cfg_j, cj, jnp.asarray(tok))
        lt, ct = whisper.decode_step(pt, cfg_t, ct, torch.from_numpy(tok))
        _close(lt, lj, f"decode step {step}")
        tok = np.asarray(jnp.argmax(lj, -1)).astype(np.int32)
    for name in ("k", "v"):
        _close(ct[name], cj[name], name)
    assert int(ct["length"]) == int(cj["length"]) == 22


def test_prefill_then_decode_matches_apply(model):
    """One decode step after a prefill equals the full-sequence forward's
    last position (the ring has room: no wrap)."""
    _, cfg, _, pt = model
    _, bt = _inputs(4, cfg, 2, 12)
    lg, cache = whisper.prefill(pt, cfg, bt, capacity=32)
    nt = torch.argmax(lg, -1)
    lg2, _ = whisper.decode_step(pt, cfg, cache, nt)
    full = whisper.apply(pt, cfg, {
        "encoder_embeds": bt["encoder_embeds"],
        "tokens": torch.cat([bt["tokens"].long(), nt], dim=1)})
    np.testing.assert_allclose(lg2.numpy(), full[:, -1:].numpy(), atol=2e-4,
                               rtol=2e-3)


def test_prefill_on_tokens_alone_raises_as_the_reference_does(model):
    """The engine's wave path hands ``prefill`` the prompts' tokens only;
    both packages then raise the same ``KeyError``."""
    cfg_j, cfg_t, pj, pt = model
    toks = np.full((2, 8), 3, np.int32)
    with pytest.raises(KeyError) as ej:
        jwhisper.prefill(pj, cfg_j, {"tokens": jnp.asarray(toks)},
                         capacity=16)
    with pytest.raises(KeyError) as et:
        whisper.prefill(pt, cfg_t, torch.from_numpy(toks), capacity=16)
    assert et.value.args == ej.value.args == ("encoder_embeds",)
