"""The engine's remaining surface vs ``repro`` (CPU, fp32, smoke config).

* ``registry.apply_logits`` (the full-sequence forward over ``prefill``'s
  block loop) equals the reference's at every position, atol 1e-4, as
  ``tests/test_torch_dense.py`` holds prefill; its last position equals
  the port's own prefill logits.
* ``Engine.logprob_of`` (what the real-engine duel judges call) equals
  the reference's within 1e-4 and the sum of the gold tokens'
  log-softmax over ``apply_logits``.
* ``Engine.generate_batch`` is token-exact against the reference.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import registry as jregistry
from repro.serving import Engine as JEngine
from repro.serving import GenRequest as JGenRequest
from repro_torch.configs import get_config
from repro_torch.models import bridge, dense, registry
from repro_torch.serving import Engine, GenRequest

ATOL = 1e-4


@pytest.fixture(scope="module")
def setup():
    torch.set_num_threads(2)
    cfg_j = jax_get_config("qwen3-8b").smoke().replace(dtype="float32")
    cfg_t = get_config("qwen3-8b").smoke().replace(dtype="float32")
    pj = jregistry.init(jax.random.PRNGKey(0), cfg_j)
    pt = bridge.params_from_jax(jax.tree_util.tree_map(np.asarray, pj),
                                cfg_t, "cpu")
    return cfg_j, cfg_t, pj, pt


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(2, vocab, size=(b, s)) \
        .astype(np.int32)


@pytest.mark.parametrize("b,s", [(1, 7), (2, 24), (1, 40)])
def test_apply_logits_equals_reference(setup, b, s):
    cfg_j, cfg_t, pj, pt = setup
    toks = _tokens(s, b, s, cfg_t.vocab_size)
    want = np.asarray(jregistry.apply_logits(
        pj, cfg_j, {"tokens": jnp.asarray(toks)}, q_chunk=256,
        kv_chunk=256))
    got = registry.apply_logits(pt, cfg_t,
                                {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (b, s, cfg_t.padded_vocab) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    # the last position is what prefill returns: one block loop
    last, _ = dense.prefill(pt, cfg_t, torch.from_numpy(toks).long())
    np.testing.assert_allclose(got[:, -1:].numpy(), last.numpy(), atol=1e-5,
                               rtol=0)


@pytest.mark.parametrize("n", [2, 17, 33])
def test_logprob_of_equals_reference(setup, n):
    cfg_j, cfg_t, pj, pt = setup
    toks = _tokens(100 + n, 1, n, cfg_t.vocab_size)[0]
    want = JEngine(cfg_j, pj, max_batch=2, bucket=16).logprob_of(toks)
    eng = Engine(cfg_t, pt, max_batch=2, bucket=16)
    got = eng.logprob_of(toks)
    assert isinstance(got, float)
    assert got == pytest.approx(want, abs=ATOL, rel=0)
    # the same sum taken from the full-sequence logits
    logits = registry.apply_logits(
        pt, cfg_t, {"tokens": torch.from_numpy(toks[None, :-1]).long()})
    lp = torch.log_softmax(logits[0].double(), dim=-1)
    gold = lp[torch.arange(n - 1), torch.from_numpy(toks[1:]).long()]
    assert got == pytest.approx(float(gold.sum()), abs=ATOL, rel=0)


@pytest.mark.parametrize("kw", [dict(), dict(paged=True, page_size=8)])
def test_generate_batch_token_exact(setup, kw):
    cfg_j, cfg_t, pj, pt = setup
    rng = np.random.default_rng(3)
    prompts = [rng.integers(2, 400, size=n).astype(np.int32)
               for n in (5, 19, 11)]
    ej = JEngine(cfg_j, pj, max_batch=3, bucket=16, **kw)
    et = Engine(cfg_t, pt, max_batch=3, bucket=16, **kw)
    rj = ej.generate_batch([JGenRequest(rid=f"g{i}", tokens=p, max_new=6)
                            for i, p in enumerate(prompts)])
    rt = et.generate_batch([GenRequest(rid=f"g{i}", tokens=p, max_new=6)
                            for i, p in enumerate(prompts)])
    assert [r.rid for r in rt] == [r.rid for r in rj]
    for a, b in zip(rj, rt):
        np.testing.assert_array_equal(b.result, a.result, err_msg=a.rid)
    assert et.stats.served == ej.stats.served == 3
    with pytest.raises(AssertionError):
        et.generate_batch([GenRequest(rid=f"x{i}", tokens=prompts[0])
                           for i in range(4)])
