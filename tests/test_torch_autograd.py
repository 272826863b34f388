"""Gradients through the port's attention rows.

On the card prefill attention (row 1) runs under
``kernels.flash_attention.FlashAttentionFn``: the kernel forward and a
backward that recomputes the attention through the plain version
(``kernels.ref.flash_ref``) and differentiates it.  The decode and verify
rows only serve: on the card ``kernels.ops.forbid_grad`` makes them raise
under grad instead of cutting the graph.

* CPU: ``torch.autograd.gradcheck`` in float64 of ``FlashAttentionFn``
  with its forward swapped to ``flash_ref`` (the kernel runs only on the
  card), and its gradients against plain autograd of ``flash_ref``;
  ``forbid_grad`` raises exactly when grad mode is on and an input
  requires grad.
* ``gpu``: ``chip_smoke.py``'s phase 6 checks, ``grads_through_row1``
  and ``decode_rows_raise``: one ``loss_fn`` backward at smoke widths in
  float32 (TF32 off) through the kernels, for a dense, a moe and a hybrid
  config with norm scales and biases perturbed, against the same backward
  with ``ops.attention`` patched to ``flash_ref``: every leaf's gradient
  within 1e-3 of that leaf's max|g|, and ``wq``, ``wk``, ``wv`` (and,
  where the config has them, ``q_norm`` and ``k_norm``) nonzero; row 1
  launched as often as by a forward without grad; a decode and a paged
  decode row on an input that requires grad raise.  No JAX here, so on
  the card::

    PYTHONPATH=src python -m pytest --noconftest -m gpu tests/test_torch_autograd.py
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_ref

# (b, sq, skv, h, hkv, d, causal, window): GQA causal, a window, MQA
# without a mask at sq != skv (a cross attention)
CASES = [(2, 6, 6, 4, 2, 8, True, None),
         (1, 7, 7, 2, 1, 4, True, 3),
         (2, 3, 5, 4, 1, 4, False, None)]


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _qkv(case, dtype, device="cpu", seed=0):
    b, sq, skv, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    return tuple(torch.tensor(rng.standard_normal(shape), dtype=dtype,
                              device=device, requires_grad=True)
                 for shape in ((b, sq, h, d), (b, skv, hkv, d),
                               (b, skv, hkv, d)))


@pytest.mark.parametrize("case", CASES)
def test_function_gradcheck_with_plain_forward(monkeypatch, case):
    """The Function's plumbing (saved inputs, GQA shapes, the two
    non-tensor arguments) in float64, its forward the plain version."""
    causal, window = case[6:]
    monkeypatch.setattr(fa, "flash_attention_cuda",
                        lambda q, k, v, causal, window: flash_ref(
                            q, k, v, causal=causal, window=window))
    q, k, v = _qkv(case, torch.float64)
    assert torch.autograd.gradcheck(
        lambda q, k, v: fa.FlashAttentionFn.apply(q, k, v, causal, window),
        (q, k, v))
    g = torch.randn(q.shape, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    got = torch.autograd.grad(
        fa.FlashAttentionFn.apply(q, k, v, causal, window), (q, k, v), g)
    want = torch.autograd.grad(
        flash_ref(q, k, v, causal=causal, window=window), (q, k, v), g)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-12)


def test_function_returns_no_grad_for_inputs_that_need_none(monkeypatch):
    monkeypatch.setattr(fa, "flash_attention_cuda",
                        lambda q, k, v, causal, window: flash_ref(
                            q, k, v, causal=causal, window=window))
    q, k, v = _qkv(CASES[0], torch.float64)
    k, v = k.detach(), v.detach()
    fa.FlashAttentionFn.apply(q, k, v, True, None).sum().backward()
    assert q.grad is not None and k.grad is None and v.grad is None


def test_forbid_grad_raises_only_under_grad():
    x = torch.zeros(2, 3, requires_grad=True)
    y = torch.zeros(2, 3)
    with pytest.raises(RuntimeError, match="paged_decode has no backward"):
        ops.forbid_grad("paged_decode", y, x)
    ops.forbid_grad("paged_decode", y, y)
    with torch.no_grad():
        ops.forbid_grad("paged_decode", y, x)


# ---------------------------------------------------------------- the card
def chip_smoke():
    """The repo's ``chip_smoke.py`` as a module: its phase 6 checks."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", pathlib.Path(__file__).resolve().parents[1]
        / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-8b", "granite-moe-1b-a400m",
                                  "recurrentgemma-9b"])
def test_card_gradients_through_row1_match_plain(cuda, arch):
    smoke = chip_smoke()
    r = smoke.grads_through_row1(arch, dict(smoke.GRAD_ARCHS)[arch])
    assert r["row1_launches"] > 0 and r["worst_rel_err"] <= smoke.GRAD_REL


@pytest.mark.gpu
def test_card_decode_rows_raise_under_grad(cuda):
    chip_smoke().decode_rows_raise()
