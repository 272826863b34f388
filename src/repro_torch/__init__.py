"""repro_torch — the PyTorch/CUDA port of ``repro`` for one NVIDIA H100.

The JAX package ``repro`` stays the reference; this package imports
``torch`` and nothing of ``jax`` or ``repro``.  Host-only layers
(``obs``, ``sim``, ``core``) are the port's own copies of the reference
modules, pinned equal to them by ``tests/test_torch_imports.py``.  The
model and serving layers are rewritten on tensors, and every TPU kernel
on the served path is a hand-written CUDA kernel under ``kernels/csrc``.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where each kernel wrapper takes its plain PyTorch version.
"""
