"""Shared layers on tensors: norms, RoPE, initializers.

Port of ``repro.models.common`` (norms, ``rope_freqs``/``apply_rope``,
the vlm family's ``apply_mrope``, ``dense_init``/``embed_init``).
Arithmetic runs in float32 and casts back to the input dtype, as in the
reference.  The reference's sharding
annotations (``cm.shard``) have no counterpart on one card.
"""

from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(x * x, dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mu) ** 2, dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def apply_norm(x: torch.Tensor, p: dict, norm_type: str) -> torch.Tensor:
    if norm_type == "layernorm":
        return layer_norm(x, p["scale"], p["bias"])
    return rms_norm(x, p["scale"])


def norm_params(shape, norm_type: str, dtype: torch.dtype,
                device: torch.device | str) -> dict:
    """A norm's fresh parameters of ``shape`` (``(d,)``, or ``(L, d)``
    stacked on layers): unit scale, plus a zero bias for LayerNorm, as the
    reference starts them."""
    p = {"scale": torch.ones(shape, dtype=dtype, device=device)}
    if norm_type == "layernorm":
        p["bias"] = torch.zeros(shape, dtype=dtype, device=device)
    return p


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GeLU, the tanh approximation (``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")


def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str = "cpu") -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, D); positions: (B, S) integer."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (D/2,)
    ang = positions[..., None].float() * freqs                # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor, theta: float,
                sections) -> torch.Tensor:
    """Qwen2-VL M-RoPE.  x: (B, S, H, D); positions: (B, S, 3) = (t, h, w)
    ids.  The D/2 rotary frequencies are split into ``sections`` (t, h,
    w); each section rotates by its own position id (arXiv:2409.12191
    §3.1)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                    # (D/2,)
    assert sum(sections) == d // 2, (
        f"mrope_sections {sections} must sum to head_dim/2 = {d // 2}")
    sec = torch.repeat_interleave(
        torch.arange(len(sections), device=x.device),
        torch.tensor(sections, device=x.device))              # (D/2,)
    pos = positions.float()[..., sec]                         # (B, S, D/2)
    ang = pos * freqs
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def dense_init(gen: torch.Generator, shape, dtype: torch.dtype,
               device: torch.device | str, scale: float = 1.0) -> torch.Tensor:
    """Normal(0, scale / sqrt(d_in)) weights; ``shape[-2]`` is d_in (the
    reference's ``(d_in, d_out)`` layout, optionally stacked on layers)."""
    std = scale / (shape[-2] ** 0.5)
    return torch.empty(shape, dtype=dtype, device=device).normal_(
        0.0, std, generator=gen)


def embed_init(gen: torch.Generator, vocab: int, d: int, dtype: torch.dtype,
               device: torch.device | str) -> torch.Tensor:
    return torch.empty((vocab, d), dtype=dtype, device=device).normal_(
        0.0, 0.02, generator=gen)
