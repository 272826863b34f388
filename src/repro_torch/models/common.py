"""Shared layers on tensors: norms, RoPE, initializers, sharding.

Port of ``repro.models.common`` (norms, ``rope_freqs``/``apply_rope``,
the vlm family's ``apply_mrope``, ``dense_init``/``embed_init``, and the
logical sharding annotations ``logical``/``shard``), with the port's own
helpers for DTensor params and caches that several families share
(``gathered``, ``used``, ``embed_rows``, ``copy_into``, ``flip0``,
``project_out``).  Arithmetic runs in
float32 and casts back to the input dtype, as in the reference.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate

from repro_torch.compat import meshenv
from repro_torch.models import runtime

# ---------------------------------------------------------------------------
# logical sharding: annotate intermediates; the ambient mesh resolves axes.
# data-parallel batch spans ("pod", "data"); tensor-parallel spans "model".
# ---------------------------------------------------------------------------

BATCH_AXES = ("pod", "data")


def logical(*axes: Optional[str]) -> Tuple:
    """A spec from logical axis names, dropping mesh axes that do not
    exist: ``logical("batch", None, "model")`` maps batch to ``("pod",
    "data")`` when the pod axis exists, else ``("data",)``; "seq" maps to
    ``"model"`` only under ``runtime.seq_parallel``."""
    present = meshenv.axis_names()
    spec = []
    for a in axes:
        if a is None:
            spec.append(None)
        elif a == "batch":
            got = tuple(x for x in BATCH_AXES if x in present)
            spec.append(got if got else None)
        elif a == "seq":
            spec.append("model" if (runtime.seq_parallel()
                                    and "model" in present) else None)
        else:
            spec.append(a if a in present else None)
    return tuple(spec)


def shard(x: torch.Tensor, *axes: Optional[str]) -> torch.Tensor:
    """Constrain the DTensor ``x`` to ``logical(*axes)`` under the ambient
    mesh; ``x`` unchanged with no mesh or when it is a plain tensor.  An
    axis that does not divide its dim is dropped, where the reference's
    GSPMD would pad: DTensor's view rules need even shards."""
    mesh = meshenv.current_mesh()
    if mesh is None:
        return x
    spec = tuple(e if x.shape[d] % meshenv.mesh_size(mesh, e) == 0 else None
                 for d, e in enumerate(logical(*axes)))
    return meshenv.with_sharding_constraint(x, spec)


def gathered(w: torch.Tensor) -> torch.Tensor:
    """A weight as it is used: its FSDP shards (every mesh dim but
    ``model``) gathered, as FSDP gathers a weight before use and
    reduce-scatters its gradient after; a plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    want = [p if n == "model" else Replicate()
            for n, p in zip(mesh.mesh_dim_names, w.placements)]
    return w if list(w.placements) == want else w.redistribute(mesh, want)


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """The rows of ``table`` (V, d) at ``tokens`` (B, S) -> (B, S, d).  On
    DTensors each rank looks its own batch rows up in the whole table, its
    gradient a partial sum over the shards of the rows: DTensor's index
    and embedding rules fail in their backward (torch 2.11 and 2.13)."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    rows = list(tokens.placements)
    if any(p.is_shard() and p.dim != 0 for p in rows):
        raise ValueError(f"tokens placed {rows}: only the batch dim may be "
                         f"sharded")
    whole = gathered(table)
    whole = whole.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=[Partial() if p.is_shard() else Replicate()
                         for p in rows])
    return DTensor.from_local(whole[tokens.to_local()], mesh, rows,
                              run_check=False)


def used(tree: Dict) -> Dict:
    """Params as they are used: under a mesh, FSDP-gathered
    (``gathered``); plain tensors as they are."""
    return {k: (used(v) if isinstance(v, dict) else gathered(v))
            for k, v in tree.items()}


def copy_into(dst: torch.Tensor, src: torch.Tensor) -> None:
    """``dst.copy_(src)`` in place, where ``dst`` may be a DTensor view of
    a stacked cache: ``src`` is first laid out as ``dst`` is, so each
    rank writes its own shard into the cache's storage."""
    if isinstance(dst, DTensor):
        mesh = dst.device_mesh
        if not isinstance(src, DTensor):
            src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                     run_check=False)
        if list(src.placements) != list(dst.placements):
            src = src.redistribute(mesh, dst.placements)
        dst.to_local().copy_(src.to_local())
        return
    dst.copy_(src)


def flip0(w: torch.Tensor) -> torch.Tensor:
    """``w.flip(0)`` by a stack of its rows in reverse: DTensor has no
    rule for ``flip`` in torch 2.11."""
    return torch.stack([w[i] for i in reversed(range(w.shape[0]))])


def project_out(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """A block's output projection back to the residual stream; under a
    mesh its partial sums over ``model`` are summed here, where the
    reference's GSPMD sums them (left partial, DTensor would carry them
    into the next norm)."""
    return shard(a @ w, "batch", "seq", None)


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
    sec = torch.tensor([i for i, n in enumerate(sections) for _ in range(n)],
                       device=x.device)                       # (D/2,)
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
