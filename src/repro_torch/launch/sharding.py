"""Sharding rules: a spec for every param, batch and cache leaf.

Port of ``repro.launch.sharding``; the rules are pure functions of
``(path, shape, axis sizes)`` and give the reference's specs leaf for
leaf.  A spec is a tuple with one entry per tensor dim (``()`` is the
reference's ``P()``), each ``None``, a mesh axis name or a tuple of
names; ``placements`` turns it into DTensor placements on a mesh and
``distribute`` a tree of tensors into DTensors (``gather`` makes them
whole again).  A ``mesh`` argument is a
``DeviceMesh`` or a ``{axis_name: extent}`` dict in mesh order.

Scheme (the reference's baseline):

* batch dims -> ``("pod", "data")`` (data parallel);
* heads / ffn / vocab / experts / recurrence width -> ``"model"`` (tensor
  and expert parallel);
* the matching contraction dim of each weight -> ``"data"`` (FSDP);
* the KV cache's sequence dim at decode -> ``"model"``.

An axis that does not divide its dim falls back to ``None``.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.compat import meshenv
from repro_torch.compat.meshenv import placements  # noqa: F401  (re-export)

# last path component -> role
_UP = {"wq", "wk", "wv", "w_gate", "w_up", "w_up1", "w_up2", "w_y", "w_x",
       "w_a", "w_i", "w_z", "w_f", "router", "lm_head"}
_DOWN = {"wo", "w_down", "w_o"}
_EXPERT_UP = {"we_gate", "we_up"}
_EXPERT_DOWN = {"we_down"}
_KV = ("k", "v", "cross_k", "cross_v", "k_scale", "v_scale")


def _sizes(mesh) -> Dict[str, int]:
    return dict(mesh) if isinstance(mesh, dict) else meshenv.axis_sizes(mesh)


def _batch_axes(mesh) -> Tuple[str, ...]:
    names = _sizes(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def _fits(dim: int, mesh, axes) -> bool:
    if axes is None:
        return True
    if isinstance(axes, str):
        axes = (axes,)
    sizes = _sizes(mesh)
    return dim % math.prod(sizes[a] for a in axes) == 0


def _trim(spec: Tuple, shape: Tuple[int, ...], mesh) -> Tuple:
    """Drop the axes that do not evenly divide their dim."""
    return tuple(axes if _fits(dim, mesh, axes) else None
                 for dim, axes in zip(shape, spec))


def param_spec(path: str, shape: Tuple[int, ...], mesh) -> Tuple:
    """Spec of one parameter leaf; ``path`` is its ``/``-joined keys."""
    name = path.split("/")[-1]
    nd = len(shape)
    data = "data" if "data" in _sizes(mesh) else None
    if nd <= 1:
        return ()
    if name == "embed":
        return _trim(("model", data), shape, mesh)
    if name in ("enc_pos", "dec_pos"):
        return _trim((None, "model"), shape, mesh)
    if name in _EXPERT_UP:
        # (L, E, d_in, d_out): experts -> model, contraction -> data
        return _trim((None, "model", data, None), shape, mesh)
    if name in _EXPERT_DOWN:
        return _trim((None, "model", None, data), shape, mesh)
    if name in _UP:
        if nd == 2:
            return _trim((data, "model"), shape, mesh)
        if nd == 3:
            return _trim((None, data, "model"), shape, mesh)
        if nd == 4:   # stacked block-diagonal (G, H, dh, dh)
            return _trim((None, None, data, "model"), shape, mesh)
    if name in _DOWN:
        if nd == 2:
            return _trim(("model", data), shape, mesh)
        if nd == 3:
            return _trim((None, "model", data), shape, mesh)
        if nd == 4:
            return _trim((None, None, "model", data), shape, mesh)
    if name in ("r_z", "r_i", "r_f", "r_o"):   # sLSTM recurrent (G,H,dh,dh)
        return _trim((None, None, None, "model"), shape, mesh)
    if name in ("conv_w", "lam"):
        return _trim((None,) * (nd - 1) + ("model",), shape, mesh)
    return ()   # norms, biases, small leftovers: replicated


def _drop_data(spec: Tuple) -> Tuple:
    """The spec without the ``data`` (FSDP) axis."""
    out = []
    for a in spec:
        if a == "data":
            a = None
        elif isinstance(a, tuple):
            a = tuple(x for x in a if x != "data") or None
        out.append(a)
    return tuple(out)


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over nested dicts and lists (a list's index is
    its path component, as the reference's ``idx`` is: the hybrid and
    ssm caches' ``tail/0/h``), keeping the structure."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in
                tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}{i}/") for i, v in
                enumerate(tree)]
    return fn(prefix[:-1], tree)


def params_shardings(params_tree, mesh, *, data_fsdp: bool = True):
    """A tree of specs matching ``params_tree``.  ``data_fsdp=False``
    drops the ``data`` axis from every spec (the inference sharding:
    weights stay resident on their tensor-parallel ranks)."""
    def one(path, leaf):
        spec = param_spec(path, tuple(leaf.shape), mesh)
        return spec if data_fsdp else _drop_data(spec)
    return _map_paths(one, params_tree)


def batch_spec(shape: Tuple[int, ...], mesh) -> Tuple:
    """Tokens, labels, embeddings: the leading batch dim sharded."""
    spec = (_batch_axes(mesh),) + (None,) * (len(shape) - 1)
    return _trim(spec, shape, mesh)


def batch_shardings(batch_tree, mesh):
    return _map_paths(lambda _, leaf: batch_spec(tuple(leaf.shape), mesh),
                      batch_tree)


def cache_spec(path: str, shape: Tuple[int, ...], mesh) -> Tuple:
    """Decode caches: batch -> the data axes; long axes -> model."""
    name = path.split("/")[-1]
    bx = _batch_axes(mesh)
    nd = len(shape)
    if name in _KV:
        # (L, B, S, Hkv, dh): sequence-sharded KV over "model"
        return _trim((None, bx, "model", None, None), shape, mesh)
    if name == "length":
        return ()
    if name == "C":       # mLSTM matrix state (G, B, H, dh, dh)
        return _trim((None, bx, None, None, "model"), shape, mesh)
    if name in ("conv", "h", "n", "m", "c"):
        # conv history (G, B, cw-1, W) and recurrent vector states
        # (G, B, ...): the last dim over model
        return _trim((None, bx) + (None,) * (nd - 3) + ("model",), shape,
                     mesh)
    # default: batch only (dim 1 is batch for stacked (L, B, ...) caches)
    return _trim((None, bx) + (None,) * (nd - 2), shape, mesh)


def cache_shardings(cache_tree, mesh):
    return _map_paths(lambda path, leaf: cache_spec(path, tuple(leaf.shape),
                                                    mesh), cache_tree)


def opt_shardings(params_shard):
    """The optimizer moments mirror the parameter specs; the step count
    is replicated."""
    return {"mu": params_shard, "nu": params_shard, "step": ()}


def distribute(tree, specs, mesh):
    """DTensors of the tensors of ``tree`` on ``mesh``, each sharded as
    its spec in ``specs`` (a tree of the same structure) says.  Every
    rank holds the whole tensor and keeps its own shard, with no
    communication.  A shard that is the whole tensor (every mesh dim of
    size 1 or replicated) is the given tensor itself, which the caller
    gives up; a smaller one is a contiguous copy."""
    if isinstance(tree, dict):
        return {k: distribute(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute(v, s, mesh) for v, s in zip(tree, specs)]
    pl = placements(specs, mesh)
    coord = mesh.get_coordinate()
    local = tree
    for i, p in enumerate(pl):
        if p.is_shard():
            local = torch.chunk(local, mesh.size(i), dim=p.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=tree.shape, stride=tree.stride())


def gather(tree):
    """The whole tensors of a tree of DTensors (dicts and lists), plain
    tensors as they are: every rank gets every leaf in full."""
    return _map_paths(lambda _, leaf: leaf.full_tensor()
                      if isinstance(leaf, DTensor) else leaf, tree)
