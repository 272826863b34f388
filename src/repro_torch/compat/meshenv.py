"""Mesh environment: process groups, device meshes and the ambient mesh.

Port of the mesh half of ``repro.compat.meshenv``.  A ``DeviceMesh`` with
named dims stands for the reference's ``Mesh``; a ``DTensor`` with
``Shard``/``Replicate`` placements for a ``NamedSharding``.  A sharding
spec is what the reference writes as a ``PartitionSpec``: a tuple with
one entry per tensor dim (trailing dims may be left out), each ``None``,
a mesh dim name, or a tuple of names in mesh order (``("pod", "data")``).

* ``make_mesh(shape, axis_names, device_type)``: a mesh over the ranks of
  the process group, which must hold ``prod(shape)`` ranks.
* ``process_group(...)`` / ``fake_process_group(world_size)``: the group
  a mesh is built on, made and destroyed by a ``with`` block, with no
  environment variables.  The real form is NCCL on the card or gloo on
  the CPU, its ranks meeting at a ``FileStore`` (or a ``HashStore`` for a
  single rank); the fake form is one process standing as rank 0 of
  ``world_size`` (``FakeStore``): its collectives move nothing, which is
  what the dry run needs.
* ``mesh_context(mesh)``: enter ``mesh`` as the ambient mesh.  Inside it
  plain tensors meet DTensors as replicated ones (DTensor's
  ``implicit_replication``): the positions, masks and frequencies the
  model makes on the fly are the same on every rank.
* ``current_mesh``, ``axis_names``, ``axis_sizes``, ``mesh_size``:
  introspection, ``None`` / ``()`` / ``{}`` / 1 without a mesh.
* ``placed(mesh, dims)`` / ``placements(spec, mesh)``: DTensor
  placements from mesh dim names or from a spec, a mesh dim of size 1
  always replicated.
* ``with_sharding_constraint(x, spec)``: ``x.redistribute`` to the spec's
  placements; a no-op on a plain tensor or with no mesh.
* ``to_local(t, mesh, dims)`` / ``from_local(out, like, dims)``: a
  tensor's local shard laid out by ``dims``, and back to a DTensor: the
  bracket around code that runs on each rank's plain tensors (the
  kernels, the recurrent cells).
* ``shard_offset(x, dim)``: where this rank's shard of a DTensor starts
  along ``dim``.
* ``submesh(mesh, names)`` / ``onto(t, sub)`` / ``lift(t, mesh)``: the
  mesh of some of a mesh's dims, a DTensor moved onto it (gathered over
  the other dims), and a result moved back: the form a step takes where
  some mesh dims only replicate its work (rows that a data axis does not
  divide).
* ``abstract_mode()``: the active ``FakeTensorMode`` or a new one, for
  the dry run's and ``launch.specs``' abstract values.

The reference's ``shard_map`` has no counterpart: its two users
(``attention.decode_attention_seqsharded`` and ``moe._moe_mlp_a2a``) are
per-rank code on ``to_local`` shards with collectives on
``mesh.get_group(dim)``.
"""

from __future__ import annotations

import contextlib
import math
from contextvars import ContextVar
from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import DTensor, Replicate, Shard

Axes = Union[None, str, Tuple[str, ...]]

_MESH: ContextVar[Optional[DeviceMesh]] = ContextVar("repro_torch_mesh",
                                                     default=None)


# ----------------------------------------------------------- process groups
@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world_size: int = 1,
                  store_path: Optional[str] = None):
    """A real process group for the block: ``backend`` "nccl" (the card)
    or "gloo" (the CPU); ranks meet at a ``FileStore`` at ``store_path``
    (every rank passes the same path), or, for one rank, at a
    ``HashStore``.  The group is destroyed when the block ends."""
    if store_path is None:
        if world_size != 1:
            raise ValueError("ranks of a group of more than one meet at a "
                             "FileStore: give store_path")
        store = dist.HashStore()
    else:
        store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def fake_process_group(world_size: int):
    """This process as rank 0 of ``world_size`` fake ranks for the block:
    meshes of that many devices build, and collectives move nothing."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


# --------------------------------------------------------------------- mesh
def make_mesh(axis_shapes, axis_names, device_type: str = "cuda"
              ) -> DeviceMesh:
    """A ``DeviceMesh`` of ``axis_shapes`` with ``axis_names`` over the
    ranks of the current process group, on ``device_type``."""
    return init_device_mesh(device_type, tuple(axis_shapes),
                            mesh_dim_names=tuple(axis_names))


def current_mesh() -> Optional[DeviceMesh]:
    """The ambient mesh, or ``None`` outside ``mesh_context``."""
    return _MESH.get()


def axis_names() -> Tuple[str, ...]:
    m = current_mesh()
    return () if m is None else tuple(m.mesh_dim_names)


def axis_sizes(mesh=None) -> Dict[str, int]:
    """``{axis_name: extent}`` of ``mesh`` (default: the ambient one)."""
    m = current_mesh() if mesh is None else mesh
    if m is None:
        return {}
    return dict(zip(m.mesh_dim_names, m.shape))


def mesh_size(mesh, axes: Axes) -> int:
    """Product of the named axis extents (1 for ``None`` or no mesh)."""
    if mesh is None or axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = axis_sizes(mesh)
    return math.prod(sizes[a] for a in axes)


@contextlib.contextmanager
def mesh_context(mesh: DeviceMesh):
    """Enter ``mesh`` as the ambient mesh; plain tensors made inside
    count as replicated where they meet DTensors.  Nested in another
    (a sub-mesh's step), it leaves the outer block's implicit replication
    on when it ends: DTensor's own context would switch it off."""
    from torch.distributed.tensor.experimental import implicit_replication
    outer = DTensor._op_dispatcher._allow_implicit_replication
    tok = _MESH.set(mesh)
    try:
        with (contextlib.nullcontext() if outer
              else implicit_replication()):
            yield mesh
    finally:
        _MESH.reset(tok)


# ---------------------------------------------------------------- placements
def _entry_axes(entry: Axes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placed(mesh: DeviceMesh, dims: Dict[str, int]):
    """Placements on ``mesh`` with ``Shard(dims[n])`` on each mesh dim
    ``n`` that ``dims`` names and ``Replicate()`` on the rest.  A mesh dim
    of size 1 is ``Replicate()`` whatever ``dims`` says: its one shard is
    the whole tensor, and DTensor's view rules refuse to merge a sharded
    dim of global size 1."""
    return [Shard(dims[n]) if n in dims and size > 1 else Replicate()
            for n, size in zip(mesh.mesh_dim_names, mesh.shape)]


def to_local(t: torch.Tensor, mesh, shard_dims: Dict[str, int]
             ) -> torch.Tensor:
    """The local shard of ``t`` (a plain tensor counts as replicated)
    redistributed to ``shard_dims`` (``placed``), contiguous: the input of
    a function that runs on each rank's plain tensors."""
    if not isinstance(t, DTensor):
        t = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    want = placed(mesh, shard_dims)
    if list(t.placements) != want:
        t = t.redistribute(mesh, want)
    return t.to_local().contiguous()


def from_local(out: torch.Tensor, like: DTensor,
               shard_dims: Dict[str, int]) -> DTensor:
    """``out``, this rank's shard of a tensor shaped as ``like``, as a
    contiguous DTensor placed by ``shard_dims`` (its shards even)."""
    mesh = like.device_mesh
    return DTensor.from_local(out.contiguous(), mesh,
                              placed(mesh, shard_dims),
                              run_check=False)


def placements(spec, mesh: DeviceMesh):
    """The DTensor placements of ``spec`` on ``mesh`` (``placed``):
    ``Shard(d)`` on every mesh dim that tensor dim ``d`` names.  The
    names of one entry must be in mesh order, the order in which DTensor
    nests shards of one tensor dim."""
    names = tuple(mesh.mesh_dim_names)
    dims: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec entry {entry!r} is not in mesh order "
                             f"{names}")
        dims.update({a: d for a in axes})
    return placed(mesh, dims)


def with_sharding_constraint(x: torch.Tensor, spec) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to ``spec`` under the ambient mesh;
    a plain tensor, or any tensor with no mesh, is returned as it is."""
    m = current_mesh()
    if m is None or not isinstance(x, DTensor):
        return x
    want = placements(spec, m)
    if list(x.placements) == want:
        return x
    out = x.redistribute(m, want)
    # a shard cut from a replicated tensor is a strided view, which the
    # local views of later reshapes cannot take
    local = out.to_local()
    if local.is_contiguous():
        return out
    return DTensor.from_local(local.contiguous(), m, want, run_check=False,
                              shape=out.shape, stride=out.stride())


def shard_offset(x: DTensor, dim: int) -> int:
    """The global index at which this rank's shard of ``x`` starts along
    ``dim`` (the shards of ``x`` along ``dim`` being even)."""
    mesh = x.device_mesh
    coord = mesh.get_coordinate()
    index, count = 0, 1
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim == dim:
            index = index * mesh.size(i) + coord[i]
            count *= mesh.size(i)
    return index * (x.shape[dim] // count)


def submesh(mesh: DeviceMesh, names) -> DeviceMesh:
    """The mesh of ``mesh``'s dims named in ``names``, in mesh order."""
    keep = tuple(n for n in mesh.mesh_dim_names if n in names)
    return mesh[keep if len(keep) > 1 else keep[0]]


def onto(t: torch.Tensor, sub: DeviceMesh) -> torch.Tensor:
    """The DTensor ``t`` as a DTensor on ``sub``, a sub-mesh of its mesh:
    replicated first over the dims that ``sub`` lacks, its gradient on
    the way back replicated over them too, as every rank along them
    computes the same one.  A plain tensor is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    mesh, keep = t.device_mesh, sub.mesh_dim_names
    pl = [p if n in keep else Replicate()
          for n, p in zip(mesh.mesh_dim_names, t.placements)]
    if list(t.placements) != pl:
        t = t.redistribute(mesh, pl)
    return DTensor.from_local(
        t.to_local(grad_placements=pl), sub,
        [p for n, p in zip(mesh.mesh_dim_names, pl) if n in keep],
        run_check=False, shape=t.shape, stride=t.stride())


def lift(t: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """A DTensor on a sub-mesh of ``mesh`` (``onto``) as a DTensor on
    ``mesh``, replicated over the dims the sub-mesh lacks; no gradient
    flows back through it."""
    if not isinstance(t, DTensor):
        return t
    own = dict(zip(t.device_mesh.mesh_dim_names, t.placements))
    return DTensor.from_local(
        t.to_local(), mesh, [own.get(n, Replicate())
                             for n in mesh.mesh_dim_names],
        run_check=False, shape=t.shape, stride=t.stride())


# ----------------------------------------------------------- abstract values
def abstract_mode():
    """The active ``FakeTensorMode``, or a new one: tensors made in the
    block are fake (shapes, dtypes and devices, no storage), all of one
    mode -- the dry run's, when it makes its inputs inside its own."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    active = torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE)
    return contextlib.nullcontext(active) if active else FakeTensorMode()
