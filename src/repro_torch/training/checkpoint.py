"""Msgpack checkpoints of nested dicts of tensors, in the reference's format.

Port of ``repro.training.checkpoint``: ``{"step", "leaves": {"leaf_i":
{"dtype", "shape", "data"}}}``, leaf i being the i-th leaf in
``jax.tree.flatten``'s order (``training.tree``), its data the raw bytes
of the array in C order, so a checkpoint crosses between the two packages
both ways.  A bfloat16 leaf carries the dtype string ``"bfloat16"`` and
its bytes are 16-bit words viewed as ``torch.bfloat16`` (numpy has no
bfloat16 without ``ml_dtypes``).
"""

from __future__ import annotations

import os
from typing import Any, Tuple

import msgpack
import numpy as np
import torch

from repro_torch.training.tree import flatten, leaves


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


def _from_record(rec) -> torch.Tensor:
    name = rec["dtype"]
    raw = np.frombuffer(rec["data"], dtype=np.int16 if name == "bfloat16"
                        else np.dtype(name)).reshape(rec["shape"])
    t = torch.from_numpy(raw.copy())
    return t.view(torch.bfloat16) if name == "bfloat16" else t


def save(path: str, tree, step: int = 0) -> None:
    payload = {
        "step": step,
        "leaves": {f"leaf_{i}": {"dtype": _dtype_name(x),
                                 "shape": list(x.shape),
                                 "data": _to_bytes(x)}
                   for i, x in enumerate(leaves(tree))},
    }
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(msgpack.packb(payload, use_bin_type=True))
    os.replace(tmp, path)       # atomic


def restore(path: str, like) -> Tuple[Any, int]:
    """Restore into the structure of ``like`` (a nested dict of tensors),
    each leaf in the checkpoint's dtype on its ``like`` leaf's device."""
    with open(path, "rb") as f:
        payload = msgpack.unpackb(f.read(), raw=False)
    refs, build = flatten(like)
    out = []
    for i, ref in enumerate(refs):
        arr = _from_record(payload["leaves"][f"leaf_{i}"])
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"leaf {i}: checkpoint shape "
                             f"{tuple(arr.shape)} != expected "
                             f"{tuple(ref.shape)}")
        out.append(arr.to(ref.device))
    return build(out), payload["step"]
