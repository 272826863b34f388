"""Mesh builders: the H100 cluster of the dry run, and the host mesh.

Port of ``repro.launch.mesh``.  The production mesh is an H100 cluster,
not the reference's TPU pod: ``("data", "model") = (32, 8)``, 256 GPUs
with the model axis inside one 8-GPU NVLink node, or with ``multi_pod``
``("pod", "data", "model") = (2, 32, 8)``, 512 GPUs -- the reference's
device counts.  Both build on the current process group, which must hold
that many ranks (the dry run's fake one: ``meshenv.fake_process_group``).

The roofline's hardware constants are an H100 SXM's, from NVIDIA's H100
datasheet (dense rates, 700 W): 989 TFLOP/s bf16, 3.35 TB/s of HBM3, and
NVLink 4 at 900 GB/s per GPU in both directions together, 450 GB/s each
way.  The dry run prices every collective at the NVLink rate (one term,
as the reference's single link rate); collectives over the data axis
cross nodes, where InfiniBand gives about 50 GB/s per GPU -- an open
question of the roofline, not a second term of it.
"""

from __future__ import annotations

from repro_torch.compat import meshenv

_PEAK_FLOPS_BF16 = 989e12     # FLOP/s, dense
_HBM_BW = 3.35e12             # bytes/s
_NVLINK_BW = 450e9            # bytes/s per direction per GPU


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """32 x 8 = 256 GPUs; 2 x 32 x 8 = 512 with ``multi_pod``."""
    shape = (2, 32, 8) if multi_pod else (32, 8)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return meshenv.make_mesh(shape, axes, device_type)


def make_host_mesh(device_type: str = "cuda"):
    """A (1, 1) ``("data", "model")`` mesh on the caller's device: the
    card by default, ``"cpu"`` for a gloo group."""
    return meshenv.make_mesh((1, 1), ("data", "model"), device_type)
