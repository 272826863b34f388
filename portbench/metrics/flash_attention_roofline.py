"""Row 1's (prefill attention, ``kernels/flash_attention.py``) share of its
roofline: the least time of every launch in the profiled slices (from its
shapes) over the device time the profiler gave those launches; none where
no slice held a launch the profiler saw whole."""

from portbench.harness import roofline
from portbench.harness.trace import Kernel

UNIT = "%"
MOVES = "ttft_p95_ms"


def _note(a):
    b, sq, h, d = a["q"].shape
    skv, hkv = a["k"].shape[1], a["k"].shape[2]
    causal = a["causal"]
    return lambda: roofline.flash_attention_cost(b, sq, skv, h, hkv, d,
                                                 causal)


KERNEL = Kernel(entry="flash_attention_cuda",
                symbol=lambda name: "flash_wgmma_kernel" in name,
                note=_note)


def read(rec):
    k = rec.get("kernel")
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
