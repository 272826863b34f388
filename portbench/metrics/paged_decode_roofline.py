"""Row 2's (paged decode over bf16 pages, ``kernels/paged_decode.py``, with
the merge of split rows) share of its roofline: the least time of every
launch in the profiled slices over the device time the profiler gave those
launches; none where no slice held a launch the profiler saw whole."""

from portbench.harness import roofline
from portbench.harness.trace import Kernel

UNIT = "%"
MOVES = "tpot_p95_ms"


def _note(a):
    _, _, h, d = a["q"].shape
    page, hkv = a["k_pool"].shape[1], a["k_pool"].shape[2]
    maxp = a["block_tables"].shape[1]
    lens = a["lengths"]            # read once the slice has closed
    return lambda: roofline.paged_decode_cost(lens.tolist(), maxp, page, h,
                                              hkv, d)


def _row2(name):
    return ("decode_mma_kernel" in name and "ContiguousKv" not in name
            and "DecodeInt8" not in name)


KERNEL = Kernel(entry="paged_decode_cuda", symbol=_row2, note=_note,
                aux_symbol=lambda name: "decode_combine_kernel" in name,
                aux_launches=lambda entry: int(entry.last_splits > 1))


def read(rec):
    k = rec.get("kernel")
    if not k or k["device_s"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["device_s"]
