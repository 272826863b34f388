"""The yardstick's arithmetic: the card's published peaks and the least
time of a kernel launch from its shapes (a model's FLOPs are its family's,
``families/<family>``).

Frozen copies of the serving smoke script's arithmetic (``bound`` and the
byte and operation counts of its row 1 and row 2 cases), so that no change
to the program can move the yardstick.  Nothing here imports the
program.
"""

from __future__ import annotations

from typing import Dict, Sequence

# NVIDIA H100 SXM data sheet: HBM3 bandwidth and the dense bf16 tensor rate
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
BF16_BYTES = 2


def bound_s(nbytes: float, flops: float, dtype: str = "bfloat16") -> float:
    """The least seconds a launch can take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    return max(nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[dtype])


def flash_attention_cost(b: int, s_q: int, s_kv: int, h: int, hkv: int,
                         d: int, causal: bool = True,
                         elem: int = BF16_BYTES) -> Dict[str, float]:
    """Row 1 (prefill attention) over q (b, s_q, h, d) and k/v (b, s_kv,
    hkv, d): QK and PV over the visible pairs (the causal triangle, query i
    seeing keys <= i + s_kv - s_q), and q, k, v read once and the output
    written once."""
    if causal:
        off = s_kv - s_q
        vis = sum(min(s_kv, i + off + 1) for i in range(s_q)) \
            if off else s_q * (s_q + 1) // 2
    else:
        vis = s_q * s_kv
    flops = 4.0 * b * h * d * vis
    nbytes = (2 * b * s_q * h * d + 2 * b * s_kv * hkv * d) * elem
    return {"flops": flops, "bytes": float(nbytes)}


def paged_decode_cost(lengths: Sequence[int], maxp: int, page: int, h: int,
                      hkv: int, d: int,
                      elem: int = BF16_BYTES) -> Dict[str, float]:
    """Row 2 (paged decode) over one query per row: a live row reads its K
    and V up to its length (at most the table's ``maxp * page``) and does QK
    and PV on them, a length-0 row averages V over its whole table; q read
    and the output written once; each row's table entries and length."""
    cap = maxp * page
    k_pos = sum(min(n, cap) for n in lengths if n > 0)
    v_pos = k_pos + cap * sum(1 for n in lengths if n <= 0)
    entries = sum(-(-(min(n, cap) if n > 0 else cap) // page)
                  for n in lengths)
    b = len(lengths)
    nbytes = (2 * b * h * d * elem + (k_pos + v_pos) * hkv * d * elem
              + 4 * (entries + b))
    flops = 2.0 * h * d * (k_pos + v_pos)
    return {"flops": flops, "bytes": float(nbytes)}
