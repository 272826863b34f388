"""Rows decoded per batched decode step in the window, all nodes: the
window's change of ``EngineStats.decode_tokens`` over that of
``decode_steps``; none without a decode step."""

UNIT = "rows"
MOVES = "output_tokens_per_s"


def read(rec):
    c = rec["counters"]
    if c["decode_steps"] <= 0:
        return None
    return c["decode_tokens"] / c["decode_steps"]
