"""The decode steps' share of the card's peak: model FLOPs of the tokens
decoded in the window (every layer's matrices, attention over each row's
context, the head) over the window's change of
``EngineStats.decode_wall_s`` times the bf16 peak; none without a decode
step."""

UNIT = "%"
MOVES = "tpot_p95_ms"


def read(rec):
    wall = rec["counters"]["decode_wall_s"]
    flops = rec["model_flops"]["decode"]
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (wall * rec["peak_flops"])
