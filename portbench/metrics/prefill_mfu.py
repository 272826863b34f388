"""The prefills' share of the card's peak: model FLOPs of the prompts
prefilled in the window (counted by the benchmark from the configuration
and each prompt's length) over the window's change of
``EngineStats.prefill_wall_s`` times the bf16 peak; none without a
prefill."""

UNIT = "%"
MOVES = "ttft_p95_ms"


def read(rec):
    wall = rec["counters"]["prefill_wall_s"]
    flops = rec["model_flops"]["prefill"]
    if wall <= 0 or flops <= 0:
        return None
    return 100.0 * flops / (wall * rec["peak_flops"])
