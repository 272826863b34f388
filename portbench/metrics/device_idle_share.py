"""The share of the profiled slices' time in which no operation ran on the
card; none without a slice."""

UNIT = "%"
MOVES = "output_tokens_per_s"


def read(rec):
    d = rec.get("device")
    if not d or d["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - d["busy_s"] / d["window_s"])
