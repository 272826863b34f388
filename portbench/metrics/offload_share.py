"""The share of the window's requests that the protocol offloaded from
their origin node to another (``core.Network``'s delegations, as the
replay ran them); none in a cell of one node."""

UNIT = "%"
MOVES = "ttft_p95_ms"


def read(rec):
    reqs = rec["requests"]
    if rec["nodes"] < 2 or not reqs:
        return None
    return 100.0 * sum(r["offloaded"] for r in reqs) / len(reqs)
