"""95th percentile of time to first token over every request that arrived
in the window (from when it was due to its first streamed token); a
request that never finished counts as missing it."""
from moabench.readers import tail_ms


def read(run):
    return tail_ms(run, "ttft")
