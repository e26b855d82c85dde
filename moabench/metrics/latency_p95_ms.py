"""95th percentile of whole-request latency (from when it was due to its
last streamed token: WAN, queue, prefill and decode) over every request of
the window; a request that never finished counts as missing it."""
from moabench.readers import tail_ms


def read(run):
    return tail_ms(run, "latency")
