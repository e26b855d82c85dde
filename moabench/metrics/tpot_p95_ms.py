"""95th percentile, over every request of the window, of the time per
output token after the first: (last token - first token) / (tokens - 1),
on the harness's stream clock; a request that never finished counts as
missing it."""
from moabench.readers import tail_ms


def read(run):
    return tail_ms(run, "tpot")
