"""Mean wait of a request in an engine's queue: the start of the program's
``engine.prefill_group`` span that admitted it minus when the engine was
given it, over the rows of the window's groups on both tiers, in ms.
Layer: serving/engine.py admission."""
from moabench.program_spans import mean_ms, queue_waits


def read(run):
    return mean_ms(queue_waits(run))
