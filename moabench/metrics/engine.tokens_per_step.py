"""Tokens the cloud tier streamed per engine step (one fused block of up
to ``fused_steps`` decode steps) over the window:
``decode_tokens / steps``. Layer: serving/engine.py batching."""
from moabench.readers import counter_delta


def read(run):
    steps = counter_delta(run, f"{run.remote}.steps")
    return (counter_delta(run, f"{run.remote}.decode_tokens") / steps
            if steps else None)
