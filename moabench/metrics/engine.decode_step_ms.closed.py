"""Wall of the engines' fused decode blocks (``_fused``, which ends in a
host copy of the tokens) over the decode steps they ran, in the window,
in ms. Layer: serving/engine.py fused decode."""
from moabench.readers import decode_step_ms


def read(run):
    return decode_step_ms(run)
