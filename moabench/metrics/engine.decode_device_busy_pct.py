"""Device-busy time inside the program's ``engine.decode_block`` spans over
their total wall, in the window, in %. Layer: serving/engine.py fused
decode."""
from moabench.program_spans import device_busy_pct


def read(run):
    return device_busy_pct(run, "engine.decode_block")
