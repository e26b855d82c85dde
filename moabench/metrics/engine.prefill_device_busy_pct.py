"""Device-busy time inside the program's ``engine.prefill_group`` spans
over their total wall, in the window, in %. Layer: serving/engine.py
admission."""
from moabench.program_spans import device_busy_pct


def read(run):
    return device_busy_pct(run, "engine.prefill_group")
