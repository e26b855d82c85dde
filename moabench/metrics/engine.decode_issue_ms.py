"""Host time the fused decode blocks spend issuing their launches (the
program's ``engine.decode.issue`` spans) over the decode steps of the
window's blocks, in ms. Layer: serving/engine.py fused decode."""
from moabench.program_spans import issue_ms_per_step


def read(run):
    return issue_ms_per_step(run)
