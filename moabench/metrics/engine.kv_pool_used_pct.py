"""Mean share of the remote tier's paged KV pool in use as its fused decode
blocks start: ``pages_used / pool_pages`` of the program's
``engine.decode_block`` spans of that tier in the window, in %. A program
whose blocks carry no pool attributes gives nothing. Layer:
serving/engine.py fused decode (over serving/paged.py)."""
from moabench.program_spans import spans


def read(run):
    used = [s.attrs["pages_used"] / s.attrs["pool_pages"]
            for s in spans(run, "engine.decode_block")
            if s.tier == run.remote and s.attrs.get("pool_pages")]
    return 100.0 * sum(used) / len(used) if used else None
