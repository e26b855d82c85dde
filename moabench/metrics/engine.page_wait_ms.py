"""Mean wait of an admitted request for free pages of its engine's KV
pool: over the rows of the window's ``engine.prefill_group`` spans (both
tiers), the wall of the program's ``engine.page_wait`` span of that row's
request on that tier, 0 for a row that never waited, in ms. A program
whose groups carry no ``kv_pages`` (one that records no page waits) gives
nothing. Layer: serving/engine.py admission."""
from moabench.program_spans import _records, mean_ms, spans


def read(run):
    groups = spans(run, "engine.prefill_group")
    if not any("kv_pages" in s.attrs for s in groups):
        return None
    waited = {(s.tier, s.rid): (s.t1_ns - s.t0_ns) / 1e9
              for s in _records() if s.name == "engine.page_wait"}
    return mean_ms([waited.get((s.tier, row[0]), 0.0)
                    for s in groups for row in s.attrs["rows"]])
