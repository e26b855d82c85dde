"""Mean wall of one prefill group (a harness span around the engine's
``_admit_group``, which ends in a host sync on the first tokens) in the
window, in ms. Layer: serving/engine.py admission."""
from moabench.readers import in_window


def read(run):
    w = [t1 - t0 for tier, t0, t1, rows in run.probe.groups
         if in_window(run, t0)]
    return 1e3 * sum(w) / len(w) if w else None
