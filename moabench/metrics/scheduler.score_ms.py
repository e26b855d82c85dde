"""Mean time the scheduler spent scoring one request over the window
(``MoAOffScheduler.score_time_s / n_scored``, the program's own host clock
around a scorer that returns host floats), in ms. Layer: core/scheduler.py,
core/complexity.py."""
from moabench.readers import counter_delta


def read(run):
    n = counter_delta(run, "n_scored")
    return 1e3 * counter_delta(run, "score_time_s") / n if n else None
