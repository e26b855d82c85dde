"""Mean wait of the window's arrivals for the event loop: the start of the
program's ``runtime.event`` span that handled an arrival minus the time it
was due, in ms. Layer: serving/runtime.py lifecycle."""
from moabench.program_spans import arrival_waits, mean_ms


def read(run):
    return mean_ms(list(arrival_waits(run).values()))
