"""Share of the traced window in which nothing ran on the card:
1 - (union of device intervals) / window, in %. Layer: the device."""
from moabench.readers import idle_pct


def read(run):
    return idle_pct(run)
