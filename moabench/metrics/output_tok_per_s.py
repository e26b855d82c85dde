"""Every output token streamed inside the window (both tiers), over the
window's length, on the harness's stream clock."""
from moabench.readers import tokens_per_s


def read(run):
    return tokens_per_s(run)
