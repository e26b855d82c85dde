"""Least time of the prefills' flash attention (each prompt causal at its
true length, q/k/v read once, o written once) over the device time of the
flash kernels in the traced window, in %. Layer: kernels/flash_attention.py."""
from moabench.readers import flash_least_s, roofline_pct


def read(run):
    return roofline_pct(run, lambda n: "flash_" in n and "_kernel" in n,
                        flash_least_s(run))
