"""Least time of the fused blocks' paged decode attention (each live
slot's K/V rows at each layer read once a step, q read and out written
once) over the device time of the decode kernels (split and combine) in
the traced window, in %. Layer: kernels/decode_attention.py."""
from moabench.readers import decode_least_s, roofline_pct


def read(run):
    return roofline_pct(
        run, lambda n: "decode_" in n and "_kernel" in n
        or "combine_kernel" in n, decode_least_s(run))
