"""Least time of scoring the window's images (f32 pixels read once,
statistics and scores written once) over the device time of the image
statistics kernel in the traced window, in %. Layer:
kernels/image_complexity.py."""
from moabench.readers import image_least_s, roofline_pct


def read(run):
    return roofline_pct(run, lambda n: "image_stats_kernel" in n,
                        image_least_s(run))
