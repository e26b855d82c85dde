"""Model FLOPs of the traced window (every prefill row at its true length
and every live decoded token, both tiers; yardstick.py) over the traced
window times the H100's 989 TFLOP/s bf16 peak, in %. Layer:
models/transformer.py::DecoderLM, the whole step."""
from moabench.readers import mfu_pct


def read(run):
    return mfu_pct(run)
