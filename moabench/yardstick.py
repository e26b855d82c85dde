"""The yardstick: the card's published peaks and the work each kernel and
each model step needs, computed from shapes alone.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity),
which assumes the card's full 700 W power limit; every run prints the
card's power limit beside them. Work is what the algorithm needs for the
inputs it was given: each input byte read once, each output byte written
once, no padding, no re-reads.
"""
from __future__ import annotations

from typing import Iterable, Tuple

PEAK_BF16_FLOPS = 989e12
PEAK_HBM_BYTES = 3.35e12
BF16 = 2
F32 = 4
#: floats an image's statistics launch writes: 4 sums, 256 bins, 5 scores
IMAGE_STATS_OUT = 4 + 256 + 5


def least_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the compute and
    the memory bound."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def flash_prefill(a, lengths: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one flash-attention call of a prefill group over
    all layers: each row causal over its own true length (patches + text),
    q/k/v read once and o written once, in bf16."""
    flops = nbytes = 0.0
    h, k, hd = a.heads, a.kv_heads, a.head_dim
    for s in lengths:
        flops += 4.0 * h * hd * s * (s + 1) / 2
        nbytes += BF16 * s * hd * (2 * h + 2 * k)
    return a.layers * flops, a.layers * nbytes


def decode_paged_step(a, contexts: Iterable[int]) -> Tuple[float, float]:
    """(FLOPs, bytes) of one paged decode-attention step over all layers:
    each live slot's K and V rows read once, q read and out written once."""
    flops = nbytes = 0.0
    h, k, hd = a.heads, a.kv_heads, a.head_dim
    for c in contexts:
        flops += 4.0 * h * hd * c
        nbytes += BF16 * (2 * c * k * hd + 2 * h * hd)
    return a.layers * flops, a.layers * nbytes


def image_stats(h: int, w: int) -> Tuple[float, float]:
    """(FLOPs, bytes) of scoring one image: its f32 pixels read once, its
    statistics and scores written once. The arithmetic (about 30 operations
    a pixel) never bounds it."""
    return 30.0 * h * w, F32 * (h * w + IMAGE_STATS_OUT)


def prefill_flops(a, s: int, with_image: bool) -> float:
    """Model FLOPs of prefilling one prompt of ``s`` rows (patches
    included): the layer stack on every row, causal attention, the patch
    projection, and the logits of the last row only."""
    f = 2.0 * a.linear_params * s + 4.0 * a.layers * a.heads * a.head_dim \
        * s * (s + 1) / 2 + 2.0 * a.vocab * a.d
    if with_image:
        f += 2.0 * a.frontend_dim * a.d * a.patches
    return f


def decode_flops(a, context: int) -> float:
    """Model FLOPs of one decoded token at ``context`` cached rows (its own
    included): the layer stack, attention over the context, the logits."""
    return (2.0 * a.linear_params + 4.0 * a.layers * a.heads * a.head_dim
            * context + 2.0 * a.vocab * a.d)


def percentile(values, q: float) -> float:
    """Nearest-rank percentile (``q`` in 0-100) of every value given, with
    ``inf`` for a request that never finished."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    i = max(0, min(len(xs) - 1, -(-int(round(q * len(xs))) // 100) - 1))
    return xs[i]
