"""Arithmetic the metric readers (``metrics/*.py``) share: each reader is a
file of its own that names what it reads and calls one of these."""
from __future__ import annotations

from typing import Callable, Optional

from moabench import yardstick as ys


def tail_ms(run, key: str, q: float = 95.0) -> Optional[float]:
    """Percentile ``q`` of one per-request time over every request of the
    window, a request that never finished counting as infinite. A tail
    that lands on an unfinished request reads as the longest wait any
    request of the window saw (a lower bound)."""
    vals = [r[key] for r in run.requests]
    if not vals:
        return None
    v = ys.percentile(vals, q)
    if v == float("inf"):
        v = max(run.drain_end - r["due"] for r in run.requests)
    return 1e3 * v


def tokens_per_s(run) -> Optional[float]:
    """Every token streamed inside the window over the window's length."""
    n = sum(1 for t in run.token_t if run.t0 <= t <= run.t1)
    return n / (run.t1 - run.t0) if run.t1 > run.t0 else None


def counter_delta(run, name: str) -> float:
    return run.c1[name] - run.c0[name]


def in_window(run, t0: float) -> bool:
    return run.t0 <= t0 <= run.t1


def decode_step_ms(run) -> Optional[float]:
    """Wall of the engines' fused decode blocks (each ends in a host copy
    of its tokens), over the decode steps they ran."""
    wall = steps = 0.0
    for tier, t0, t1, pos, bud, k in run.probe.blocks:
        if in_window(run, t0) and k:
            wall += t1 - t0
            steps += k
    return 1e3 * wall / steps if steps else None


def model_flops(run) -> float:
    """Model FLOPs of the prefill groups and decode steps the window ran:
    true lengths only, no padding, no dead slot."""
    f = 0.0
    for tier, t0, t1, rows in run.probe.groups:
        if in_window(run, t0):
            a = run.archs[tier]
            for n, img in rows:
                s = n + (a.patches if img else 0)
                f += ys.prefill_flops(a, s, img)
    for tier, t0, t1, pos, bud, k in run.probe.blocks:
        if in_window(run, t0):
            a = run.archs[tier]
            for p, b in zip(pos, bud):
                for j in range(min(int(b), k)):
                    f += ys.decode_flops(a, int(p) + j + 1)
    return f


def mfu_pct(run) -> Optional[float]:
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * model_flops(run) / (run.trace.window_s
                                       * ys.PEAK_BF16_FLOPS)


def idle_pct(run) -> Optional[float]:
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def roofline_pct(run, match: Callable[[str], bool],
                 least_s: float) -> Optional[float]:
    """Least time of the work over the device time of the kernels ``match``
    accepts, in the traced window; nothing when they did not run."""
    if run.trace is None:
        return None
    t = run.trace.kernel_s(match)
    if t <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / t


def flash_least_s(run) -> float:
    total = 0.0
    for tier, t0, t1, rows in run.probe.groups:
        if in_window(run, t0):
            a = run.archs[tier]
            lengths = [n + (a.patches if img else 0) for n, img in rows]
            total += ys.least_s(*ys.flash_prefill(a, lengths))
    return total


def decode_least_s(run) -> float:
    total = 0.0
    for tier, t0, t1, pos, bud, k in run.probe.blocks:
        if in_window(run, t0):
            a = run.archs[tier]
            for j in range(k):
                ctx = [int(p) + j + 1 for p, b in zip(pos, bud) if j < b]
                if ctx:
                    total += ys.least_s(*ys.decode_paged_step(a, ctx))
    return total


def image_least_s(run) -> float:
    total = 0.0
    for rid, t0, t1, late, hw in run.probe.scores:
        if hw is not None and in_window(run, t0):
            total += ys.least_s(*ys.image_stats(*hw))
    return total
