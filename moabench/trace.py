"""The device trace of a ``--trace 1`` run: ``torch.profiler`` recording
the card's activity (kernels, copies, sets) over the measured window, read
straight from the profiler's raw events.

What it gives the per-layer readers: the device time of every kernel by
name, the busy time (the union of all device intervals), the traced
window's length, and the idle gaps between device intervals, each named by
the innermost host span of the harness that was open at its middle.
"""
from __future__ import annotations

import time
from typing import Dict, List, Sequence, Tuple

import numpy as np


class DeviceTrace:
    """Start with :meth:`start`, stop with :meth:`stop` (host monotonic
    times ``t0``/``t1``); then :meth:`read` once."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = 0.0
        # kineto stamps events on the wall clock in ns; spans use the
        # monotonic clock
        self.offset_ns = time.time_ns() - time.monotonic_ns()
        self.kernels: Dict[str, Tuple[float, int]] = {}
        self.intervals = np.zeros((0, 2))

    def start(self) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.monotonic()

    def stop(self) -> None:
        import torch

        torch.cuda.synchronize()
        self.t1 = time.monotonic()
        self.prof.__exit__(None, None, None)

    @property
    def window_s(self) -> float:
        return self.t1 - self.t0

    def read(self) -> None:
        """Collect every device event inside the window."""
        from torch.autograd import DeviceType

        lo = self.t0 * 1e9 + self.offset_ns
        hi = self.t1 * 1e9 + self.offset_ns
        starts, ends = [], []
        kern: Dict[str, List[float]] = {}
        for ev in self.prof.profiler.kineto_results.events():
            if ev.device_type() != DeviceType.CUDA:
                continue
            s = float(ev.start_ns())
            e = s + float(ev.duration_ns())
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            starts.append(s)
            ends.append(e)
            acc = kern.setdefault(ev.name(), [0.0, 0])
            acc[0] += (e - s) / 1e9
            acc[1] += 1
        self.kernels = {k: (v[0], v[1]) for k, v in kern.items()}
        iv = np.stack([np.asarray(starts), np.asarray(ends)], 1) \
            if starts else np.zeros((0, 2))
        iv = iv[np.argsort(iv[:, 0])] if len(iv) else iv
        self.intervals = _union(iv)
        self.prof = None  # the raw events are no longer needed

    @property
    def busy_s(self) -> float:
        iv = self.intervals
        return float((iv[:, 1] - iv[:, 0]).sum() / 1e9) if len(iv) else 0.0

    def kernel_s(self, match) -> float:
        """Device seconds of the kernels whose name ``match`` accepts."""
        return sum(t for name, (t, _) in self.kernels.items() if match(name))

    def top_ops(self, n: int = 10) -> List[Tuple[str, float]]:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][0])[:n]
        return [[name[:120], t] for name, (t, _) in ops]

    def idle_gaps(self, spans: Sequence[Tuple[str, float, float]],
                  n: int = 10) -> List[Tuple[str, float]]:
        """The ``n`` longest idle stretches of the window, each named by
        the innermost harness span (name, t0, t1 on the monotonic clock)
        that covers its middle, or the runtime's outside every span."""
        iv = self.intervals
        lo = self.t0 * 1e9 + self.offset_ns
        hi = self.t1 * 1e9 + self.offset_ns
        edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
        gaps = edges[:, 1] - edges[:, 0]
        out = []
        for i in np.argsort(-gaps)[:n]:
            if gaps[i] <= 0:
                break
            mid = ((edges[i, 0] + edges[i, 1]) / 2 - self.offset_ns) / 1e9
            name, best = "runtime, outside the engines", None
            for sname, s0, s1 in spans:
                if s0 <= mid <= s1 and (best is None or s1 - s0 < best):
                    name, best = sname, s1 - s0
            out.append([name, float(gaps[i] / 1e9)])
        return out


def _union(iv: np.ndarray) -> np.ndarray:
    """Merge sorted intervals."""
    if len(iv) == 0:
        return iv
    reach = np.maximum.accumulate(iv[:, 1])
    first = np.flatnonzero(np.r_[True, iv[1:, 0] > reach[:-1]])
    return np.stack([iv[first, 0], np.maximum.reduceat(iv[:, 1], first)], 1)

