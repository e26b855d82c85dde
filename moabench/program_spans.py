"""Arithmetic the readers of the program's own spans share
(``repro_torch.tracing``: the tracer records while the traced window's
profiler is open), and the device's idle time named by those spans. A
program without the tracer, or a run in which it recorded nothing, gives
every reader nothing to read, and the reader returns ``None``.

Span names and attributes are the tracer's (its module docstring): times
of a span are ``time.monotonic_ns()``, times in attributes
``time.monotonic()`` seconds, the clock of the harness's window. A span
meets the device trace through the trace's own ``offset_ns``, the offset
its intervals were clipped and mapped with.

Run as a module, it makes one run of a cell and prints what the spans
read in it, one JSON line::

    python3 -m moabench.program_spans --workload qwen-vqa-poisson \\
        --seed 12345 --seconds 51 --trace 1

``readings`` holds the metrics that read program spans; ``spans`` the
count and wall seconds of each span name in the window; with ``--trace
1`` (the profiler on, as in the benchmark's traced runs) ``idle_by_span``
splits the device's idle seconds of the window by the innermost span open
at each instant and ``idle_gaps`` names the longest idle stretches. With
``--trace 0`` the profiler stays off and the tracer is switched on for
the window: the host-side readings without the profiler's own cost.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

#: the name of device idle time that no program span covers
OUTSIDE = "outside the program's spans"
#: the metrics that read program spans
METRICS = ("runtime.arrival_wait_ms", "engine.queue_wait_ms",
           "engine.prefill_device_busy_pct", "engine.decode_issue_ms",
           "engine.decode_device_busy_pct")


def _records() -> List:
    try:
        from repro_torch import tracing
    except ImportError:
        return []
    return tracing.records()


def spans(run, name: str) -> List:
    """The program's spans named ``name`` that began inside the window;
    none where the program has no tracer."""
    lo, hi = run.t0 * 1e9, run.t1 * 1e9
    return [s for s in _records() if s.name == name and lo <= s.t0_ns <= hi]


def mean_ms(values: List[float]) -> Optional[float]:
    return 1e3 * sum(values) / len(values) if values else None


def arrival_waits(run) -> Dict[int, float]:
    """rid -> seconds between an arrival's due time and the start of the
    event loop's handling of it, for the window's requests."""
    rids = {r["rid"] for r in run.requests}
    return {s.rid: s.t0_ns / 1e9 - s.attrs["due"]
            for s in spans(run, "runtime.event")
            if s.attrs.get("kind") == "arrival" and s.rid in rids}


def queue_waits(run) -> List[float]:
    """Seconds between an engine receiving a request and the start of the
    prefill group that admitted it, one a row of the window's groups."""
    return [s.t0_ns / 1e9 - row[3]
            for s in spans(run, "engine.prefill_group")
            for row in s.attrs["rows"]]


def issue_ms_per_step(run) -> Optional[float]:
    """Host time from a fused block's entry to its last launch, over the
    decode steps of the window's blocks."""
    blocks = {s.id: s for s in spans(run, "engine.decode_block")}
    wall = steps = 0
    for s in spans(run, "engine.decode.issue"):
        b = blocks.get(s.parent)
        if b is not None:
            wall += s.t1_ns - s.t0_ns
            steps += b.attrs["k"]
    return wall / 1e6 / steps if steps else None


def device_busy_pct(run, name: str) -> Optional[float]:
    """Device-busy time inside the spans named ``name`` over their total
    wall, in %: the device trace's intervals (the profiler's clock) met
    with the spans through the trace's offset."""
    if run.trace is None:
        return None
    ss = spans(run, name)
    if not ss:
        return None
    off = run.trace.offset_ns
    a = np.array([s.t0_ns + off for s in ss], np.float64)
    b = np.array([s.t1_ns + off for s in ss], np.float64)
    wall = float((b - a).sum())
    if wall <= 0:
        return None
    busy = busy_between(run.trace.intervals, a, b)
    return 100.0 * float(busy.sum()) / wall


def busy_between(iv: np.ndarray, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Covered length of each ``[a[i], b[i]]`` by the sorted, disjoint
    intervals ``iv`` (N, 2)."""
    if len(iv) == 0:
        return np.zeros(len(a))
    starts, ends = iv[:, 0], iv[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(ends - starts)])

    def upto(x):
        # the intervals begun by x: all whole but the last, which is cut
        i = np.searchsorted(starts, x, side="right")
        j = np.maximum(i - 1, 0)
        part = np.clip(x - starts[j], 0.0, ends[j] - starts[j])
        return np.where(i > 0, cum[j] + part, 0.0)
    return upto(b) - upto(a)


def innermost(ss) -> Tuple[np.ndarray, List[str]]:
    """``(starts, names)``: from ``starts[i]`` (monotonic ns, in order) to
    the next start, ``names[i]`` is the innermost of the spans ``ss`` open
    (:data:`OUTSIDE` for none). The spans nest: one thread opens them."""
    starts: List[int] = []
    names: List[str] = []
    stack: List = []

    def close_to(t):
        while stack and stack[-1].t1_ns <= t:
            top = stack.pop()
            starts.append(top.t1_ns)
            names.append(stack[-1].name if stack else OUTSIDE)
    for s in sorted(ss, key=lambda s: (s.t0_ns, -s.t1_ns)):
        close_to(s.t0_ns)
        stack.append(s)
        starts.append(s.t0_ns)
        names.append(s.name)
    close_to(float("inf"))
    return np.asarray(starts, np.int64), names


def _window(run):
    """The traced window's innermost timeline (segment edges in monotonic
    ns, clipped to the window, and a name a segment) and the trace's
    offset; None without a device trace or spans."""
    tr = run.trace
    if tr is None:
        return None
    lo, hi = int(tr.t0 * 1e9), int(tr.t1 * 1e9)
    ss = [s for s in _records() if s.t1_ns >= lo and s.t0_ns <= hi]
    if not ss:
        return None
    starts, names = innermost(ss)
    edges = np.clip(np.concatenate([[lo], starts, [hi]]), lo, hi)
    return edges, [OUTSIDE] + names, tr.offset_ns


def idle_by_span(run) -> Optional[Dict[str, float]]:
    """The device's idle seconds in the window, split by the innermost
    program span open at each instant; they add up to the window's idle
    time."""
    w = _window(run)
    if w is None:
        return None
    edges, names, off = w
    a = (edges[:-1] + off).astype(np.float64)
    b = (edges[1:] + off).astype(np.float64)
    idle = (b - a) - busy_between(run.trace.intervals, a, b)
    out: Dict[str, float] = {}
    for name, x in zip(names, idle):
        if x > 0:
            out[name] = out.get(name, 0.0) + float(x) / 1e9
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def idle_gaps(run, n: int = 10) -> Optional[List[Tuple[str, float]]]:
    """The ``n`` longest idle stretches of the device in the window (in
    seconds), each named by the innermost program span open at its
    middle."""
    w = _window(run)
    if w is None:
        return None
    edges, names, off = w
    lo, hi = edges[0] + off, edges[-1] + off
    iv = run.trace.intervals
    gap_edges = np.concatenate([[lo], iv.reshape(-1), [hi]]).reshape(-1, 2)
    gaps = gap_edges[:, 1] - gap_edges[:, 0]
    out = []
    for i in np.argsort(-gaps)[:n]:
        if gaps[i] <= 0:
            break
        mid = (gap_edges[i, 0] + gap_edges[i, 1]) / 2 - off
        j = int(np.searchsorted(edges, mid, side="right")) - 1
        out.append((names[min(max(j, 0), len(names) - 1)],
                    float(gaps[i] / 1e9)))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    from moabench import run as bench_run
    from moabench import spec

    bench_run._caches()
    from repro_torch import tracing

    kept = []

    class Kept(bench_run.Run):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            kept.append(self)
    base, bench_run.Run = bench_run.Run, Kept
    try:
        result = bench_run.run_cell(
            args.workload, args.seed, args.seconds, bool(args.trace),
            log=lambda s: print(s, flush=True),
            before_window=(None if args.trace
                           else lambda built: tracing.enable()))
    finally:
        bench_run.Run = base
        tracing.disable()
    (r,) = kept
    walls: Dict[str, List[float]] = {}
    lo, hi = r.t0 * 1e9, r.t1 * 1e9
    for s in tracing.records():
        if lo <= s.t0_ns <= hi:
            w = walls.setdefault(s.name, [0, 0.0])
            w[0] += 1
            w[1] += (s.t1_ns - s.t0_ns) / 1e9
    readings = {}
    for name in METRICS:
        v = spec.reader(name)(r)
        if v is not None:
            readings[name] = v
    print(json.dumps({
        "trace": args.trace, "window_s": r.t1 - r.t0,
        "correct": result["correct"], "readings": readings,
        "spans": walls, "dropped": tracing.dropped,
        "idle_by_span": idle_by_span(r), "idle_gaps": idle_gaps(r)}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
