"""The program's own spans (``repro_torch.tracing``) against what the
harness's probe records around the same calls, the readers of the spans,
and, on the card, the clock the spans share with the device trace."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from moabench import program_spans, run, serve, spec, testing

SEED = 2 ** 31 + 4242
BENCH = spec.benchmark()
NEW = ("runtime.arrival_wait_ms", "engine.queue_wait_ms",
       "engine.prefill_device_busy_pct", "engine.decode_issue_ms",
       "engine.decode_device_busy_pct")


@pytest.fixture
def tracer():
    from repro_torch import tracing

    tracing.disable()
    tracing.clear()
    yield tracing
    tracing.disable()
    tracing.clear()


def test_program_spans_match_the_probe(tracer, monkeypatch):
    """A traced run on the CPU with the tracer switched on before the
    window: every prefill group and fused decode block the probe wrapped
    has one program span inside the probe's, with the same tier, rows,
    live slots and steps; an arrival's wait for the loop is at most, and
    close to, the lateness with which the probe saw it scored."""
    import torch

    probes = []

    class Kept(serve.Probe):
        def __init__(self):
            super().__init__()
            probes.append(self)
    monkeypatch.setattr(serve, "Probe", Kept)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = run.run_cell(
            "qwen-vqa-poisson", SEED, 2.0, True, device="cpu", rate=6.0,
            cfg_override=testing.small_config("qwen-vqa-poisson"),
            params_override=testing.SMALL_TRAFFIC, log=lambda s: None,
            before_window=lambda built: tracer.enable())
    finally:
        torch.set_num_threads(n)
        tracer.disable()
    assert res["correct"], res["checks"]
    (probe,) = probes
    spans = tracer.records()
    assert tracer.dropped == 0

    groups = sorted((s for s in spans if s.name == "engine.prefill_group"),
                    key=lambda s: s.t0_ns)
    assert len(groups) == len(probe.groups) > 0
    for s, (tier, t0, t1, rows) in zip(groups, sorted(probe.groups,
                                                      key=lambda g: g[1])):
        assert s.tier == tier
        assert [(n, img) for _, n, img, _ in s.attrs["rows"]] == rows
        assert t0 <= s.t0_ns / 1e9 and s.t1_ns / 1e9 <= t1
        assert s.attrs["rows_padded"] >= len(rows)
        assert all(got <= s.t0_ns / 1e9 for *_, got in s.attrs["rows"])
    blocks = sorted((s for s in spans if s.name == "engine.decode_block"),
                    key=lambda s: s.t0_ns)
    assert len(blocks) == len(probe.blocks) > 0
    for s, (tier, t0, t1, pos, bud, k) in zip(blocks, sorted(
            probe.blocks, key=lambda b: b[1])):
        assert s.tier == tier and s.attrs["k"] == k
        assert [p for _, p, _ in s.attrs["slots"]] == list(pos)
        assert [b for _, _, b in s.attrs["slots"]] == list(bud)
        assert t0 <= s.t0_ns / 1e9 and s.t1_ns / 1e9 <= t1
    by_id = {s.id: s for s in spans}
    for child, parent in (("engine.prefill.stage", "engine.prefill_group"),
                          ("engine.prefill.issue", "engine.prefill_group"),
                          ("engine.prefill.sync", "engine.prefill_group"),
                          ("engine.prefill.start", "engine.prefill_group"),
                          ("engine.decode.issue", "engine.decode_block"),
                          ("engine.decode.sync", "engine.decode_block")):
        kids = [s for s in spans if s.name == child]
        assert len(kids) == sum(s.name == parent for s in spans), child
        assert all(by_id[s.parent].name == parent for s in kids), child

    late = {rid: lateness for rid, _, _, lateness, _ in probe.scores}
    waits = {s.rid: s.t0_ns / 1e9 - s.attrs["due"] for s in spans
             if s.name == "runtime.event" and s.attrs["kind"] == "arrival"}
    assert waits
    for rid, w in waits.items():
        assert 0 <= w <= late[rid] < w + 0.01, (rid, w, late[rid])
    m = res["metrics"]
    for name in ("runtime.arrival_wait_ms", "engine.queue_wait_ms",
                 "engine.decode_issue_ms"):
        assert name in m and m[name]["value"] >= 0, name
    # the device's share needs the device trace, which only the card has
    assert "engine.prefill_device_busy_pct" not in m
    assert "engine.decode_device_busy_pct" not in m


def test_readers_read_nothing_without_spans(tracer):
    """Tracer off (a CPU run, or a program without the tracer): every new
    reader returns nothing rather than raising."""
    t1 = time.monotonic()
    r = SimpleNamespace(t0=0.0, t1=t1, requests=[], trace=SimpleNamespace(
        t0=0.0, t1=t1, offset_ns=0, intervals=np.zeros((0, 2))))
    for name in NEW:
        assert spec.reader(name)(r) is None, name
    assert program_spans.idle_by_span(r) is None
    assert program_spans.idle_gaps(r) is None


def test_new_metrics_are_declared_for_the_cell():
    names = [m["name"] for m in spec.metrics_for(BENCH, "qwen-vqa-poisson",
                                                 True)]
    assert names[-len(NEW):] == list(NEW)


def test_busy_between_against_hand_counts():
    iv = np.array([[10.0, 20.0], [30.0, 35.0], [50.0, 60.0]])
    a = np.array([0.0, 15.0, 20.0, 32.0, 0.0, 55.0, 70.0])
    b = np.array([5.0, 33.0, 30.0, 33.0, 100.0, 58.0, 80.0])
    want = [0.0, 5.0 + 3.0, 0.0, 1.0, 25.0, 3.0, 0.0]
    assert program_spans.busy_between(iv, a, b).tolist() == want
    assert program_spans.busy_between(np.zeros((0, 2)), a, b).tolist() == [
        0.0] * len(a)


def test_device_busy_readers_on_a_synthetic_run(tracer):
    """Known spans and device intervals, the trace's offset fixed: the
    prefill group [0, 10] ms holds 4 ms of device time, the two decode
    blocks [20, 30] and [40, 50] ms hold 9 ms and 10 ms (one interval
    straddles a block's start)."""
    ms = 1_000_000
    base = time.monotonic_ns()
    off = 10 ** 18
    S = tracer.Span
    tracer._spans.extend([
        S("engine.prefill_group", base, base + 10 * ms, 1, 0, None, "edge",
          {"rows": [(1, 5, True, (base - 3 * ms) / 1e9)],
           "bucket": 16, "rows_padded": 1}),
        S("engine.decode_block", base + 20 * ms, base + 30 * ms, 2, 0, None,
          "edge", {"k": 2, "teff": 32, "slots": [(1, 21, 4)]}),
        S("engine.decode.issue", base + 20 * ms, base + 26 * ms, 3, 2, None,
          "edge", {}),
        S("engine.decode_block", base + 40 * ms, base + 50 * ms, 4, 0, None,
          "cloud", {"k": 4, "teff": 32, "slots": [(2, 9, 8)]}),
        S("engine.decode.issue", base + 40 * ms, base + 42 * ms, 5, 4, None,
          "cloud", {}),
    ])
    iv = np.array([[2, 4], [6, 8], [19, 28.5], [29.5, 30], [40, 50]],
                  np.float64) * ms + base + off
    r = SimpleNamespace(t0=base / 1e9 - 1.0, t1=base / 1e9 + 1.0,
                        requests=[], trace=SimpleNamespace(intervals=iv,
                                                           offset_ns=off))
    read = {n: spec.reader(n)(r) for n in NEW}
    # float64 holds the profiler's absolute ns to 256 ns
    assert read["engine.prefill_device_busy_pct"] == pytest.approx(
        40.0, rel=1e-4)
    assert read["engine.decode_device_busy_pct"] == pytest.approx(
        100.0 * (9 + 10) / 20, rel=1e-4)
    assert read["engine.decode_issue_ms"] == pytest.approx((6 + 2) / 6)
    assert read["engine.queue_wait_ms"] == pytest.approx(3.0)
    assert read["runtime.arrival_wait_ms"] is None  # no arrival span


def _idle_run(tracer, spans, iv, t0, t1, off=10 ** 18):
    ms = 1_000_000
    tracer._spans.extend(
        tracer.Span(name, a * ms, b * ms, i + 1, 0, None, None, {})
        for i, (name, a, b) in enumerate(spans))
    tr = SimpleNamespace(t0=t0 / 1e3, t1=t1 / 1e3, offset_ns=off,
                         intervals=np.asarray(iv, np.float64) * ms + off)
    return SimpleNamespace(t0=t0 / 1e3, t1=t1 / 1e3, requests=[], trace=tr)


def test_innermost_span_timeline():
    """Nested spans (one thread): each instant is named by the innermost
    span open, and by nothing outside them all."""
    S = lambda name, a, b: SimpleNamespace(name=name, t0_ns=a, t1_ns=b)
    starts, names = program_spans.innermost([
        S("step", 10, 50), S("group", 10, 30), S("issue", 12, 20),
        S("emit", 40, 45), S("event", 60, 70)])
    out = program_spans.OUTSIDE
    assert starts.tolist() == [10, 10, 12, 20, 30, 40, 45, 50, 60, 70]
    assert names == ["step", "group", "issue", "group", "step", "emit",
                     "step", out, "event", out]


def test_idle_split_and_gaps_by_innermost_span(tracer):
    """A 100 ms window with the device busy [5, 15], [30, 35] and
    [70, 72] ms: its 83 ms of idle time split by the innermost program
    span, and its longest idle stretches named at their middles."""
    r = _idle_run(tracer, [("runtime.advance", 0, 60),
                           ("engine.step", 10, 50),
                           ("engine.decode_block", 12, 40),
                           ("engine.decode.sync", 36, 40),
                           ("runtime.event", 80, 90)],
                  [[5, 15], [30, 35], [70, 72]], 0, 100)
    idle = program_spans.idle_by_span(r)
    want = {"runtime.advance": 5 + 10, "engine.step": 0 + 10,
            "engine.decode_block": 24 - 3 - 5, "engine.decode.sync": 4,
            "runtime.event": 10, program_spans.OUTSIDE: 18 + 10}
    # float64 holds the profiler's absolute ns to 256 ns
    assert idle == pytest.approx({k: v / 1e3 for k, v in want.items()},
                                 abs=1e-6)
    assert sum(idle.values()) == pytest.approx(0.083, abs=1e-6)
    gaps = program_spans.idle_gaps(r, 3)
    assert [n for n, _ in gaps] == ["runtime.advance", "runtime.event",
                                    "engine.decode_block"]
    assert [g for _, g in gaps] == pytest.approx([0.035, 0.028, 0.015],
                                                 abs=1e-6)
    assert program_spans.idle_by_span(SimpleNamespace(trace=None)) is None


@pytest.mark.gpu
def test_spans_share_the_device_traces_clock(tracer):
    """Under the profiler the card records: a span opened around a ~10 ms
    sleep kernel and the sync after it holds the kernel's interval, mapped
    through the device trace's offset, within 100 us at either end; and
    the two device-busy readers read the device trace of such spans
    (a prefill group half host sleep, a decode block all device), and
    the window's idle time, split by span, adds up."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the profiler's device clock")
    from moabench.trace import DeviceTrace

    cycles = 20_000_000  # about 10 ms at the card's 1.7-2 GHz
    torch.cuda._sleep(cycles // 10)  # the context and the kernel, outside
    torch.cuda.synchronize()
    dt = DeviceTrace()
    dt.start()
    torch.cuda._sleep(cycles // 10)  # the profiler's first launch, outside
    torch.cuda.synchronize()
    assert tracer.on()
    sp = tracer.begin("engine.decode_block", tier="edge")
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    tracer.end(sp, k=1, teff=32, slots=[])
    pg = tracer.begin("engine.prefill_group", tier="edge")
    torch.cuda._sleep(cycles)
    torch.cuda.synchronize()
    time.sleep(0.01)
    tracer.end(pg, rows=[], bucket=16, rows_padded=1)
    dt.stop()
    dt.read()
    assert not tracer.on()
    off = dt.offset_ns
    spans = {s.name: s for s in tracer.records()}
    iv = dt.intervals
    assert len(iv) == 3, iv
    slack = 100_000
    for (k0, k1), name in zip(iv[1:], ("engine.decode_block",
                                       "engine.prefill_group")):
        s = spans[name]
        lo, hi = k0 - off, k1 - off
        print(f"{name}: kernel {(hi - lo) / 1e3:.1f} us, starts "
              f"{(lo - s.t0_ns) / 1e3:.1f} us after the span, ends "
              f"{(s.t1_ns - hi) / 1e3:.1f} us before its end")
        assert 5e6 < hi - lo < 50e6, (name, hi - lo)
        assert s.t0_ns - slack <= lo and hi <= s.t1_ns + slack, (
            name, lo - s.t0_ns, s.t1_ns - hi)
    r = SimpleNamespace(t0=dt.t0, t1=dt.t1, requests=[], trace=dt)
    dec = spec.reader("engine.decode_device_busy_pct")(r)
    pre = spec.reader("engine.prefill_device_busy_pct")(r)
    print(f"decode busy {dec:.2f}%, prefill busy {pre:.2f}%")
    assert 80.0 < dec <= 100.0, dec
    assert 25.0 < pre < 75.0, pre
    idle = program_spans.idle_by_span(r)
    print(f"idle by span: {idle}")
    assert sum(idle.values()) == pytest.approx(dt.window_s - dt.busy_s,
                                               abs=1e-5)
    # the host sleep inside the prefill group is its idle time
    assert 0.005 < idle["engine.prefill_group"] < 0.02, idle
