"""The port's span tracer (``repro_torch.tracing``): when it records, what
a span carries, its bounded buffer and window filter, and the spans of a
live run on the CPU."""
import time

import pytest

torch = pytest.importorskip("torch")

from repro_torch import tracing  # noqa: E402
from repro_torch.config import (PolicyConfig, ServingConfig,  # noqa: E402
                                get_topology)
from repro_torch.core.baselines import make_policy  # noqa: E402
from repro_torch.core.scheduler import MoAOffScheduler  # noqa: E402
from repro_torch.serving.tiers import (ClusterServer,  # noqa: E402
                                       build_cluster_engines)


@pytest.fixture(autouse=True)
def _fresh_tracer():
    tracing.disable()
    tracing.clear()
    yield
    tracing.disable()
    tracing.clear()


def test_off_by_default_records_nothing():
    assert not tracing.on()
    sp = tracing.begin("a", rid=1, tier="edge")
    assert sp == 0
    tracing.end(sp, x=1)
    assert tracing.records() == [] and tracing.dropped == 0


def test_on_inside_a_profiler_session_and_off_after():
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]):
        assert tracing.on()
        tracing.end(tracing.begin("inside"))
    assert not tracing.on()
    tracing.end(tracing.begin("after"))
    assert [s.name for s in tracing.records()] == ["inside"]


def test_enable_and_disable():
    tracing.enable()
    assert tracing.on()
    sp = tracing.begin("on")
    tracing.disable()
    assert not tracing.on()
    tracing.end(sp)  # begun while on: still recorded
    tracing.end(tracing.begin("off"))
    (s,) = tracing.records()
    assert s.name == "on" and s.t1_ns >= s.t0_ns


def test_parents_across_nesting_and_a_skipped_end():
    tracing.enable()
    outer = tracing.begin("outer")
    a = tracing.begin("a")
    a1 = tracing.begin("a1")
    tracing.end(a1)
    tracing.end(a)
    b = tracing.begin("b")
    tracing.begin("b1")  # never ended, as when an exception skips its end
    tracing.end(b)
    tracing.end(outer)
    after = tracing.begin("after")
    tracing.end(after)
    by = {s.name: s for s in tracing.records()}
    assert set(by) == {"outer", "a", "a1", "b", "after"}
    assert by["outer"].parent == 0 and by["after"].parent == 0
    assert by["a"].parent == by["b"].parent == outer
    assert by["a1"].parent == a
    assert by["outer"].t0_ns <= by["a"].t0_ns <= by["a1"].t0_ns
    assert by["a1"].t1_ns <= by["a"].t1_ns <= by["b"].t0_ns
    assert by["b"].t1_ns <= by["outer"].t1_ns
    assert len({s.id for s in tracing.records()}) == 5


def test_rid_tier_and_attributes_are_carried():
    tracing.enable()
    sp = tracing.begin("engine.step", rid=7, tier="cloud")
    tracing.end(sp, k=8)
    ev = tracing.begin("runtime.event")
    tracing.end(ev, rid=9, kind="arrival", due=1.5)
    s, e = tracing.records()
    assert (s.rid, s.tier, s.attrs) == (7, "cloud", {"k": 8})
    assert (e.rid, e.tier, e.attrs) == (9, None,
                                        {"kind": "arrival", "due": 1.5})


def test_bounded_buffer_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(tracing, "CAPACITY", 3)
    tracing.enable()
    for i in range(5):
        tracing.end(tracing.begin(f"s{i}"))
    assert [s.name for s in tracing.records()] == ["s0", "s1", "s2"]
    assert tracing.dropped == 2
    tracing.clear()
    assert tracing.records() == [] and tracing.dropped == 0


def test_records_filters_by_start_inside_the_window():
    tracing.enable()
    tracing.end(tracing.begin("before"))
    time.sleep(0.002)
    t0 = time.monotonic()
    spanning = tracing.begin("spanning")
    tracing.end(tracing.begin("inside"))
    t1 = time.monotonic()
    time.sleep(0.002)
    tracing.end(spanning)
    tracing.end(tracing.begin("later"))
    assert [s.name for s in tracing.records(t0, t1)] == ["inside",
                                                         "spanning"]
    assert [s.name for s in tracing.records(t0=t1)] == ["later"]
    assert [s.name for s in tracing.records(t1=t0)] == ["before"]
    assert len(tracing.records()) == 4


def _moa(topo):
    return MoAOffScheduler(policy=make_policy(
        "moa-off", PolicyConfig(adaptive_tau=False), topology=topo),
        use_kernel=False)


def test_live_run_spans_carry_their_tier_and_nest():
    """Three requests through the live server (reduced engines on the CPU)
    with the tracer on: each arrival has its ``runtime.event``; each
    prefill group and decode block carries the name of the tier that
    served its rows, as the server was given the engines; and the engine's
    spans nest inside the runtime's ``advance``."""
    topo = get_topology("edge-cloud")
    sv = ServingConfig(max_batch=2, max_seq=96)
    server = ClusterServer(build_cluster_engines(topo, sv, device="cpu"),
                           topology=topo, scheduler=_moa(topo))
    rids = []
    for i, (c, d) in enumerate(((0.05, 0.0), (0.95, 0.05), (0.3, 0.1))):
        req = server.build_request(f"describe scene {i} please now. " * 2,
                                   max_new=4, complexity={"text": c},
                                   delay_s=d)
        server.submit_request(req)
        rids.append(req.rid)
    tracing.enable()
    live = server.run(timeout_s=60.0)
    tracing.disable()
    assert len(live) == 3 and not any(r.failed for r in live)
    served = {r.rid: r.tier for r in live}
    spans = tracing.records()
    by_id = {s.id: s for s in spans}
    arrivals = [s for s in spans if s.name == "runtime.event"
                and s.attrs["kind"] == "arrival"]
    assert sorted(s.rid for s in arrivals) == sorted(rids)
    assert all(s.t0_ns / 1e9 >= s.attrs["due"] for s in arrivals)
    groups = [s for s in spans if s.name == "engine.prefill_group"]
    blocks = [s for s in spans if s.name == "engine.decode_block"]
    assert sorted(row[0] for s in groups for row in s.attrs["rows"]) == \
        sorted(rids)
    for s in groups:
        assert {served[row[0]] for row in s.attrs["rows"]} == {s.tier}
    for s in blocks:
        assert {served[rid] for rid, _, _ in s.attrs["slots"]} == {s.tier}
    assert {s.tier for s in groups + blocks} == set(served.values())
    for s in groups + blocks + [s for s in spans if s.name == "engine.emit"]:
        step = by_id[s.parent]
        assert step.name == "engine.step" and step.tier == s.tier
        assert by_id[step.parent].name == "runtime.advance"


class _Replay:
    """A CPU stand-in for one captured decode step."""

    def __init__(self, eng, ctx):
        self.eng, self.ctx = eng, ctx

    def replay(self):
        self.eng._static_step(self.ctx)


@pytest.mark.parametrize("graphs", [False, True])
def test_decode_block_span_carries_graph(monkeypatch, graphs):
    """``engine.decode_block`` carries ``graph``: false on an eager engine
    (the CPU), and on the graph path false for a block whose bucket met its
    eager first step or its capture, true once every step replayed (a
    stand-in replay on the CPU)."""
    import contextlib

    import numpy as np

    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.serving.engine import TierEngine

    model = build_model(reduced_config("qwen3-0.6b").replace(
        dtype="float32"), device="cpu")
    eng = TierEngine(model, model.init(0),
                     ServingConfig(max_batch=2, max_seq=64, fused_steps=4),
                     eos_id=-1)
    if graphs:
        def capture(ctx):
            eng.decode_graph_captures += 1
            return _Replay(eng, ctx), {}

        eng._graph_ok = True
        monkeypatch.setattr(eng, "_capture", capture)
        monkeypatch.setattr(eng, "_side_stream", contextlib.nullcontext)
    eng.submit(0, np.arange(4, 20, dtype=np.int32), max_new=13)
    tracing.enable()
    eng.run_until_drained()
    tracing.disable()
    blocks = [s for s in tracing.records() if s.name == "engine.decode_block"]
    assert [s.attrs["k"] for s in blocks] == [4, 4, 4]
    want = [False, True, True] if graphs else [False] * 3
    assert [s.attrs["graph"] for s in blocks] == want
    assert eng.decode_graph_steps == (11 if graphs else 0)
