"""Replica pools, chaos and audit through the port's live engines, and the
speculative lifecycle through its runtime, against the JAX package:

* process replicas (spawned workers on ``device="cpu"``) give the tokens
  of a local engine, a recurrent (hybrid) replica's included, a killed
  worker's rids are reported lost and its sibling serves them, and a
  speculated request behind process-only pools falls back to plain
  decode;
* drop/dup/reorder chaos on a replica's event stream leaves the tokens
  JAX's honest stream delivers (converted weights);
* a live byzantine storm routes and decodes as the JAX package's honest
  run and audits clean; a corrupted migration is detected and recovered
  through a re-prefill, in both packages;
* a ``SpecConfig`` request speculates with the same lifecycle in the
  port's simulator and its live server, and with the same routes, drafted
  and accepted counts as the JAX package's live server.

Five worker processes in all."""
import copy
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from conftest import make_twin_edge_server  # noqa: E402
from repro.config import ServingConfig as JServingConfig  # noqa: E402
from repro.config import SpecConfig as JSpecConfig  # noqa: E402
from repro.config import two_tier_topology as j_two_tier  # noqa: E402
from repro.core.baselines import make_policy as j_make_policy  # noqa: E402
from repro.config import PolicyConfig as JPolicyConfig  # noqa: E402
from repro.core.scheduler import MoAOffScheduler as JScheduler  # noqa: E402
from repro.models import build_model as j_build  # noqa: E402
from repro.serving.engine import TierEngine as JTierEngine  # noqa: E402
from repro.serving.faults import FaultEvent as JFaultEvent  # noqa: E402
from repro.serving.faults import FaultPlan as JFaultPlan  # noqa: E402
from repro.serving.tiers import ClusterServer as JClusterServer  # noqa: E402
from repro.serving.tiers import build_cluster_engines as j_engines  # noqa: E402
from repro.serving.transport import LocalTransport as JLocal  # noqa: E402
from repro_torch.config import (PolicyConfig, ServingConfig,  # noqa: E402
                                SimConfig, SpecConfig, get_topology,
                                two_tier_topology)
from repro_torch.configs import reduced_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.core.baselines import make_policy  # noqa: E402
from repro_torch.core.scheduler import MoAOffScheduler  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving.engine import TierEngine  # noqa: E402
from repro_torch.serving.faults import (FaultEvent, FaultPlan,  # noqa: E402
                                        WireChaos)
from repro_torch.serving.pool import EnginePool, build_engine_pools  # noqa: E402
from repro_torch.serving.simulator import ClusterSimulator  # noqa: E402
from repro_torch.serving.tiers import ClusterServer  # noqa: E402
from repro_torch.serving.transport import (LocalTransport,  # noqa: E402
                                           ProcessTransport, ReplicaSpec)


def _prompt(n, base=0):
    return ((np.arange(n) + base) % 300 + 4).astype(np.int32)


def _drain(pool, timeout_s=120.0):
    fins = []
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        f, active, lost = pool.poll()
        fins.extend(f)
        assert not lost
        if not active and not f:
            return {s.rid: list(s.generated) for s in fins}
        if not f:
            time.sleep(0.002)
    raise AssertionError("pool did not drain")


def _port_engines(jengines, sv):
    """Port engines serving the JAX engines' (converted) weights."""
    return {name: TierEngine(
        build_model(reduced_config(je.cfg.name).replace(dtype="float32"),
                    device="cpu"),
        params_from_numpy(jax.device_get(je.params), "cpu"), sv)
        for name, je in jengines.items()}


def _moa(topo, jax_side=False):
    if jax_side:
        return JScheduler(policy=j_make_policy(
            "moa-off", JPolicyConfig(adaptive_tau=False), topology=topo))
    return MoAOffScheduler(policy=make_policy(
        "moa-off", PolicyConfig(adaptive_tau=False), topology=topo),
        use_kernel=False)


# ---------------------------------------------------------------------------
# process replicas (two workers)
# ---------------------------------------------------------------------------


def test_process_replicas_match_local_and_sibling_rescues():
    """Two spawned replicas on the CPU serve four requests with the tokens
    of a local engine built from the same seed; then one worker is killed
    mid-request, its rid is reported lost, and the sibling serves it with
    the local engine's tokens."""
    sv = ServingConfig(max_batch=2, max_seq=96)
    jobs = [(rid, _prompt(8 + 3 * rid, base=rid), 10) for rid in range(5)]
    cfg = reduced_config("qwen3-0.6b").replace(dtype="float32")
    model = build_model(cfg, device="cpu")
    ref = TierEngine(model, model.init(0), sv)
    for rid, toks, max_new in jobs:
        ref.submit(rid, toks, max_new=max_new)
    want = {s.rid: list(s.generated) for s in ref.run_until_drained()}

    pool = EnginePool("edge", [ProcessTransport(ReplicaSpec(
        model="qwen3-0.6b", serving=sv, param_seed=0, name=f"edge/{r}",
        device="cpu")) for r in range(2)])
    try:
        for rid, toks, max_new in jobs[:4]:
            pool.submit_to(rid % 2, rid, toks, max_new=max_new, extras={},
                           deadline=None, session=None)
        got = _drain(pool)
        assert got == {rid: want[rid] for rid in range(4)}
        assert pool.counters()["decode_tokens"] == sum(
            len(want[rid]) for rid in range(4))

        rid, toks, max_new = jobs[4]
        pool.submit_to(0, rid, toks, max_new=max_new, extras={},
                       deadline=None, session=None)
        pool.transports[0]._proc.kill()
        lost = []
        deadline = time.monotonic() + 60.0
        while not lost and time.monotonic() < deadline:
            _, _, lost = pool.poll()
        assert lost == [rid]
        assert not pool.transports[0].alive and pool.n_alive == 1
        pool.submit_to(1, rid, toks, max_new=max_new, extras={},
                       deadline=None, session=None)
        assert _drain(pool) == {rid: want[rid]}
    finally:
        pool.close()


def test_speculation_behind_process_pools_falls_back_to_plain_decode():
    """``_spec_drive`` co-drives only in-process replicas: behind process
    pools (two workers) a speculated request is decoded plainly, with the
    tokens of local engines, and nothing is drafted."""
    sv = ServingConfig(max_batch=2, max_seq=96)
    topo = two_tier_topology()
    spec = SpecConfig(draft_tier="edge", target_tier="cloud", draft_k=4)
    prompt = "please Summarize this corpus now. " * 3
    runs = {}
    for transport in ("local", "process"):
        server = ClusterServer(
            build_engine_pools(topo, sv, transport=transport, device="cpu"),
            topology=topo, scheduler=_moa(topo), spec=spec)
        try:
            server.submit(prompt, max_new=8, complexity={"text": 0.95})
            (res,) = server.run(timeout_s=120.0)
        finally:
            server.close()
        (out,) = server.runtime.outcomes
        runs[transport] = (res.tier, res.tokens, out.drafted_tokens)
    assert runs["local"][0] == runs["process"][0] == "cloud"
    assert runs["local"][2] > 0 and runs["process"][2] == 0
    assert runs["process"][1] == runs["local"][1]


# ---------------------------------------------------------------------------
# byzantine event streams against JAX's honest stream
# ---------------------------------------------------------------------------


def _drive(transport, jobs, chaos):
    events = []
    transport.wire_hooks(
        lambda rid, t: events.append(("admit", rid)),
        lambda rid, tok, t: events.append(("token", rid, tok)),
        lambda rid, k, c, s: None, lambda rid, sid: None)
    if chaos is not None:
        transport.arm_delivery(chaos, chaos.stats, lambda: 0.0,
                               "events:edge/0")
    for rid, toks, max_new in jobs:
        transport.submit(rid, toks, max_new, {}, None, None)
    done = {}
    for _ in range(10_000):
        fins, active, _ = transport.poll()
        for f in fins:
            done[f.rid] = list(f.generated)
        if not active and len(done) == len(jobs):
            break
    return done, events


@pytest.mark.parametrize("family", [
    "dense", "vlm", pytest.param("moe", marks=pytest.mark.slow)])
def test_byzantine_event_stream_delivers_the_jax_tokens(family,
                                                       family_model):
    cfg, params = family_model(family)
    sv_kw = dict(max_batch=2, max_seq=64)
    jobs = [(rid, _prompt(6 + 3 * rid), 8) for rid in range(3)]
    honest, _ = _drive(JLocal(JTierEngine(j_build(cfg), params,
                                          JServingConfig(**sv_kw))),
                       jobs, None)
    tm = build_model(reduced_config(cfg.name).replace(dtype="float32"),
                     device="cpu")
    tr = LocalTransport(TierEngine(
        tm, params_from_numpy(jax.device_get(params), "cpu"),
        ServingConfig(**sv_kw)))
    plan = FaultPlan([FaultEvent("msg_drop", "*", magnitude=0.25),
                      FaultEvent("msg_dup", "*", magnitude=0.25),
                      FaultEvent("msg_reorder", "*", magnitude=0.25)],
                     wire_seed=7)
    chaos = WireChaos(plan)
    chaotic, events = _drive(tr, jobs, chaos)
    assert chaotic == honest
    assert tr._guard.audit("edge/0") == []
    assert chaos.stats.get("dups_suppressed", 0) > 0
    per_rid = {}
    for ev in events:
        if ev[0] == "token":
            per_rid.setdefault(ev[1], []).append(ev[2])
    assert per_rid == honest  # every token delivered once, in order


# ---------------------------------------------------------------------------
# live storms through the whole control plane, both packages
# ---------------------------------------------------------------------------


def _port_twin(jserver, sv, **kw):
    topo = get_topology("edge-edge-cloud")
    return ClusterServer(_port_engines(jserver.engines, sv), topology=topo,
                         scheduler=_moa(topo), **kw)


def _plan(cls_plan, cls_event, scenario):
    if scenario == "storm":
        return cls_plan([cls_event("msg_drop", "*", magnitude=0.2),
                         cls_event("msg_dup", "*", magnitude=0.3),
                         cls_event("msg_reorder", "*", magnitude=0.2)],
                        wire_seed=11)
    return cls_plan([cls_event("corrupt", "*", magnitude=1.0)], wire_seed=3)


@pytest.mark.parametrize("scenario", ["storm", "corrupt-migration"])
def test_live_byzantine_runs_audit_clean_as_jax(scenario):
    """storm: event-stream chaos on every link; the port's routes and
    tokens are the JAX package's honest run's, and its wire counters show
    the faults fired. corrupt-migration: every migration payload is
    corrupted, so the CRC rejects each injection and the hedged clone
    re-prefills; in both packages the request completes, not as a
    migration, with every corruption detected. Both audit clean."""
    kw = dict(audit=True)
    if scenario == "corrupt-migration":
        kw.update(hedge_after_s=0.05, migrate=True)
    jserver = make_twin_edge_server(
        fault_plan=(None if scenario == "storm"
                    else _plan(JFaultPlan, JFaultEvent, scenario)), **kw)
    server = _port_twin(jserver, ServingConfig(max_batch=2, max_seq=192),
                        fault_plan=_plan(FaultPlan, FaultEvent, scenario),
                        **kw)
    runs = {}
    for name, srv in (("jax", jserver), ("port", server)):
        if scenario == "storm":
            for i in range(3):
                srv.submit(f"describe scene {i} please now. " * 2,
                           max_new=8, complexity={"text": 0.05})
        else:
            srv.submit("please describe this Scene in depth. " * 3,
                       max_new=100, complexity={"text": 0.05})
        runs[name] = {r.rid: r for r in srv.run(timeout_s=120.0)}
        verdict = srv.runtime.auditor.last
        assert verdict["clean"], (name, verdict["violations"])
    ws = server.runtime.wire_stats
    assert ws.get("corrupt_undetected", 0) == 0
    if scenario == "storm":
        assert sorted(runs["port"]) == sorted(runs["jax"])
        for rid, r in runs["port"].items():
            want = runs["jax"][rid]
            assert (r.routes, r.tier, r.tokens) == (want.routes, want.tier,
                                                    want.tokens), rid
        assert ws.get("dups_suppressed", 0) > 0
        assert ws.get("msgs_dropped", 0) > 0
    else:
        for name, srv in (("jax", jserver), ("port", server)):
            (res,) = runs[name].values()
            assert not res.failed and not res.migrated and res.tokens, name
            w = srv.runtime.wire_stats
            assert w.get("corrupt_detected", 0) >= 1, name
            assert w.get("corrupt_detected") == w.get("corrupt_injected")


# ---------------------------------------------------------------------------
# tier health through live engines: the port's live server, its simulator
# and the JAX package's simulator
# ---------------------------------------------------------------------------

RESILIENCE_STATES = ("arrival", "routed", "degraded", "enqueue", "retry",
                     "quarantine", "shed", "failed", "complete")


def _resil(trace):
    return [ev for ev in trace if ev[0] in RESILIENCE_STATES]


def _jax_request(req, arrival_s):
    """The same request as the JAX package's dataclasses."""
    from repro.core.request import ModalityInput as JModality
    from repro.core.request import Request as JRequest

    return JRequest(rid=req.rid, arrival_s=arrival_s, modalities={
        k: JModality(m.kind, data=m.data, meta=dict(m.meta),
                     size_bytes=m.size_bytes, complexity=m.complexity)
        for k, m in req.modalities.items()},
        decode_tokens=req.decode_tokens, difficulty=req.difficulty,
        slo_s=req.slo_s, session=req.session)


def test_chaos_lifecycle_live_matches_simulators():
    """A crashed edge tier under the circuit breaker: the port's live
    server (reduced engines on the CPU) quarantines edge on the first
    failure, retries its victim degraded and steers the later arrival
    around the open circuit, with the resilience trace of the port's
    simulator and of the JAX package's, event for event."""
    from repro.config import ResilienceConfig as JResilience
    from repro.config import SimConfig as JSimConfig
    from repro.config import get_topology as j_topology
    from repro.serving.simulator import ClusterSimulator as JSimulator
    from repro_torch.config import ResilienceConfig
    from repro_torch.serving.tiers import build_cluster_engines

    topo = get_topology("edge-edge-cloud")
    sv = ServingConfig(max_batch=2, max_seq=192, heartbeat_timeout_s=0.0)
    res_kw = dict(health=True, quarantine_after=1, probe_after_s=1e9)
    server = ClusterServer(
        build_cluster_engines(topo, sv, device="cpu"), topology=topo,
        scheduler=_moa(topo), resilience=ResilienceConfig(**res_kw),
        fault_plan=FaultPlan([FaultEvent("crash", "edge", t=0.0)]))
    sims = {
        "port": ClusterSimulator(
            SimConfig(seed=0), policy_cfg=PolicyConfig(adaptive_tau=False),
            topology=topo, serving_cfg=sv, device="cpu",
            resilience=ResilienceConfig(**res_kw),
            fault_plan=FaultPlan([FaultEvent("crash", "edge", t=0.0)])),
        "jax": JSimulator(
            JSimConfig(seed=0), policy_cfg=JPolicyConfig(adaptive_tau=False),
            topology=j_topology("edge-edge-cloud"),
            serving_cfg=JServingConfig(max_batch=2, max_seq=192,
                                       heartbeat_timeout_s=0.0),
            resilience=JResilience(**res_kw),
            fault_plan=JFaultPlan([JFaultEvent("crash", "edge", t=0.0)]))}
    reqs = []
    for i, d in enumerate((0.0, 0.5)):
        req = server.build_request(f"describe scene {i} please now. " * 2,
                                   max_new=6, complexity={"text": 0.05},
                                   delay_s=d)
        reqs.append(req)
        sim_req = copy.deepcopy(req)
        sim_req.arrival_s = 5.0 + d
        sims["port"].submit(sim_req)
        sims["jax"].submit(_jax_request(req, 5.0 + d))
        server.submit_request(req)
    live = {r.rid: r for r in server.run(timeout_s=60.0)}
    ana = {name: {o.rid: o for o in sim.run()} for name, sim in sims.items()}
    assert len(live) == 2
    for rid, r in live.items():
        assert not r.failed and r.tier != "edge"
        lt = _resil(server.runtime.records[rid].trace())
        for name, sim in sims.items():
            o = ana[name][rid]
            assert (r.routes, r.tier, r.retries, r.degraded) == (
                o.routes, o.served_tier, o.retries, o.degraded), name
            assert lt == _resil(sim.runtime.records[rid].trace()), name
    t0 = server.runtime.records[reqs[0].rid].trace()
    assert ("quarantine", "edge") in t0 and ("retry", "edge") in t0
    assert live[reqs[1].rid].retries == 0
    assert server.runtime.health.quarantine_count == 1


# ---------------------------------------------------------------------------
# the speculative lifecycle: simulator, live port, live JAX
# ---------------------------------------------------------------------------


def test_speculative_lifecycle_sim_live_and_jax_agree():
    """A cloud-fused request speculates (edge drafts, cloud verifies): the
    port's simulator and its live server emit the same lifecycle; the
    JAX package's live server, on the same weights, takes the same routes
    and drafts and accepts the same token counts as the port's."""
    topo = two_tier_topology()
    sv_kw = dict(max_batch=2, max_seq=96)
    jtopo = j_two_tier()
    jspec = JSpecConfig(draft_tier="edge", target_tier="cloud", draft_k=4)
    spec = SpecConfig(draft_tier="edge", target_tier="cloud", draft_k=4)
    jeng = j_engines(jtopo, JServingConfig(**sv_kw))
    jserver = JClusterServer(jeng, topology=jtopo,
                             scheduler=_moa(jtopo, jax_side=True),
                             spec=jspec)
    server = ClusterServer(_port_engines(jeng, ServingConfig(**sv_kw)),
                           topology=topo, scheduler=_moa(topo), spec=spec)
    sim = ClusterSimulator(SimConfig(seed=0),
                           policy_cfg=PolicyConfig(adaptive_tau=False),
                           topology=two_tier_topology(), spec=spec,
                           device="cpu")
    text = "please Summarize this corpus now. " * 3
    jreq = jserver.build_request(text, max_new=12,
                                 complexity={"text": 0.95})
    req = server.build_request(text, max_new=12, complexity={"text": 0.95})
    sim_req = copy.deepcopy(req)
    sim_req.arrival_s = 5.0
    jserver.submit_request(jreq)
    jserver.run()
    server.submit_request(req)
    server.run()
    sim.submit(sim_req)
    sim.run()

    (jlive,), (live,), (ana,) = (jserver.runtime.outcomes,
                                 server.runtime.outcomes, sim.outcomes)
    assert live.routes == ana.routes == jlive.routes == {"text": "cloud"}
    assert live.served_tier == ana.served_tier == "cloud"
    lt = server.runtime.records[req.rid].trace()
    assert lt == sim.runtime.records[req.rid].trace()
    assert lt == jserver.runtime.records[jreq.rid].trace()
    for mark in (("draft", "edge"), ("verify", "cloud"),
                 ("accept", "cloud")):
        assert mark in lt
    assert live.drafted_tokens == jlive.drafted_tokens > 0
    assert live.accepted_tokens == jlive.accepted_tokens
    assert 0 <= ana.accepted_tokens <= ana.drafted_tokens
    assert ana.drafted_tokens > 0
    (res,), (jres,) = server.results, jserver.results
    assert res.tokens == jres.tokens and len(res.tokens) == 12
    assert server.scheduler.estimator.snapshot().spec_accept is not None
    assert server.pools["edge"].counters()["drafted_tokens"] > 0
    assert server.pools["cloud"].counters()["drafted_tokens"] == 0
    for pool in server.pools.values():
        assert not pool.transports[0].engine.rids()  # no shadow survives


def test_recurrent_process_replica_matches_local():
    """A spawned replica of a recurrent model (reduced recurrentgemma-9b,
    hybrid: RG-LRU state and a ring-window cache; a prompt past its window
    of 32) serves the tokens of a local engine built from the same seed,
    paged (the flat per-slot page charge) as the pool builds it."""
    sv = ServingConfig(max_batch=2, max_seq=96, paged=True, kv_page_size=16)
    jobs = [(rid, _prompt(20 + 12 * rid, base=rid), 8) for rid in range(3)]
    model = build_model(reduced_config("recurrentgemma-9b").replace(
        dtype="float32"), device="cpu")
    ref = TierEngine(model, model.init(0), sv)
    for rid, toks, max_new in jobs:
        ref.submit(rid, toks, max_new=max_new)
    want = {s.rid: list(s.generated) for s in ref.run_until_drained()}
    pool = EnginePool("edge", [ProcessTransport(ReplicaSpec(
        model="recurrentgemma-9b", serving=sv, param_seed=0,
        name="edge/0", device="cpu"))])
    try:
        for rid, toks, max_new in jobs:
            pool.submit_to(0, rid, toks, max_new=max_new, extras={},
                           deadline=None, session=None)
        assert _drain(pool) == want
    finally:
        pool.close()
