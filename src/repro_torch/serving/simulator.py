"""Discrete-event simulation of an N-tier edge–cloud cluster (§4,
generalized from the paper's two-tier testbed).

``ClusterSimulator`` is now a thin shell over the shared, event-driven
:class:`~repro.serving.runtime.ClusterRuntime` driven by its
:class:`~repro.serving.runtime.AnalyticBackend` — the SAME lifecycle state
machine that powers the live ``ClusterServer``, executed against a virtual
clock and the analytic cost model instead of real engines. Stations (one
FIFO multi-server queue per tier, one WAN link per remote tier) take service
times from the cost model over the REAL model configs; the scheduler in the
loop is the real MoA-Off implementation (same code path that serves the live
engine). Fault tolerance is exercised in-simulation: nodes fail with a
configurable rate (heartbeat-detected, requests retried) and slow stragglers
are hedged to the least-loaded other tier.

The topology comes from ``ClusterTopology`` (config arg or ``--topology``
name); with none given the paper's edge/cloud pair is built from the legacy
``SimConfig`` fields, reproducing the original behavior and metric keys
exactly (regression-locked against pre-refactor golden values in
``tests/test_runtime_parity.py``). Outputs per policy: latency distribution,
accuracy, per-tier compute (FLOP·s used) and memory (byte·s) overheads —
everything Table 1 / Fig. 3 / Fig. 4 need.

Counterpart of ``repro/serving/simulator.py``, copied with its imports
rewritten and one divergence: ``ClusterSimulator(device=...)`` says where
the scheduler scores images. ``"cuda"`` (the default) scores them with the
image-statistics kernel; ``"cpu"`` asks for its plain version
(``MoAOffScheduler(use_kernel=False)``), as live engines on the CPU do
(``serving/tiers.py``). Requests that carry image metadata but no pixels
(``RequestGenerator(materialize_images=False)``, the default) never reach
either.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.config import (ClusterTopology, ModelConfig, PolicyConfig,
                          ResilienceConfig, ServingConfig, SimConfig,
                          SpecConfig, TierSpec, two_tier_topology)
from repro_torch.core.baselines import make_policy
from repro_torch.core.request import Outcome, Request
from repro_torch.core.scheduler import MoAOffScheduler
from repro_torch.serving.accuracy_model import VQAV2, AccuracyModel
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.runtime import (AnalyticBackend, ClusterRuntime, Event,
                                   Station)

__all__ = ["ClusterSimulator", "EdgeCloudSimulator", "Event", "Station"]


class ClusterSimulator:
    """Cluster runtime simulator over an arbitrary ``ClusterTopology``."""

    def __init__(self, sim_cfg: SimConfig, policy_name: str = "moa-off",
                 policy_cfg: PolicyConfig = PolicyConfig(),
                 acc_model: AccuracyModel = VQAV2,
                 fail_rate: float = 0.0, hedge_after_s: float = 0.0,
                 cloud_servers: int = 4, edge_servers: int = 1,
                 topology: Optional[ClusterTopology] = None,
                 migrate: bool = False, migrate_threshold: int = 0,
                 hedge_in_service: bool = False, sessions: bool = False,
                 session_move_threshold: int = 0,
                 prefix_cache_mb: float = 0.0,
                 session_cache_mb: float = 64.0,
                 max_context_tokens: Optional[int] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 serving_cfg: Optional[ServingConfig] = None,
                 spec: Optional[SpecConfig] = None,
                 audit: bool = False, device: str = "cuda"):
        # legacy-shim: a plan carrying only a Bernoulli rate compiles back
        # into the scalar knob, through the same rng stream as ever
        if fault_plan is not None and fail_rate == 0.0:
            fail_rate = fault_plan.fail_rate
        self.cfg = sim_cfg
        topo = topology or sim_cfg.topology
        if topo is not None and (edge_servers != 1 or cloud_servers != 4):
            raise ValueError(
                "edge_servers/cloud_servers only apply to the legacy "
                "two-tier default; set TierSpec.servers on the topology "
                "instead")
        topo = topo or two_tier_topology(
            sim_cfg.edge, sim_cfg.cloud, sim_cfg.bandwidth_bps,
            sim_cfg.rtt_s, edge_servers=edge_servers,
            cloud_servers=cloud_servers)
        self.topology = topo
        self.policy_name = policy_name
        self.scheduler = MoAOffScheduler(policy=make_policy(
            policy_name, policy_cfg, topology=topo),
            use_kernel=(device == "cuda"))
        self.acc = acc_model
        self.backend = AnalyticBackend(
            topo, acc_model, seed=sim_cfg.seed, fail_rate=fail_rate,
            fallback_bandwidth_bps=sim_cfg.bandwidth_bps,
            prefix_cache_mb=prefix_cache_mb,
            session_cache_mb=session_cache_mb,
            max_context_tokens=max_context_tokens,
            serving=serving_cfg)
        self.runtime = ClusterRuntime(topo, self.scheduler, policy_name,
                                      self.backend,
                                      hedge_after_s=hedge_after_s,
                                      migrate=migrate,
                                      migrate_threshold=migrate_threshold,
                                      hedge_in_service=hedge_in_service,
                                      sessions=sessions,
                                      session_move_threshold=
                                      session_move_threshold,
                                      resilience=resilience,
                                      fault_plan=fault_plan, spec=spec,
                                      audit=audit)
        self.hedge_after_s = hedge_after_s
        # legacy attribute views (None when the topology lacks the name)
        self.edge = self.stations.get("edge")
        self.cloud = self.stations.get("cloud")
        self.link = self.links.get("cloud")

    # -- delegation views (legacy simulator surface) -----------------------

    @property
    def rng(self) -> np.random.Generator:
        return self.backend.rng

    @property
    def specs(self) -> Dict[str, TierSpec]:
        return self.backend.specs

    @property
    def models(self) -> Dict[str, ModelConfig]:
        return self.backend.models

    @property
    def stations(self) -> Dict[str, Station]:
        return self.backend.stations

    @property
    def links(self) -> Dict[str, Station]:
        return self.runtime.links

    @property
    def encode_flops(self) -> Dict[str, float]:
        return self.backend.encode_flops

    @property
    def events(self) -> List[Event]:
        return self.runtime.events

    @property
    def outcomes(self) -> List[Outcome]:
        return self.runtime.outcomes

    @property
    def t(self) -> float:
        return self.runtime.t

    # ------------------------------------------------------------------

    def submit(self, req: Request):
        self.runtime.submit(req)

    def run(self) -> List[Outcome]:
        return self.runtime.run()

    # ------------------------------------------------------------------

    def metrics(self) -> Dict[str, float]:
        lats = np.array([o.latency_s for o in self.outcomes])
        acc = np.mean([o.correct for o in self.outcomes])
        per_flops = {name: 0.0 for name in self.stations}
        per_mem = {name: 0.0 for name in self.stations}
        for o in self.outcomes:
            for t, v in o.tier_flops.items():
                per_flops[t] += v
            for t, v in o.tier_mem_bytes.items():
                per_mem[t] += v
        local = {t.name for t in self.topology.local_tiers}
        frac_local = float(np.mean([
            all(r in local for r in o.routes.values())
            for o in self.outcomes]))
        out = {
            "accuracy": float(acc),
            "mean_latency_s": float(lats.mean()),
            "p50_latency_s": float(np.percentile(lats, 50)),
            "p95_latency_s": float(np.percentile(lats, 95)),
            "p99_latency_s": float(np.percentile(lats, 99)),
            "total_flops": sum(per_flops.values()),
            "total_mem_byte_s": sum(per_mem.values()),
            "frac_edge": frac_local,  # legacy name: fully-local fraction
            "frac_local": frac_local,
            "hedged": float(np.mean([o.hedged for o in self.outcomes])),
            "retries": float(np.mean([o.retries for o in self.outcomes])),
        }
        if self.runtime.migrate:
            # migration metrics only when the edge is on: the golden
            # pre-refactor metric KEY SET must stay exact otherwise
            out["migrated"] = float(np.mean(
                [o.migrated for o in self.outcomes]))
            out["migration_bytes"] = float(sum(
                o.migration_bytes for o in self.outcomes))
        if self.runtime.sessions or any(
                s.enabled for s in self.backend.prefix.values()):
            # prefix & session KV reuse metrics, gated for the same reason
            out["resumed"] = float(np.mean(
                [o.warm == "resume" for o in self.outcomes]))
            out["prefix_hits"] = float(np.mean(
                [o.warm == "prefix" for o in self.outcomes]))
            out["warm_tokens"] = float(sum(
                o.warm_tokens for o in self.outcomes))
            out["session_moves"] = float(self.runtime.session_moves)
        rt = self.runtime
        if (rt.resilience.enabled or rt.plan is not None
                or any(o.failed for o in self.outcomes)):
            # resilience metrics, gated to keep the golden key set exact:
            # goodput = completed-on-time fraction OF SUBMITTED work
            # (failed/shed outcomes count against it)
            n = max(len(self.outcomes), 1)
            out["failed"] = float(sum(o.failed and o.fail_reason == "retries"
                                      for o in self.outcomes)) / n
            out["shed"] = float(sum(o.fail_reason == "shed"
                                    for o in self.outcomes)) / n
            out["degraded"] = float(sum(o.degraded
                                        for o in self.outcomes)) / n
            out["goodput"] = float(sum((not o.failed) and o.on_time
                                       for o in self.outcomes)) / n
            out["quarantines"] = float(
                rt.health.quarantine_count if rt.health is not None else 0)
            out["rescued_sessions"] = float(rt.rescued_sessions)
        for name, st in self.stations.items():
            out[f"{name}_flops"] = per_flops[name]
            out[f"{name}_mem_byte_s"] = per_mem[name]
            out[f"{name}_util"] = st.busy_time / max(self.t, 1e-9)
        return out


# the original two-tier entry point: same class, topology defaulted from the
# legacy SimConfig edge/cloud pair
EdgeCloudSimulator = ClusterSimulator
