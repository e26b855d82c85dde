"""§3.2 Adaptive Edge-Cloud Collaborative Offloading — Eq. 5 and Eq. 6,
generalized to an N-tier cluster topology.

``decide_modality`` is the literal Eq. 5; ``OffloadingPolicy`` is the full
π(c_1..c_k, s) with per-modality thresholds and (beyond the paper's static
τ=0.5) an adaptive-τ controller driven by the EWMA system state, implementing
the paper's "integrates modality-aware thresholds with system-level dynamics".

Tier selection is two-stage: per-tier Eq. 5 eligibility (local tiers gate on
complexity + load + bandwidth exactly as in the paper; remote tiers gate on a
capability-scaled complexity threshold), then a cost-model-informed argmin
over the eligible set. On the default two-tier topology this reduces exactly
to the paper's binary edge/cloud rule.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence

from repro_torch.config import (ClusterTopology, PolicyConfig, TierSpec,
                          two_tier_topology)
from repro_torch.core.request import Decision, Request
from repro_torch.core.state import SystemState

EDGE, CLOUD = "edge", "cloud"


def decide_modality(c: float, tau: float, state: SystemState,
                    pol: PolicyConfig, load: Optional[float] = None) -> str:
    """Eq. 5 for one modality.

    Literal form: edge iff  c <= τ  ∧  ℓ <= ℓ_max  ∧  b <= β.
    Corrected form (paper_faithful_bandwidth=False): the bandwidth term
    instead gates CLOUD eligibility — offloading needs b >= β_min, otherwise
    the transfer would dominate and the edge keeps the work.

    ``load`` overrides the gated utilization (defaults to the edge tier's);
    the N-tier policy calls this once per local tier with that tier's ℓ.
    """
    ell = state.edge_load if load is None else load
    load_ok = ell <= pol.edge_load_max
    if pol.paper_faithful_bandwidth:
        bw_ok = state.bandwidth_bps <= pol.bandwidth_beta
        return EDGE if (c <= tau and load_ok and bw_ok) else CLOUD
    cloud_feasible = state.bandwidth_bps >= pol.bandwidth_beta * 0.1
    if c <= tau and load_ok:
        return EDGE
    return CLOUD if cloud_feasible else EDGE


def tier_cost_estimate(tier: TierSpec, request: Optional[Request],
                       modality: str, state: SystemState) -> float:
    """Queue-aware service + transfer latency estimate for one modality on
    one tier, from the analytic cost model over the tier's real model."""
    from repro_torch.configs import get_config  # local imports, no cycle
    from repro_torch.serving import cost_model as cm

    mcfg = get_config(tier.model)  # memoized in the config registry
    mod = request.modalities.get(modality) if request is not None else None
    if mod is not None:
        toks = cm.modality_tokens(mcfg, mod)
        img_toks = toks if mod.kind == "image" else 0
        txt_toks = toks if mod.kind != "image" else 0
        size = mod.size_bytes
    else:  # score-only call sites (property tests): nominal text modality
        img_toks, txt_toks, size = 0, 64, 4096
    decode = request.decode_tokens if request is not None else 32
    costs = cm.request_phase_costs(mcfg, txt_toks, img_toks, decode, tier)
    sec = costs["prefill"].seconds + costs["decode"].seconds
    sec *= 1.0 + state.queue_depth(tier.name) / max(tier.servers, 1)
    if tier.is_remote:
        # observed per-tier bandwidth, falling back to the global scalar b —
        # a degraded link reprices the tier even when only b is tracked
        sec += cm.transfer_seconds(size, state.bandwidth_to(tier.name),
                                   tier.rtt_s)
    return sec


class OffloadingPolicy:
    """π(c_1, …, c_k, s) — Eq. 6 with adaptive thresholds over N tiers."""

    name = "moa-off"
    modality_aware = True
    uses_system_state = True

    def __init__(self, cfg: PolicyConfig = PolicyConfig(),
                 topology: Optional[ClusterTopology] = None):
        self.cfg = cfg
        self.topology = topology or two_tier_topology()
        # stamped onto every Decision so any_cloud/all_edge stay correct
        # for arbitrary tier names
        self.local_names = frozenset(
            t.name for t in self.topology.local_tiers)
        self.taus: Dict[str, float] = {
            "image": cfg.tau_image, "text": cfg.tau_text,
            "audio": cfg.tau_audio,
        }

    # -- tier selection -----------------------------------------------------

    def _argmin_tier(self, tiers: Sequence[TierSpec], request, modality: str,
                     state: SystemState) -> str:
        if len(tiers) == 1:  # two-tier fast path == legacy behavior
            return tiers[0].name
        return min(tiers, key=lambda t: tier_cost_estimate(
            t, request, modality, state)).name

    @staticmethod
    def _routable(tiers: Sequence[TierSpec],
                  state: SystemState) -> Sequence[TierSpec]:
        """Drop circuit-open (quarantined/probing) tiers from a candidate
        pool. Falls back to the unfiltered pool when the breaker excluded
        everything — the runtime's degraded-routing layer then decides, so
        the policy never deadlocks on an all-quarantined cluster (and with
        the health layer off the pool passes through untouched)."""
        ok = [t for t in tiers if state.healthy(t.name)]
        return ok or tiers

    def _route_modality(self, request, modality: str, c: float, tau: float,
                        state: SystemState) -> str:
        topo = self.topology
        eligible_local = [
            t for t in self._routable(topo.local_tiers, state)
            if decide_modality(c, tau, state, self.cfg,
                               load=state.load(t.name)) == EDGE]
        if eligible_local:
            return self._argmin_tier(eligible_local, request, modality, state)
        remotes = self._routable(topo.remote_tiers, state)
        if not remotes:  # pure-edge cluster: least-loaded local keeps it
            pool = self._routable(topo.local_tiers, state)
            return min(pool, key=lambda t: state.load(t.name)).name
        # capability-scaled Eq. 5 threshold: a tier of capability κ accepts
        # complexity up to τ + (1-τ)κ — the cloud (κ=1) accepts everything
        eligible = [t for t in remotes
                    if c <= tau + (1.0 - tau) * t.capability]
        if not eligible:
            fallback = [t for t in remotes
                        if t.name == topo.default_remote.name]
            return (fallback or remotes)[0].name
        return self._argmin_tier(eligible, request, modality, state)

    def decide(self, request: Request, scores: Dict[str, float],
               state: SystemState) -> Decision:
        routes = {}
        for modality, c in scores.items():
            tau = self.taus.get(modality, 0.5)
            routes[modality] = self._route_modality(request, modality,
                                                    float(c), tau, state)
        return Decision(routes=routes, taus=dict(self.taus),
                        reason=f"eq5 load={state.edge_load:.2f}",
                        local_tiers=self.local_names)

    def update(self, state: SystemState) -> None:
        """Adaptive-τ controller (collaborative scheduling): balance the
        tier queues — a deep local backlog sheds work outward (τ down),
        a deep remote backlog pulls work back (τ up). At steady moderate
        load this sits at the static τ; under bursts/failures it
        re-balances."""
        if not self.cfg.adaptive_tau:
            return
        topo = self.topology
        local = {t.name for t in topo.local_tiers}
        qe = sum(d for t, d in state.queue_depths.items() if t in local)
        qc = sum(d for t, d in state.queue_depths.items() if t not in local)
        max_local_load = max((state.load(t.name) for t in topo.local_tiers),
                             default=state.edge_load)
        imbalance = (qe - qc) / (qe + qc + 4.0)
        if abs(imbalance) < 0.25 and max_local_load <= self.cfg.edge_load_max:
            return
        delta = -self.cfg.tau_step if (imbalance > 0 or
                                       max_local_load > self.cfg.edge_load_max
                                       ) else self.cfg.tau_step
        for m in self.taus:
            self.taus[m] = min(0.95, max(0.05, self.taus[m] + delta))


class NoCollabPolicy(OffloadingPolicy):
    """Ablation §4.3(b): modality-aware but ignores system state entirely."""

    name = "moa-off-no-collab"
    uses_system_state = False

    def decide(self, request, scores, state):
        frozen = SystemState(edge_load=0.0,
                             bandwidth_bps=self.cfg.bandwidth_beta)
        d = super().decide(request, scores, frozen)
        return dataclasses.replace(d, reason="static")

    def update(self, state):  # no adaptation either
        return


class NoModalityAwarePolicy(OffloadingPolicy):
    """Ablation §4.3(a): the modality-aware module is REMOVED — no complexity
    scores exist, so the scheduler can only route on system state (keep work
    on the anchor local tier while it has headroom, spill outward
    otherwise). Hard and easy inputs are treated identically."""

    name = "moa-off-no-modality"
    modality_aware = False

    def decide(self, request, scores, state):
        anchor = self.topology.default_local
        load_ok = state.load(anchor.name) <= self.cfg.edge_load_max
        route = anchor.name if load_ok else self.topology.default_remote.name
        return Decision(routes={m: route for m in scores},
                        taus=dict(self.taus), reason="state-only",
                        local_tiers=self.local_names)

    def update(self, state):  # no complexity signal -> nothing to adapt
        return
