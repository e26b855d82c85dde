"""The MoA-Off scheduler: modality-aware scoring + adaptive routing.

This is the control plane the paper contributes. It owns
  · the modality-aware module (Pallas-kernel-backed complexity scoring),
  · the offloading policy π (Eq. 6, pluggable — baselines share the interface),
  · the EWMA system-state estimator,
and exposes ``route(request)`` to the serving engine / simulator.
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, List, Optional

import numpy as np

import dataclasses

from repro_torch.config import ComplexityConfig, PolicyConfig, SpecConfig
from repro_torch.core import complexity as cx
from repro_torch.core.policy import OffloadingPolicy
from repro_torch.core.request import Decision, ModalityInput, Request
from repro_torch.core.state import StateEstimator, SystemState


class MoAOffScheduler:
    def __init__(self, policy: Optional[OffloadingPolicy] = None,
                 complexity_cfg: ComplexityConfig = ComplexityConfig(),
                 policy_cfg: PolicyConfig = PolicyConfig(),
                 use_kernel: bool = True,
                 spec: Optional[SpecConfig] = None):
        self.policy = policy or OffloadingPolicy(policy_cfg)
        self.cc = complexity_cfg
        self.estimator = StateEstimator()
        self.use_kernel = use_kernel
        # cross-tier speculative decoding: when set, requests whose fused
        # generation lands on spec.target_tier are additionally stamped to
        # draft on spec.draft_tier — the third choice next to local/offload
        self.spec = spec
        self.score_time_s = 0.0  # cumulative modality-module cost (overhead claim)
        self.n_scored = 0

    # -- modality-aware module ------------------------------------------------

    def score(self, request: Request) -> Dict[str, float]:
        """Complexity per modality. Uses real payloads when present, else the
        metadata counts the data pipeline attached (same formulas)."""
        t0 = time.perf_counter()
        scores: Dict[str, float] = {}
        for name, mod in request.modalities.items():
            if mod.complexity is not None:
                scores[name] = float(mod.complexity)
                continue
            if mod.kind == "image":
                if mod.data is not None:
                    img = np.asarray(mod.data, np.float32)[None]
                    out = cx.image_complexity(img, self.cc,
                                              use_kernel=self.use_kernel)
                    scores[name] = float(out["c_img"][0])
                else:
                    h = mod.meta.get("h", 512)
                    w = mod.meta.get("w", 512)
                    base = min(1.0, (h * w) / (self.cc.ref_h * self.cc.ref_w))
                    scores[name] = (self.cc.w_res * base
                                    + (1 - self.cc.w_res)
                                    * mod.meta.get("content_c", 0.5))
            elif mod.kind == "text":
                out = cx.text_complexity_from_counts(
                    mod.meta.get("tokens", 0), mod.meta.get("entities", 0),
                    mod.meta.get("sentences", 1), self.cc)
                scores[name] = float(out["c_text"])
            elif mod.kind == "audio":
                if mod.data is not None:
                    out = cx.audio_complexity(np.asarray(mod.data)[None], self.cc)
                    scores[name] = float(out["c_audio"][0])
                else:
                    scores[name] = float(mod.meta.get("content_c", 0.5))
            mod.complexity = scores[name]
        self.score_time_s += time.perf_counter() - t0
        self.n_scored += 1
        return scores

    # -- routing ---------------------------------------------------------------

    def route(self, request: Request,
              state: Optional[SystemState] = None) -> Decision:
        scores = self.score(request)
        st = state or self.estimator.snapshot()
        decision = self.policy.decide(request, scores, st)
        if self.spec is not None:
            decision = self._maybe_speculate(decision, st)
        self.policy.update(st)
        return decision

    def _maybe_speculate(self, decision: Decision,
                         st: SystemState) -> Decision:
        """Third routing choice next to {local, offload}: when the fused
        generation lands on the SpecConfig target tier and the acceptance
        EWMA clears ``min_accept``, stamp draft-and-verify onto the
        decision. Lives here (not in the policies) so the ablation
        baselines keep deciding exactly as before."""
        sp = self.spec
        topo = getattr(self.policy, "topology", None)
        if topo is None:
            return decision
        try:
            fusion = topo.fusion_tier(decision.routes)
        except KeyError:
            return decision
        if fusion != sp.target_tier:
            return decision  # generation isn't on the target: no verify
        alpha = st.spec_accept if st.spec_accept is not None else (
            sp.init_accept)
        if alpha < sp.min_accept:
            return decision  # drafts are being rejected: plain offload
        return dataclasses.replace(
            decision,
            speculate=(sp.draft_tier, sp.target_tier, sp.draft_k, alpha),
            reason=decision.reason + "+speculate")

    # -- feedback from the runtime (simulator / live server) -------------------

    def observe(self, *, loads: Optional[Dict[str, float]] = None,
                queue_depths: Optional[Dict[str, int]] = None,
                bandwidths: Optional[Dict[str, float]] = None,
                bandwidth_bps: Optional[float] = None,
                latency_s: Optional[float] = None,
                parked: Optional[Dict[str, int]] = None,
                kv: Optional[Dict[str, float]] = None,
                health: Optional[Dict[str, str]] = None,
                replicas: Optional[Dict[str, List[float]]] = None,
                acceptance: Optional[float] = None,
                edge_load: Optional[float] = None,
                cloud_load: Optional[float] = None) -> None:
        """Feed one batch of system observations into the EWMA estimator.

        The API is dict-based and keyed by tier name: ``loads`` /
        ``queue_depths`` / per-remote-tier ``bandwidths``, plus the scalar
        Eq. 5 WAN ``bandwidth_bps`` and per-request ``latency_s`` feedback.
        ``parked`` is the cache-affinity signal: parked multi-turn sessions
        per tier, whose next turns will route sticky to that tier. ``kv``
        is the per-tier KV-pool headroom (free page fraction) — real memory
        pressure, finer-grained than slot occupancy. ``replicas`` carries
        the per-replica occupancy vectors of replicated tiers (raw, the
        spread is the imbalance signal the tier-level EWMA hides).
        ``edge_load=`` / ``cloud_load=`` are a deprecated two-tier shim kept
        for out-of-tree callers; they fold into ``loads``.
        """
        if edge_load is not None or cloud_load is not None:
            warnings.warn(
                "MoAOffScheduler.observe(edge_load=..., cloud_load=...) is "
                "deprecated; pass loads={'edge': ..., 'cloud': ...} instead",
                DeprecationWarning, stacklevel=2)
            loads = dict(loads or {})
            if edge_load is not None:
                loads.setdefault("edge", edge_load)
            if cloud_load is not None:
                loads.setdefault("cloud", cloud_load)
        if loads:
            for tier, load in loads.items():
                self.estimator.observe_load(tier, load)
        if queue_depths:
            self.estimator.observe_queue_depths(queue_depths)
        if parked:
            self.estimator.observe_parked_sessions(parked)
        if kv:
            self.estimator.observe_kv_headroom(kv)
        if health:
            self.estimator.observe_health(health)
        if replicas:
            self.estimator.observe_replica_loads(replicas)
        if bandwidth_bps is not None:
            self.estimator.observe_bandwidth(bandwidth_bps)
        if bandwidths:
            for tier, bps in bandwidths.items():
                self.estimator.observe_bandwidth(bps, tier=tier)
        if acceptance is not None:
            self.estimator.observe_acceptance(acceptance)
        if latency_s is not None:
            self.estimator.observe_latency(latency_s)
            if hasattr(self.policy, "feedback"):
                self.policy.feedback(latency_s)

    def mean_score_cost_s(self) -> float:
        return self.score_time_s / max(self.n_scored, 1)
