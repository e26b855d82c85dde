"""System-state tracking for the offloading policy: s = (ℓ_t, b) of Eq. 5/6.

Generalized to an N-tier cluster: load and queue-depth EWMAs are kept per
tier name; the two-tier quantities of the paper (``edge_load``,
``cloud_load``, …) remain available as property views onto the dicts, so all
legacy call sites and the Eq. 5 gate read the same numbers they always did.
"""
from __future__ import annotations

from typing import Deque, Dict, List, Optional
import collections

EDGE_TIER, CLOUD_TIER = "edge", "cloud"


class SystemState:
    """Per-tier system state with legacy two-tier accessors.

    Constructor keeps the historical field order
    ``(edge_load, bandwidth_bps, cloud_load, queue_depth_edge,
    queue_depth_cloud)`` so existing positional/keyword call sites work
    unchanged; N-tier callers pass ``loads`` / ``queue_depths`` /
    ``bandwidths`` dicts keyed by tier name.
    """

    def __init__(self, edge_load: float = 0.0, bandwidth_bps: float = 300e6,
                 cloud_load: float = 0.0, queue_depth_edge: int = 0,
                 queue_depth_cloud: int = 0, *,
                 loads: Optional[Dict[str, float]] = None,
                 queue_depths: Optional[Dict[str, int]] = None,
                 bandwidths: Optional[Dict[str, float]] = None):
        self.loads: Dict[str, float] = {EDGE_TIER: float(edge_load),
                                        CLOUD_TIER: float(cloud_load)}
        self.queue_depths: Dict[str, int] = {
            EDGE_TIER: int(queue_depth_edge),
            CLOUD_TIER: int(queue_depth_cloud)}
        if loads:
            self.loads.update({k: float(v) for k, v in loads.items()})
        if queue_depths:
            self.queue_depths.update({k: int(v)
                                      for k, v in queue_depths.items()})
        # scalar b of Eq. 5 (the edge<->cloud WAN); per-tier uplinks optional
        self.bandwidth_bps = float(bandwidth_bps)
        self.bandwidths: Dict[str, float] = (
            {k: float(v) for k, v in bandwidths.items()} if bandwidths else {})
        # cache-affinity signal: parked multi-turn sessions per tier (their
        # next turns will stick there, i.e. near-future load the raw queue
        # depths don't show yet)
        self.parked_sessions: Dict[str, int] = {}
        # real per-tier KV headroom (free fraction of the paged KV pool,
        # [0, 1]): finer-grained than slot occupancy — a tier can have free
        # slots but no pages (long contexts) or free pages but no slots
        self.kv_headroom: Dict[str, float] = {}
        # circuit-breaker states from the runtime's HealthMonitor (tier ->
        # "healthy" | "suspect" | "quarantined" | "probing"); empty when
        # the health layer is off — every tier then reads as healthy
        self.health: Dict[str, str] = {}
        # per-replica occupancy vectors for replicated tiers (tier ->
        # [load per replica], a dead replica reads 1.0); empty on
        # single-engine backends and the analytic simulator
        self.replica_loads: Dict[str, List[float]] = {}
        # speculative-decoding acceptance-rate EWMA (accepted/drafted of
        # finished verify loops); None until the first observation — the
        # scheduler then falls back to SpecConfig.init_accept
        self.spec_accept: Optional[float] = None

    # -- per-tier access ----------------------------------------------------

    def load(self, tier: str) -> float:
        return self.loads.get(tier, 0.0)

    def parked(self, tier: str) -> int:
        return self.parked_sessions.get(tier, 0)

    def kv(self, tier: str) -> float:
        """KV-pool headroom toward ``tier`` (1.0 when untracked)."""
        return self.kv_headroom.get(tier, 1.0)

    def queue_depth(self, tier: str) -> int:
        return self.queue_depths.get(tier, 0)

    def replicas(self, tier: str) -> List[float]:
        """Per-replica occupancy toward ``tier`` ([] when unreplicated)."""
        return self.replica_loads.get(tier, [])

    def replica_imbalance(self, tier: str) -> float:
        """Spread between the busiest and idlest replica (0 when the tier
        has fewer than two replicas — nothing to balance)."""
        reps = self.replica_loads.get(tier)
        if not reps or len(reps) < 2:
            return 0.0
        return max(reps) - min(reps)

    def healthy(self, tier: str) -> bool:
        """False only when the tier's circuit is OPEN (quarantined/probing
        admit no regular traffic); untracked tiers read healthy."""
        return self.health.get(tier, "healthy") not in ("quarantined",
                                                        "probing")

    def bandwidth_to(self, tier: str) -> float:
        """Uplink bandwidth toward ``tier`` (the global b when untracked)."""
        return self.bandwidths.get(tier, self.bandwidth_bps)

    # -- legacy two-tier views ---------------------------------------------

    @property
    def edge_load(self) -> float:
        return self.loads.get(EDGE_TIER, 0.0)

    @edge_load.setter
    def edge_load(self, v: float) -> None:
        self.loads[EDGE_TIER] = float(v)

    @property
    def cloud_load(self) -> float:
        return self.loads.get(CLOUD_TIER, 0.0)

    @cloud_load.setter
    def cloud_load(self, v: float) -> None:
        self.loads[CLOUD_TIER] = float(v)

    @property
    def queue_depth_edge(self) -> int:
        return self.queue_depths.get(EDGE_TIER, 0)

    @queue_depth_edge.setter
    def queue_depth_edge(self, v: int) -> None:
        self.queue_depths[EDGE_TIER] = int(v)

    @property
    def queue_depth_cloud(self) -> int:
        return self.queue_depths.get(CLOUD_TIER, 0)

    @queue_depth_cloud.setter
    def queue_depth_cloud(self, v: int) -> None:
        self.queue_depths[CLOUD_TIER] = int(v)

    def __repr__(self) -> str:
        return (f"SystemState(loads={self.loads}, "
                f"queues={self.queue_depths}, "
                f"bandwidth_bps={self.bandwidth_bps:.3g})")


class StateEstimator:
    """EWMA smoothing of raw observations (load spikes shouldn't thrash τ)."""

    def __init__(self, alpha: float = 0.2,
                 init: Optional[SystemState] = None):
        self.alpha = alpha
        self.state = init or SystemState()
        self._lat_window: Deque[float] = collections.deque(maxlen=256)

    def observe_load(self, tier: str, load: float) -> None:
        a = self.alpha
        prev = self.state.loads.get(tier, 0.0)
        self.state.loads[tier] = (1 - a) * prev + a * float(load)

    def observe_edge_load(self, load: float) -> None:
        self.observe_load(EDGE_TIER, load)

    def observe_cloud_load(self, load: float) -> None:
        self.observe_load(CLOUD_TIER, load)

    def observe_bandwidth(self, bps: float,
                          tier: Optional[str] = None) -> None:
        a = self.alpha
        if tier is None:
            self.state.bandwidth_bps = ((1 - a) * self.state.bandwidth_bps
                                        + a * float(bps))
            return
        prev = self.state.bandwidths.get(tier, float(bps))
        self.state.bandwidths[tier] = (1 - a) * prev + a * float(bps)

    def observe_queues(self, edge: int, cloud: int) -> None:
        self.state.queue_depths[EDGE_TIER] = int(edge)
        self.state.queue_depths[CLOUD_TIER] = int(cloud)

    def observe_queue_depths(self, depths: Dict[str, int]) -> None:
        for tier, d in depths.items():
            self.state.queue_depths[tier] = int(d)

    def observe_parked_sessions(self, parked: Dict[str, int]) -> None:
        """Cache-affinity: parked sessions per tier (instantaneous counts,
        not smoothed — they are exact, not noisy samples)."""
        for tier, n in parked.items():
            self.state.parked_sessions[tier] = int(n)

    def observe_kv_headroom(self, kv: Dict[str, float]) -> None:
        """Per-tier KV-pool headroom (exact page counts, not smoothed)."""
        for tier, h in kv.items():
            self.state.kv_headroom[tier] = float(h)

    def observe_replica_loads(self, replicas: Dict[str, List[float]]) -> None:
        """Per-replica occupancy vectors (instantaneous, not smoothed — the
        tier-level EWMA in ``observe_load`` already smooths the aggregate;
        the raw spread is the imbalance signal)."""
        for tier, reps in replicas.items():
            self.state.replica_loads[tier] = [float(x) for x in reps]

    def observe_health(self, health: Dict[str, str]) -> None:
        """Circuit-breaker states (exact, not smoothed — the monitor's
        EWMA already did the smoothing)."""
        for tier, s in health.items():
            self.state.health[tier] = str(s)

    def observe_latency(self, seconds: float) -> None:
        self._lat_window.append(float(seconds))

    def observe_acceptance(self, rate: float) -> None:
        """Speculative-decoding acceptance-rate feedback (accepted/drafted
        of one finished verify loop), EWMA-smoothed like the loads."""
        rate = min(max(float(rate), 0.0), 1.0)
        prev = self.state.spec_accept
        if prev is None:
            self.state.spec_accept = rate
            return
        a = self.alpha
        self.state.spec_accept = (1 - a) * prev + a * rate

    def p95_latency(self) -> float:
        if not self._lat_window:
            return 0.0
        xs = sorted(self._lat_window)
        return xs[min(len(xs) - 1, int(0.95 * len(xs)))]

    def snapshot(self) -> SystemState:
        s = self.state
        snap = SystemState(bandwidth_bps=s.bandwidth_bps,
                           loads=dict(s.loads),
                           queue_depths=dict(s.queue_depths),
                           bandwidths=dict(s.bandwidths))
        snap.parked_sessions = dict(s.parked_sessions)
        snap.kv_headroom = dict(s.kv_headroom)
        snap.health = dict(s.health)
        snap.replica_loads = {t: list(v) for t, v in s.replica_loads.items()}
        snap.spec_accept = s.spec_accept
        return snap
