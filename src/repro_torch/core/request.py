"""Request/response dataclasses shared by the scheduler, engine and simulator.

Also defines the request LIFECYCLE the cluster runtime drives — one state
machine for the analytic simulator and the live server:

    arrival -> routed -> [encode:<modality> per off-fusion modality]
            -> [transfer per remote link] -> enqueue -> serve -> complete
    (+ ``hedged`` / ``retry`` / ``preempt``+``migrate`` edges)

``RequestRecord`` is the per-request ledger (shared by hedged twins — the
single ``done`` cell guarantees exactly one Outcome per request);``Job`` is
one serving *attempt* of a request on one tier (the hedge clone is a second
Job pointing at the same record). Together they retire the ad-hoc job dict
the simulator used to thread through its event handlers.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Dict, FrozenSet, List, Optional, Tuple

MODALITIES = ("image", "text", "audio")

#: canonical lifecycle states, identical across execution backends (the
#: sim-vs-live parity test compares these traces, timing aside).
#: ``sticky``/``session_move`` are session-routing decisions made at
#: arrival; ``prefix``/``resume`` mark warm (suffix-only) admissions and
#: ``park`` marks a finished turn's state being retained for the next one.
#: Degradation edges: ``degraded`` (re-routed off an unavailable tier),
#: ``quarantine`` (this request's failure opened the tier's circuit),
#: ``timeout`` (a WAN transfer was abandoned), and the terminal states
#: ``failed`` (retry budget exhausted) / ``shed`` (SLO provably unmeetable).
#: Speculative decoding marks one ``draft`` (draft tier) / ``verify`` /
#: ``accept`` (target tier) triplet per speculated request — one triplet,
#: not one per round, so analytic and live traces stay comparable.
LIFECYCLE = ("arrival", "routed", "sticky", "session_move", "encode",
             "transfer", "enqueue", "prefix", "resume", "serve", "draft",
             "verify", "accept", "hedged", "retry", "preempt", "migrate",
             "park", "degraded", "quarantine", "timeout", "shed", "failed",
             "complete")


@dataclass
class ModalityInput:
    kind: str  # image | text | audio
    data: Optional[Any] = None  # real payload (live serving path)
    meta: Dict[str, float] = field(default_factory=dict)  # h/w/tokens/entities…
    size_bytes: int = 0
    complexity: Optional[float] = None  # filled by the modality-aware module

    def __post_init__(self):
        assert self.kind in MODALITIES, self.kind


@dataclass
class Request:
    rid: int
    arrival_s: float
    modalities: Dict[str, ModalityInput]
    decode_tokens: int = 64
    # latent per-request difficulty in [0,1] — simulator ground truth used by
    # the accuracy model; NOT visible to the policy (it only sees complexity)
    difficulty: float = 0.5
    slo_s: float = 5.0
    # multi-turn session id: turns of one conversation share it. The runtime
    # routes a turn sticky-by-default to the tier holding the session's
    # parked KV, and the serving engine resumes the parked state instead of
    # re-prefilling the whole history.
    session: Optional[str] = None

    def total_bytes(self) -> int:
        return sum(m.size_bytes for m in self.modalities.values())


@dataclass
class Decision:
    """Per-modality routing (Eq. 6) + bookkeeping for the ablation study."""

    routes: Dict[str, str]  # modality -> tier name ("edge"/"cloud"/…)
    taus: Dict[str, float] = field(default_factory=dict)
    reason: str = ""
    # names of the topology's local tiers, stamped by the deciding policy
    local_tiers: FrozenSet[str] = frozenset({"edge"})
    # cross-tier speculative decoding: (draft_tier, target_tier, k, alpha)
    # stamped by the scheduler when the fusion tier matches the SpecConfig
    # target and the acceptance EWMA clears the gate; None = don't
    speculate: Optional[Tuple[str, str, int, float]] = None

    @property
    def any_cloud(self) -> bool:
        """Any modality routed off the local tier set. On the legacy
        two-tier topology this is exactly "any modality went cloud"; on an
        N-tier topology it means "some modality was offloaded to a remote
        tier" (use ``ClusterTopology.fusion_tier`` for the serving tier)."""
        return any(r not in self.local_tiers for r in self.routes.values())

    @property
    def all_edge(self) -> bool:
        return not self.any_cloud


@dataclass
class RequestRecord:
    """Per-request lifecycle ledger, shared by every serving attempt.

    ``events`` is the ordered (state, tier) trace — state names come from
    :data:`LIFECYCLE`; per-token streaming is deliberately NOT an event so
    analytic and live traces stay comparable. ``done`` is the single
    completion cell: whichever hedged twin finishes first flips it, and the
    loser's completion (or a replayed one after a fault restore) is dropped.
    """

    rid: int
    done: bool = False
    events: List[Tuple[str, str]] = field(default_factory=list)
    ttft_s: float = 0.0
    wan_s: float = 0.0  # time spent on WAN links before first enqueue
    truncated: bool = False
    migrated: bool = False  # some attempt's KV cache moved across tiers
    migration_bytes: float = 0.0  # total slot-payload bytes shipped
    warm: str = ""  # "prefix" | "resume" when admitted onto reused KV rows
    warm_tokens: float = 0.0  # cached tokens whose prefill was skipped
    degraded: bool = False  # re-routed off an unavailable/quarantined tier
    tokens: List[int] = field(default_factory=list)  # live: streamed tokens
    # speculative decoding: draft tokens proposed for / accepted by this
    # request's verify loop (0/0 when it was never speculated)
    drafted_tokens: int = 0
    accepted_tokens: int = 0
    outcome: Optional["Outcome"] = None

    def mark(self, state: str, tier: str = "") -> None:
        self.events.append((state, tier))

    def trace(self) -> Tuple[Tuple[str, str], ...]:
        return tuple(self.events)


@dataclass
class Job:
    """One serving attempt of a request on one tier.

    ``payload`` is backend scratch (cached analytic costs / tokenized live
    prompt+extras); the lifecycle fields themselves are typed. A hedge
    clone copies the Job (including the already-paid ``transfer_bytes`` —
    the single Outcome accounts for the original's WAN transfer even when
    the clone wins) but shares the ``record``.
    """

    request: Request
    decision: Decision
    fusion: str  # planned fusion tier (partial-offload discounts anchor here)
    tier: str  # serving tier of THIS attempt
    t_start: float
    record: RequestRecord
    retries: int = 0
    hedged: bool = False
    in_service: bool = False
    pending_transfers: int = 0
    transfer_bytes: float = 0.0
    payload: Dict[str, Any] = field(default_factory=dict)

    #: backend-internal migration/session bookkeeping that must never leak
    #: into a hedge clone (a stale ``preempted`` marker would swallow the
    #: clone's own completion event; a clone has no parked rows shipped
    #: for it, so in-flight session-move state must not ride along)
    _NO_CLONE_KEYS = ("preempted", "migration_wire", "migration_donor",
                      "migration_nbytes", "session_wire", "session_parked",
                      "session_pending")

    def clone(self, tier: str) -> "Job":
        payload = {k: v for k, v in self.payload.items()
                   if k not in self._NO_CLONE_KEYS}
        return dataclasses.replace(self, tier=tier, in_service=False,
                                   payload=payload)


@dataclass
class Outcome:
    """Per-request result with per-tier resource attribution.

    ``tier_flops`` / ``tier_mem_bytes`` are keyed by tier name; the legacy
    two-tier scalars remain readable as properties.
    """

    rid: int
    latency_s: float
    routes: Dict[str, str]
    correct: bool
    tier_flops: Dict[str, float] = field(default_factory=dict)
    tier_mem_bytes: Dict[str, float] = field(default_factory=dict)
    transfer_bytes: float = 0.0
    hedged: bool = False
    retries: int = 0
    served_tier: str = ""  # tier that ran the fused generation
    ttft_s: float = 0.0  # time to first streamed token (live backends)
    on_time: bool = True  # finished within the request's SLO
    truncated: bool = False  # prompt clipped to the engine budget (live)
    migrated: bool = False  # KV cache moved across tiers mid-flight
    migration_bytes: float = 0.0  # slot-payload bytes shipped for this request
    warm: str = ""  # "prefix" | "resume": admitted onto reused KV rows
    warm_tokens: float = 0.0  # cached tokens whose prefill was skipped
    # graceful degradation: a request that could NOT be served ends in a
    # terminal failed Outcome instead of silently vanishing
    failed: bool = False  # terminal: never completed
    fail_reason: str = ""  # "retries" | "shed" | "" (completed)
    degraded: bool = False  # served, but re-routed off an unavailable tier
    # speculative decoding (0/0 when the request was never speculated)
    drafted_tokens: int = 0  # draft-tier proposals shipped for this request
    accepted_tokens: int = 0  # proposals the target verified and committed

    @property
    def edge_flops(self) -> float:
        return self.tier_flops.get("edge", 0.0)

    @property
    def cloud_flops(self) -> float:
        return self.tier_flops.get("cloud", 0.0)

    @property
    def edge_mem_bytes(self) -> float:
        return self.tier_mem_bytes.get("edge", 0.0)

    @property
    def cloud_mem_bytes(self) -> float:
        return self.tier_mem_bytes.get("cloud", 0.0)
