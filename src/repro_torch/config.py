"""Central configuration dataclasses for the repro framework.

Everything is a frozen dataclass so configs are hashable (usable as jit
static args) and safely shareable across threads (serving engine, async
checkpointer).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Architecture description for every model family in the zoo.

    A single config class covers dense / MoE / SSM / hybrid / enc-dec / VLM
    families; the ``family`` tag selects the block stack in
    ``repro.models.build_model``.
    """

    name: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads
    activation: str = "swiglu"  # swiglu | squared_relu | geglu | gelu
    qk_norm: bool = False

    # --- MoE ---
    num_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden width
    num_shared_experts: int = 0
    first_k_dense: int = 0  # leading dense layers before MoE starts
    router_aux_coef: float = 0.01
    capacity_factor: float = 1.25

    # --- SSM (Mamba-2 / SSD) ---
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # --- hybrid (RecurrentGemma / Griffin) ---
    block_pattern: Tuple[str, ...] = ()  # e.g. ("rglru", "rglru", "local_attn")
    local_window: int = 2048
    lru_width: int = 0  # 0 -> d_model

    # --- encoder-decoder (Whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 0  # fixed encoder context (audio frames after conv stub)

    # --- modality frontend (VLM / audio) ---
    frontend: str = "none"  # none | vision_stub | audio_stub
    num_patches: int = 0  # vision tokens prepended to the text sequence
    frontend_dim: int = 0  # embedding dim of the precomputed patches/frames

    # --- misc ---
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    @property
    def q_per_kv(self) -> int:
        return self.num_heads // max(self.num_kv_heads, 1)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def is_subquadratic(self) -> bool:
        """True if serving cost is sub-quadratic in context (long_500k eligible)."""
        return self.family in ("ssm", "hybrid")

    @property
    def d_inner(self) -> int:
        """SSM inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_state else 0

    def param_count(self) -> int:
        """Analytic parameter count (exact for our implementation)."""
        from repro_torch.models.counting import count_params  # local import, no cycle

        return count_params(self)

    def active_param_count(self) -> int:
        from repro_torch.models.counting import count_active_params

        return count_active_params(self)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# Input shapes (assigned per-arch shape set)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_decode(self) -> bool:
        return self.kind == "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def applicable_shapes(cfg: ModelConfig) -> dict:
    """Which of the 4 assigned shapes run for this arch (with skip reasons).

    Returns {shape_name: None | skip_reason}.
    """
    out = {}
    for name, shape in SHAPES.items():
        reason = None
        if name == "long_500k" and not cfg.is_subquadratic:
            reason = (
                "full quadratic attention; 512k-token KV-cache decode is "
                "defined for sub-quadratic archs only (DESIGN.md §4)"
            )
        out[name] = reason
    return out


# ---------------------------------------------------------------------------
# Mesh / distribution
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MeshConfig:
    shape: Tuple[int, ...] = (16, 16)
    axis_names: Tuple[str, ...] = ("data", "model")

    @property
    def num_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axis_names


SINGLE_POD_MESH = MeshConfig((16, 16), ("data", "model"))
MULTI_POD_MESH = MeshConfig((2, 16, 16), ("pod", "data", "model"))


@dataclass(frozen=True)
class ShardingConfig:
    """Knobs for the distribution strategy (hillclimbed in §Perf)."""

    zero_stage: int = 1  # 0: replicated opt state, 1: opt sharded over dp, 3: params too
    remat_policy: str = "dots"  # none | dots | full
    scan_layers: bool = True
    sequence_parallel: bool = True  # shard long activations over data axis
    gradient_accum: int = 1
    # collective-schedule knobs (beyond-paper perf levers)
    all_gather_params_once: bool = False  # ZeRO-3: gather per-layer inside scan
    overlap_collectives: bool = True  # async collective start (XLA flag hint)


# ---------------------------------------------------------------------------
# MoA-Off policy configuration (the paper's §3)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ComplexityConfig:
    """Weights/constants of §3.1 (paper defaults: averaged weights, τ=0.5)."""

    # image weights (sum to 1; paper sets them to their average -> 0.25 each)
    w_res: float = 0.25
    w_edge: float = 0.25
    w_ent: float = 0.25
    w_lap: float = 0.25
    ref_h: int = 1024  # (H0, W0) reference resolution
    ref_w: int = 1024
    # calibration percentiles (P5/P95 over a calibration set; Eq. 2 & 4)
    edge_p5: float = 2.0
    edge_p95: float = 60.0
    lap_p5: float = 10.0
    lap_p95: float = 2_500.0
    eps: float = 1e-6
    # text weights (average -> 0.5 each)
    beta_len: float = 0.5
    beta_ner: float = 0.5
    len_l0: int = 512  # token-length threshold L0
    ner_gamma: float = 4.0  # entities-per-sentence scale γ
    # audio extension (beyond-paper; same recipe applied to frame features)
    audio_ref_frames: int = 1_500


@dataclass(frozen=True)
class PolicyConfig:
    """Eq. 5/6 thresholds and system-state limits."""

    tau_image: float = 0.5
    tau_text: float = 0.5
    tau_audio: float = 0.5
    edge_load_max: float = 0.8  # ℓ_max
    bandwidth_beta: float = 500e6  # β in bit/s (above the paper's 200-400Mbps sweep)
    paper_faithful_bandwidth: bool = True  # literal Eq.5 `b <= β` (see DESIGN.md)
    # adaptive extension: EWMA-driven threshold adjustment (beyond paper §3.2's
    # "integrates modality-aware thresholds with system-level dynamics")
    adaptive_tau: bool = True
    tau_step: float = 0.02
    target_edge_util: float = 0.65


# ---------------------------------------------------------------------------
# Serving / simulation
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class TierConfig:
    """One serving tier (edge or cloud) in the cost model / simulator."""

    name: str
    model: str  # config name served on this tier
    num_chips: int
    flops_per_s: float  # achievable FLOP/s per chip
    hbm_bw: float  # bytes/s per chip
    mfu: float = 0.4  # achieved fraction of peak in the latency model
    startup_s: float = 0.002  # per-batch dispatch overhead


@dataclass(frozen=True)
class TierSpec(TierConfig):
    """A tier in a :class:`ClusterTopology` — TierConfig plus placement.

    ``uplink_bps == 0`` marks the tier as local (no WAN hop to reach it);
    remote tiers pay ``transfer_seconds(bytes, uplink_bps, rtt_s)`` per
    request. ``capability`` ∈ [0,1] anchors the accuracy model: 0.0 behaves
    like the paper's edge model (steep cliff past the difficulty knee),
    1.0 like the cloud model (no cliff); intermediate values interpolate.
    """

    servers: int = 1  # parallel FIFO servers at this tier
    uplink_bps: float = 0.0  # 0 -> local tier, no transfer needed
    rtt_s: float = 0.0
    capability: float = 0.0
    # return path toward the user; 0 -> assume symmetric (== uplink_bps).
    # Response tokens (and any embeddings coming back from a remote encoder)
    # are charged on this link by both execution backends.
    downlink_bps: float = 0.0

    @property
    def is_remote(self) -> bool:
        return self.uplink_bps > 0

    @classmethod
    def from_tier(cls, cfg: TierConfig, **kw) -> "TierSpec":
        if isinstance(cfg, TierSpec):
            return dataclasses.replace(cfg, **kw)
        return cls(**dataclasses.asdict(cfg), **kw)


@dataclass(frozen=True)
class ClusterTopology:
    """N named heterogeneous tiers forming an edge–cloud continuum.

    Frozen + tuple-backed so it can ride inside other frozen configs. The
    first declared local tier is the *anchor* edge (where non-offloaded work
    lands for modality-blind baselines); the highest-capability remote tier
    is the anchor cloud.
    """

    name: str
    tiers: Tuple[TierSpec, ...]

    def __post_init__(self):
        names = [t.name for t in self.tiers]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tier names in topology: {names}")
        if not self.tiers:
            raise ValueError("topology needs at least one tier")

    @property
    def names(self) -> Tuple[str, ...]:
        return tuple(t.name for t in self.tiers)

    @property
    def local_tiers(self) -> Tuple[TierSpec, ...]:
        return tuple(t for t in self.tiers if not t.is_remote)

    @property
    def remote_tiers(self) -> Tuple[TierSpec, ...]:
        return tuple(t for t in self.tiers if t.is_remote)

    def tier(self, name: str) -> TierSpec:
        for t in self.tiers:
            if t.name == name:
                return t
        raise KeyError(f"unknown tier {name!r}; have {self.names}")

    @property
    def default_local(self) -> TierSpec:
        locals_ = self.local_tiers
        return locals_[0] if locals_ else self.tiers[0]

    @property
    def default_remote(self) -> TierSpec:
        remotes = self.remote_tiers
        pool = remotes if remotes else self.tiers
        return max(pool, key=lambda t: t.capability)

    def fusion_tier(self, routes: dict) -> str:
        """Where the fused generation runs: the most capable routed tier
        (legacy semantics: cloud if any modality went cloud, else edge)."""
        routed = [self.tier(r) for r in sorted(set(routes.values()))]
        if not routed:
            return self.default_local.name
        # tier name as final tie-break: deterministic across interpreter
        # runs even when two routed tiers share capability and placement
        best = max(routed, key=lambda t: (t.capability, t.is_remote, t.name))
        return best.name


@dataclass(frozen=True)
class ServingConfig:
    max_batch: int = 32
    max_seq: int = 4_096
    # --- paged KV pool ---
    # KV rows live in fixed-size pages; each slot holds a page table into a
    # shared physical pool, so concurrency is bounded by POOL pages, not by
    # max_batch * max_seq dense rows. Admission is continuous (a request is
    # admitted the moment enough pages free up, splitting the fused block at
    # the page-pressure boundary) and prefix/session hits map shared pages
    # copy-on-write into the new slot's table. ``paged=False`` keeps the
    # dense per-slot pool (the parity baseline).
    paged: bool = False
    kv_page_size: int = 256
    # physical pages in the pool, EXCLUDING the null page. 0 -> auto-size to
    # max_batch * (max_seq // kv_page_size): every slot can hold a full
    # sequence, so admission order (and thus decode output) is identical to
    # the dense pool. Benchmarks shrink this to trade capacity for memory.
    kv_pool_pages: int = 0
    # warm admissions for recurrent families (ssm/hybrid) replay the suffix
    # in ONE chunked pass seeded from the cached state (decode_chunk_recurrent)
    # instead of a per-token warm scan. Bit-identical state trajectory; flip
    # off to fall back to the sequential scan.
    chunked_recurrent_suffix: bool = True
    prefill_chunk: int = 2_048
    hedge_after_s: float = 1.5  # straggler mitigation: hedged re-issue
    retry_limit: int = 2
    heartbeat_interval_s: float = 0.5
    heartbeat_timeout_s: float = 2.0
    # --- device-resident hot path ---
    # decode steps fused into ONE jitted lax.scan per host call: sampling,
    # EOS/budget/cap masking and KV writes stay on device, the host sees one
    # (B, fused_steps) token block. 1 = the legacy per-token path (host-side
    # numpy sampling, one dispatch + transfer per token) kept for parity
    # testing.
    fused_steps: int = 8
    # decode attention backend: "auto" = Pallas decode kernel where it
    # compiles natively (TPU), XLA elsewhere; "pallas"/"xla" force one.
    decode_impl: str = "auto"
    # batch same-length-bucket waiting prompts into one prefill call (pad to
    # power-of-two buckets) instead of one retraced prefill per request.
    # Ignored (off) on the legacy fused_steps=1 path.
    bucket_prefill: bool = True
    # unroll the layer loop inside fused decode so each layer's K/V scatter
    # updates the stacked cache leaf IN PLACE (the scanned form re-assembles
    # — i.e. copies — the whole KV cache every token). O(L) HLO; only
    # applied on the fused path.
    unroll_decode_layers: bool = True
    # fused decode attends a power-of-two cache VIEW just covering the
    # longest active context (+ the fused block), instead of all of
    # ``max_seq`` every token; the view is sliced/pasted once per K-token
    # block. Off on the legacy path (which always pays full capacity).
    context_buckets: bool = True
    # --- prefix & session KV reuse ---
    # byte budget (MB) of the tier-local prefix store: admitted prompts
    # deposit their cache rows at bucket-aligned prefix lengths, and a new
    # prompt extending a stored prefix copies the rows and prefills only
    # the suffix. 0 disables the store (bit-identical to pre-feature
    # serving).
    prefix_cache_mb: float = 0.0
    # byte budget (MB) of the parked-session store: a finished turn of a
    # request submitted with a session id parks its slot state
    # (SlotPayload) so the next turn re-injects and prefills only the new
    # tokens. LRU-evicted; a miss falls back to a cold full prefill.
    session_cache_mb: float = 64.0
    # smallest prefix worth storing/hitting (shorter prompts re-prefill)
    prefix_min_tokens: int = 16
    # idle-wait cap for the live backend's event loop, seconds. 0 = fully
    # event-driven: an idle server sleeps until its next scheduled event
    # (paced arrival / hedge check / fault detect) instead of burning a
    # core polling. A positive value caps each doze — useful when external
    # state (process-replica pipes, injected clock skew) must be re-polled
    # on a bounded cadence; process transports force an internal 20 ms cap
    # regardless.
    idle_poll_s: float = 0.0

    def __post_init__(self):
        if self.idle_poll_s < 0:
            raise ValueError(
                f"idle_poll_s must be >= 0 (0 = event-driven idle wait), "
                f"got {self.idle_poll_s}")
        ps = self.kv_page_size
        if ps <= 0 or ps & (ps - 1):
            raise ValueError(
                f"kv_page_size must be a positive power of two, got {ps} "
                f"(page-table arithmetic uses shifts/masks)")
        if ps < 8:
            raise ValueError(
                f"kv_page_size {ps} < 8: page tables would carry "
                f"max_seq/page_size = {self.max_seq // max(ps, 1)} entries "
                f"per slot; use >= 8")
        if self.paged and self.max_seq % ps:
            raise ValueError(
                f"kv_page_size {ps} must divide max_seq {self.max_seq} so "
                f"every slot's page table has a whole number of pages")
        if self.paged and ps > self.max_seq:
            raise ValueError(
                f"kv_page_size {ps} exceeds max_seq {self.max_seq}: the "
                f"context-bucket ladder (min 32) could never cover a page")
        if self.kv_pool_pages < 0:
            raise ValueError(
                f"kv_pool_pages must be >= 0 (0 = auto-size), got "
                f"{self.kv_pool_pages}")
        if self.paged and self.kv_pool_pages:
            need = self.max_seq // ps
            if self.kv_pool_pages < need:
                raise ValueError(
                    f"kv_pool_pages {self.kv_pool_pages} < {need} pages "
                    f"needed to hold ONE max_seq={self.max_seq} sequence at "
                    f"kv_page_size={ps}; no request could ever be admitted")

    @property
    def pages_per_slot(self) -> int:
        """Page-table length: logical pages covering one full sequence."""
        return self.max_seq // self.kv_page_size

    @property
    def pool_pages(self) -> int:
        """Physical pages in the paged pool (excluding the null page)."""
        return self.kv_pool_pages or self.max_batch * self.pages_per_slot


@dataclass(frozen=True)
class SpecConfig:
    """Cross-tier speculative decoding: a cheap DRAFT tier proposes blocks
    of ``draft_k`` tokens and the TARGET tier verifies the whole block in
    ONE chunked forward against its own KV, accepting the longest matching
    prefix plus its own correction token. Output is token-for-token the
    target-only stream (the committed tokens are the target's own samples
    under its own key stream), so quality is exactly the target's.

    The scheduler speculates only while the acceptance-rate EWMA stays at
    or above ``min_accept``; ``init_accept`` seeds the EWMA so a cold
    system gives speculation a chance before any feedback exists.
    """

    draft_tier: str = "edge"
    target_tier: str = "cloud"
    draft_k: int = 8  # proposed tokens per round
    min_accept: float = 0.3  # stop speculating below this EWMA
    init_accept: float = 0.7  # optimistic cold-start acceptance rate

    def __post_init__(self):
        if self.draft_tier == self.target_tier:
            raise ValueError(
                f"speculation needs two tiers, got draft == target == "
                f"{self.draft_tier!r}")
        if self.draft_k < 1:
            raise ValueError(f"draft_k must be >= 1, got {self.draft_k}")
        if not 0.0 <= self.min_accept <= 1.0:
            raise ValueError(
                f"min_accept must be in [0, 1], got {self.min_accept}")
        if not 0.0 <= self.init_accept <= 1.0:
            raise ValueError(
                f"init_accept must be in [0, 1], got {self.init_accept}")


@dataclass(frozen=True)
class ResilienceConfig:
    """Tier-health / graceful-degradation knobs for the cluster runtime.

    Everything defaults OFF: a default-constructed config leaves the
    runtime's behavior (and the golden analytic metrics) untouched.
    ``health=True`` turns on the per-tier circuit breaker
    (healthy -> suspect -> quarantined -> probing -> healthy, see
    ``serving/health.py``); the other switches gate retry backoff,
    deadline-aware load shedding and WAN transfer timeouts independently.
    """

    # circuit breaker: quarantine a tier after this many consecutive
    # failures; 0 < suspect_after <= quarantine_after
    health: bool = False
    suspect_after: int = 1
    quarantine_after: int = 3
    # failure-rate EWMA (informational health signal published to the
    # scheduler alongside the state machine)
    failure_ewma_alpha: float = 0.3
    # a quarantined tier admits one probe request after this cool-down;
    # the probe's outcome decides healthy vs re-quarantined
    probe_after_s: float = 5.0
    # retries wait cap(min(base * 2^(n-1))) * (1 + jitter) instead of
    # re-enqueueing immediately; jitter is deterministic per (rid, attempt)
    retry_backoff: bool = False
    backoff_base_s: float = 0.25
    backoff_cap_s: float = 4.0
    backoff_jitter: float = 0.25
    # shed (terminal Outcome, fail_reason="shed") instead of queueing when
    # the request's SLO deadline is provably unmeetable
    shed: bool = False
    # WAN transfers/migrations older than this are abandoned (0 = never);
    # required for progress under a full link partition
    transfer_timeout_s: float = 0.0
    # evacuate parked sessions off a tier entering quarantine onto the
    # best available compatible tier (existing SlotPayload transport)
    rescue_sessions: bool = True

    def __post_init__(self):
        if not 0 < self.suspect_after <= self.quarantine_after:
            raise ValueError(
                "need 0 < suspect_after <= quarantine_after, got "
                f"{self.suspect_after}/{self.quarantine_after}")

    @property
    def enabled(self) -> bool:
        """Any resilience feature on (gates the new metric keys)."""
        return (self.health or self.retry_backoff or self.shed
                or self.transfer_timeout_s > 0)


@dataclass(frozen=True)
class SimConfig:
    """Discrete-event cluster simulation of the paper's testbed."""

    bandwidth_bps: float = 300e6  # WAN edge<->cloud
    rtt_s: float = 0.02
    num_requests: int = 1_000
    arrival_rate: float = 20.0  # req/s Poisson
    seed: int = 0
    edge: TierConfig = field(
        default_factory=lambda: TierConfig(
            "edge", "qwen2-vl-2b", 1, 35.6e12, 936e9, mfu=0.25
        )  # RTX-3090-class: 35.6 TFLOP/s fp16, 936 GB/s
    )
    cloud: TierConfig = field(
        default_factory=lambda: TierConfig(
            "cloud", "qwen2.5-vl-7b", 1, 312e12, 1_555e9, mfu=0.42
        )  # A100-40GB-class: 312 TFLOP/s bf16, 1.56 TB/s
    )
    # optional N-tier cluster; None -> the legacy two-tier pair above
    topology: Optional[ClusterTopology] = None


# ---------------------------------------------------------------------------
# Topology builders / registry
# ---------------------------------------------------------------------------


def two_tier_topology(edge: Optional[TierConfig] = None,
                      cloud: Optional[TierConfig] = None,
                      bandwidth_bps: float = 300e6, rtt_s: float = 0.02,
                      edge_servers: int = 1, cloud_servers: int = 1,
                      name: str = "edge-cloud") -> ClusterTopology:
    """The paper's testbed (§4.1) as a ClusterTopology: one local edge GPU,
    one remote cloud GPU behind a WAN uplink."""
    e = edge or TierConfig("edge", "qwen2-vl-2b", 1, 35.6e12, 936e9, mfu=0.25)
    c = cloud or TierConfig("cloud", "qwen2.5-vl-7b", 1, 312e12, 1_555e9,
                            mfu=0.42)
    return ClusterTopology(name, (
        TierSpec.from_tier(e, servers=edge_servers, capability=0.0),
        TierSpec.from_tier(c, servers=cloud_servers, uplink_bps=bandwidth_bps,
                           rtt_s=rtt_s, capability=1.0),
    ))


def _edge_cloud() -> ClusterTopology:
    return two_tier_topology()


def _edge_edge_cloud() -> ClusterTopology:
    """Two heterogeneous edge GPUs (3090-class + Orin-class) + one cloud."""
    return ClusterTopology("edge-edge-cloud", (
        TierSpec("edge", "qwen2-vl-2b", 1, 35.6e12, 936e9, mfu=0.25,
                 capability=0.0),
        TierSpec("edge1", "qwen2-vl-2b", 1, 10.6e12, 204e9, mfu=0.20,
                 capability=0.0),  # Jetson-Orin-class
        TierSpec("cloud", "qwen2.5-vl-7b", 1, 312e12, 1_555e9, mfu=0.42,
                 servers=2, uplink_bps=300e6, rtt_s=0.02, capability=1.0),
    ))


def _edge_regional_cloud() -> ClusterTopology:
    """Cloud-edge continuum: edge GPU, regional A10-class node on a fat
    metro link, A100 cloud across the WAN."""
    return ClusterTopology("edge-regional-cloud", (
        TierSpec("edge", "qwen2-vl-2b", 1, 35.6e12, 936e9, mfu=0.25,
                 capability=0.0),
        TierSpec("regional", "qwen2.5-vl-7b", 1, 125e12, 933e9, mfu=0.35,
                 servers=2, uplink_bps=1e9, rtt_s=0.005, capability=0.7),
        TierSpec("cloud", "qwen2.5-vl-7b", 1, 312e12, 1_555e9, mfu=0.42,
                 uplink_bps=300e6, rtt_s=0.02, capability=1.0),
    ))


def _continuum_4() -> ClusterTopology:
    """Four tiers: two edge GPUs + regional + cloud."""
    base = _edge_regional_cloud()
    edge1 = TierSpec("edge1", "qwen2-vl-2b", 1, 10.6e12, 204e9, mfu=0.20,
                     capability=0.0)
    return ClusterTopology("continuum-4",
                           (base.tiers[0], edge1) + base.tiers[1:])


TOPOLOGIES = {
    "edge-cloud": _edge_cloud,
    "edge-edge-cloud": _edge_edge_cloud,
    "edge-regional-cloud": _edge_regional_cloud,
    "continuum-4": _continuum_4,
}


def get_topology(name: str) -> ClusterTopology:
    try:
        return TOPOLOGIES[name]()
    except KeyError:
        raise KeyError(f"unknown topology {name!r}; "
                       f"have {sorted(TOPOLOGIES)}") from None


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"  # bfloat16 for ZeRO-memory-tight cells


@dataclass(frozen=True)
class TrainConfig:
    model: str = "tiny-dense"
    batch_size: int = 8
    seq_len: int = 256
    steps: int = 200
    log_every: int = 10
    checkpoint_every: int = 50
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    seed: int = 0
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    sharding: ShardingConfig = field(default_factory=ShardingConfig)


# ---------------------------------------------------------------------------
# Roofline constants (TPU v5e, from the assignment)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RooflineConstants:
    peak_flops: float = 197e12  # bf16 FLOP/s per chip
    hbm_bw: float = 819e9  # bytes/s per chip
    ici_bw: float = 50e9  # bytes/s per link
    hbm_per_chip: float = 16e9  # v5e HBM capacity


ROOFLINE = RooflineConstants()
