"""One event-driven cluster runtime behind the simulator AND the live server.

``ClusterRuntime`` owns the request lifecycle the paper's control plane
schedules (§3.2): arrival → score/route → per-remote-tier WAN transfer →
remote modality encode → fusion enqueue → service/streaming decode →
complete, plus the hedge / retry / failure edges. It is parameterized by an
:class:`ExecutionBackend`, which decides what "executing" a stage means:

* :class:`AnalyticBackend` — a virtual clock and the analytic cost model:
  service times come from ``serving.cost_model`` over the real ModelConfigs,
  stations are FIFO multi-server queues, failures are sampled.
  ``ClusterSimulator`` is a thin shell over this backend and reproduces the
  pre-refactor metric keys and values exactly.
* :class:`LiveBackend` — the monotonic clock and one real ``TierEngine``
  per tier: partial offload is *executed* (an image routed off-fusion is
  encoded by the routed tier's engine and its compact embeddings ship to
  the fusion tier's prefill extras), decode streams tokens with per-request
  TTFT/SLO tracking and EDF-ordered admission, and hedging / fault recovery
  (engine ``snapshot()``/``restore()``) run against live engines.
  ``ClusterServer`` is a thin shell over this backend.

Both backends share the WAN link model (per-remote-tier uplink stations,
parallel transfers joined before service) and emit the same canonical
lifecycle trace per request (``RequestRecord.events``), which the
sim-vs-live parity test compares timing-aside.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
import weakref
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Protocol, Tuple

import numpy as np

from repro_torch import tracing
from repro_torch.config import (ClusterTopology, ModelConfig, ResilienceConfig,
                          ServingConfig, SpecConfig, TierSpec)
from repro_torch.core.request import Job, Outcome, Request, RequestRecord
from repro_torch.core.scheduler import MoAOffScheduler
from repro_torch.serving import cost_model as cm
from repro_torch.serving.engine import MigrationError, SlotPayload, _weak_hook
from repro_torch.serving.faults import FaultPlan, WireChaos
from repro_torch.serving.health import HealthMonitor, retry_backoff_s
from repro_torch.serving.prefix import (ParkedSession, PrefixStore, SessionStore,
                                  extras_fingerprint, prefix_buckets)


@dataclass(order=True)
class Event:
    t: float
    seq: int
    kind: str = field(compare=False)
    payload: dict = field(compare=False, default_factory=dict)


class Station:
    """FIFO multi-server station with failure injection + utilization stats."""

    def __init__(self, name: str, servers: int, fail_rate: float = 0.0):
        self.name = name
        self.servers = servers
        self.busy = 0
        self.queue: List = []
        self.fail_rate = fail_rate
        self.busy_time = 0.0
        self._last_t = 0.0
        self.flops = 0.0
        self.mem_byte_s = 0.0

    def utilization_update(self, t: float):
        self.busy_time += self.busy / max(self.servers, 1) * (t - self._last_t)
        self._last_t = t

    # a station "at capacity" = all servers busy + ~3 queued per server;
    # ℓ = 0.8 (the Eq.5 gate) then corresponds to a ~2-deep queue
    QUEUE_TOLERANCE = 4

    @property
    def load(self) -> float:
        denom = max(self.servers, 1) * self.QUEUE_TOLERANCE
        return min(1.0, (self.busy + len(self.queue)) / denom)


class ExecutionBackend(Protocol):
    """What 'executing' a lifecycle stage means (virtual vs. real)."""

    #: True -> the runtime's clock jumps to each event's timestamp
    #: (discrete-event simulation); False -> events fire when the monotonic
    #: clock reaches them and ``advance`` drives real work in between.
    virtual_clock: bool
    #: scalar b fallback when the topology has no remote tier
    fallback_bandwidth_bps: float

    def bind(self, runtime: "ClusterRuntime") -> None: ...
    def handlers(self) -> Dict[str, Callable[[Event], None]]: ...
    def tier_loads(self) -> Dict[str, float]: ...
    def queue_depths(self) -> Dict[str, int]: ...
    def score_cost_s(self, policy_name: str) -> float: ...
    def embed_bytes(self, tier: str) -> float: ...
    def encode(self, t: float, job: Job) -> None: ...
    def enqueue(self, t: float, job: Job) -> None: ...
    def advance(self) -> bool: ...
    # -- cross-tier KV migration (the runtime decides WHEN, backends HOW) --
    def occupancy(self) -> Dict[str, int]: ...
    def can_migrate(self, src: str, dst: str) -> bool: ...
    def preempt_candidate(self, tier: str, t: float) -> Optional[Job]: ...
    def migrate_extract(self, t: float, donor: Job, carrier: Job, dst: str,
                        *, remove: bool = False) -> Optional[float]: ...
    def migrate_inject(self, t: float, carrier: Job) -> None: ...
    # -- sessions (sticky routing + parked-state moves) --
    def session_tier(self, sid: str) -> Optional[str]: ...
    def session_extract(self, t: float, job: Job, src: str
                        ) -> Optional[float]: ...
    def session_install(self, t: float, job: Job) -> None: ...
    def parked_sessions(self) -> Dict[str, int]: ...


class ClusterRuntime:
    """Backend-agnostic request lifecycle over a :class:`ClusterTopology`."""

    def __init__(self, topology: ClusterTopology, scheduler: MoAOffScheduler,
                 policy_name: str, backend, hedge_after_s: float = 0.0,
                 observed_bandwidth_bps: Optional[float] = None,
                 migrate: bool = False, migrate_threshold: int = 0,
                 hedge_in_service: bool = False, sessions: bool = False,
                 session_move_threshold: int = 0,
                 resilience: Optional[ResilienceConfig] = None,
                 fault_plan: Optional[FaultPlan] = None,
                 spec: Optional[SpecConfig] = None,
                 audit: bool = False):
        self.topology = topology
        self.scheduler = scheduler
        # cross-tier speculative decoding (draft-and-verify): validate the
        # pairing against the topology and share the config with the
        # scheduler (which stamps decisions) unless it brought its own
        if spec is not None:
            topology.tier(spec.draft_tier)
            topology.tier(spec.target_tier)
            if getattr(scheduler, "spec", None) is None:
                scheduler.spec = spec
        self.spec = spec
        self.policy_name = policy_name
        self.backend = backend
        self.hedge_after_s = hedge_after_s
        self.observed_bandwidth_bps = observed_bandwidth_bps
        # cross-tier KV migration: ``migrate`` turns the migrate edge on for
        # hedged clones and fault re-homing; ``migrate_threshold`` > 0
        # additionally preempt-migrates when a tier's occupancy crosses it
        # (and implies ``migrate``). Disabled, every code path is identical
        # to the pre-migration runtime (golden-locked).
        self.migrate_threshold = int(migrate_threshold)
        self.migrate = bool(migrate) or self.migrate_threshold > 0
        # hedge mid-decode stragglers too (speculative backup-task style).
        # Without migration the clone re-prefills from token 0 and races the
        # donor; with migration it receives the donor's cache rows instead —
        # the benchmark's "hedge path with vs without migration" comparison.
        self.hedge_in_service = bool(hedge_in_service) or self.migrate
        self.migrations = 0  # successful cross-tier slot migrations
        # multi-turn sessions: turns route sticky-by-default to the tier
        # holding the session's parked KV; ``session_move_threshold`` > 0
        # instead SHIPS the parked payload to the scheduler's preferred
        # compatible tier when the parked tier is that much busier
        # (occupancy difference), falling back to sticky/cold otherwise.
        self.sessions = bool(sessions)
        self.session_move_threshold = int(session_move_threshold)
        self.session_moves = 0
        # resilience layer: per-tier circuit breaker, retry backoff,
        # deadline shedding, transfer timeouts. The default (all off) makes
        # every path below byte-identical to the pre-resilience runtime.
        self.resilience = resilience or ResilienceConfig()
        self.plan = fault_plan
        # byzantine wire layer: built ONLY when the plan carries message
        # faults — otherwise every wire path below is untouched (legacy
        # byte-identical). ``wire_stats`` is the shared counter dict that
        # injection sites, delivery guards and backends all bump.
        self.wire_stats: Dict[str, int] = {}
        self.wire_chaos: Optional[WireChaos] = (
            WireChaos(fault_plan, stats=self.wire_stats)
            if fault_plan is not None and fault_plan.has_msg_faults
            else None)
        if audit:
            from repro_torch.serving.audit import InvariantAuditor
            self.auditor: Optional[InvariantAuditor] = InvariantAuditor(self)
        else:
            self.auditor = None
        self.health: Optional[HealthMonitor] = (
            HealthMonitor([t.name for t in topology.tiers], self.resilience)
            if self.resilience.health else None)
        # epoch anchor: fault plans are authored in seconds-since-first-
        # event so one plan drives the virtual AND the monotonic clock
        self.t0: Optional[float] = None
        self.run_deadline: Optional[float] = None  # current run()'s budget
        self.shed_count = 0  # deadline-shed requests (terminal)
        self.failed_count = 0  # retry-budget-exhausted requests (terminal)
        self.degraded_routes = 0  # requests re-routed off an open circuit
        self.rescued_sessions = 0  # parked sessions evacuated at quarantine
        self.specs: Dict[str, TierSpec] = {t.name: t for t in topology.tiers}
        self.links: Dict[str, Station] = {
            t.name: Station(f"link:{t.name}", 1)
            for t in topology.tiers if t.is_remote}
        self.events: List[Event] = []
        self._seq = itertools.count()
        self.records: Dict[int, RequestRecord] = {}
        self.outcomes: List[Outcome] = []
        self.t = 0.0
        self.handlers: Dict[str, Callable[[Event], None]] = {
            "arrival": self._on_arrival,
            "transfer_done": self._on_transfer_done,
            "hedge_check": self._on_hedge_check,
            "migrate_done": self._on_migrate_done,
            "session_done": self._on_session_done,
            "retry_enqueue": self._on_retry_enqueue,
            "transfer_timeout": self._on_transfer_timeout,
            "session_rescue_done": self._on_session_rescue_done,
        }
        backend.bind(self)
        self.handlers.update(backend.handlers())
        # through weak references: the table keeps neither its runtime nor
        # the backend alive (a dropped server frees its engines at once)
        self.handlers = {k: _weak_hook(fn) for k, fn in self.handlers.items()}

    # ------------------------------------------------------------------

    def _push(self, t: float, kind: str, **payload):
        heapq.heappush(self.events, Event(t, next(self._seq), kind, payload))

    def rel(self, t: float) -> float:
        """Epoch-relative time (seconds since the first processed event):
        the clock :class:`FaultPlan` windows and quarantine cool-downs are
        authored on, bridging virtual and monotonic backend clocks."""
        return t - self.t0 if self.t0 is not None else 0.0

    def submit(self, req: Request) -> None:
        """Schedule a request's arrival (``req.arrival_s`` is on the
        backend's clock: virtual seconds analytic, monotonic live)."""
        self._push(req.arrival_s, "arrival", request=req)

    # -- scheduler feedback ------------------------------------------------

    def _observe(self):
        remote = self.topology.remote_tiers
        # the scalar b of Eq. 5 is the edge<->cloud WAN: the anchor remote
        # tier's uplink unless the server pinned an observed value
        wan = self.observed_bandwidth_bps
        if wan is None:
            wan = (self.topology.default_remote.uplink_bps if remote
                   else self.backend.fallback_bandwidth_bps)
        kv_fn = getattr(self.backend, "kv_headroom", None)
        rep_fn = getattr(self.backend, "replica_loads", None)
        # in-flight + queued WAN transfers count toward the destination
        # tier's queue depth: they are committed near-future load, and
        # without them a bandwidth-saturated remote tier reads as idle —
        # the adaptive-tau controller would keep shedding into the full
        # link instead of pulling work back
        depths = dict(self.backend.queue_depths())
        for tname, link in self.links.items():
            backlog = link.busy + len(link.queue)
            if backlog:
                depths[tname] = depths.get(tname, 0) + backlog
        self.scheduler.observe(
            loads=self.backend.tier_loads(),
            bandwidth_bps=wan,
            bandwidths={t.name: t.uplink_bps for t in remote},
            queue_depths=depths,
            parked=(self.backend.parked_sessions()
                    if self.sessions else None),
            kv=kv_fn() if kv_fn is not None else None,
            replicas=rep_fn() if rep_fn is not None else None,
            health=(self.health.snapshot() if self.health is not None
                    else None))

    # -- lifecycle: arrival ------------------------------------------------

    def _on_arrival(self, ev: Event):
        req: Request = ev.payload["request"]
        rec = self.records.get(req.rid)
        if rec is None:
            rec = RequestRecord(rid=req.rid)
            self.records[req.rid] = rec
        rec.mark("arrival")
        self._observe()
        decision = self.scheduler.route(req)
        # score cost: the modality-aware module runs on the edge CPU/NPU —
        # orders of magnitude below model inference (§4.2.3). The analytic
        # backend charges it as a fixed sub-millisecond virtual cost; live,
        # the real scoring time just elapsed on the monotonic clock.
        score_cost = self.backend.score_cost_s(self.policy_name)
        fusion = self.topology.fusion_tier(decision.routes)
        # session affinity: a turn of a parked session serves WHERE the
        # parked KV lives (sticky-by-default) — unless the parked tier is
        # ``session_move_threshold`` occupancy deeper than the scheduler's
        # pick AND the payload can move (same model), in which case the
        # parked state ships to the preferred tier instead of the request
        # chasing it. Identical rule through both backends.
        sticky = move_src = None
        if self.sessions and req.session:
            parked_tier = self.backend.session_tier(req.session)
            if parked_tier is not None and parked_tier in self.specs:
                if (parked_tier != fusion and self.session_move_threshold > 0
                        and self.backend.can_migrate(parked_tier, fusion)):
                    occ = self.backend.occupancy()
                    if (occ.get(parked_tier, 0) - occ.get(fusion, 0)
                            >= self.session_move_threshold):
                        move_src = parked_tier
                        # the moved rows cover the whole history too: the
                        # turn serves entirely at the destination (same
                        # route override as the sticky branch below)
                        decision = dataclasses.replace(
                            decision,
                            routes={m: fusion for m in decision.routes},
                            reason=decision.reason + "+session-move")
                if move_src is None:
                    fusion = parked_tier
                    sticky = parked_tier
                    # the parked rows cover the WHOLE history (vision
                    # prefix included): the turn serves entirely on the
                    # parked tier, so the scheduler's per-modality picks
                    # are overridden too — otherwise phantom off-fusion
                    # encodes/WAN hops get charged for work that never
                    # happens, and the fusion-tier partial-offload
                    # discount would zero out prefill that IS paid here
                    decision = dataclasses.replace(
                        decision,
                        routes={m: parked_tier for m in decision.routes},
                        reason=decision.reason + "+sticky")
        # graceful degradation: when the serving tier's circuit is open the
        # whole request re-homes to the best available tier (the probe goes
        # through when the cool-down elapsed). Only the FUSION tier gates —
        # quarantined encode-side tiers are already steered around by the
        # health-aware policy, and gating here would leak probe slots.
        if self.health is not None and not self.health.admit(fusion,
                                                             self.rel(ev.t)):
            fb = self._fallback_tier(ev.t, exclude=fusion)
            if fb != fusion:
                fusion = fb
                sticky = move_src = None
                decision = dataclasses.replace(
                    decision, routes={m: fb for m in decision.routes},
                    reason=decision.reason + "+degraded")
                rec.degraded = True
                self.degraded_routes += 1
        rec.mark("routed", fusion)
        if rec.degraded:
            rec.mark("degraded", fusion)
        if sticky is not None:
            rec.mark("sticky", sticky)
        job = Job(request=req, decision=decision, fusion=fusion, tier=fusion,
                  t_start=ev.t, record=rec)
        # cross-tier speculative decoding: honor the scheduler's stamp only
        # when the fused generation still lands on the target tier (the
        # sticky/move/degraded overrides above may have re-homed it) and
        # the draft tier exists here
        sp = decision.speculate
        if (self.spec is not None and sp is not None and fusion == sp[1]
                and sp[0] in self.specs and sticky is None
                and move_src is None and not rec.degraded):
            job.payload["speculate"] = {"draft": sp[0], "target": sp[1],
                                        "k": int(sp[2]),
                                        "alpha": float(sp[3])}
        if move_src is not None:
            self._session_move(ev.t + score_cost, job, move_src)
        # partial offload (§3.2): modalities routed off the fusion tier are
        # encoded where they were routed — the runtime marks the stage, the
        # backend executes it (analytic: charge encode FLOPs to the routed
        # station; live: run the routed engine's frontend and stash the
        # embeddings for the fusion prefill)
        for name in sorted(req.modalities):
            routed = decision.routes.get(name, fusion)
            if routed != fusion:
                rec.mark(f"encode:{name}", routed)
        self.backend.encode(ev.t, job)
        # bytes that must cross a WAN: payloads of remote-routed modalities,
        # tallied per remote tier (their links transfer in parallel)
        remote_bytes: Dict[str, float] = {}
        for name, m in req.modalities.items():
            routed = decision.routes.get(name, fusion)
            if self.specs[routed].is_remote:
                remote_bytes[routed] = (remote_bytes.get(routed, 0.0)
                                        + m.size_bytes)
        if self.specs[fusion].is_remote:
            # the fusion tier's own link carries at minimum the text/prompt
            remote_bytes[fusion] = remote_bytes.get(fusion, 0.0) or 2048.0
            # embeddings of images encoded AWAY from a remote fusion tier
            # ride the fusion uplink too (they used to travel free): the
            # compact patch embeddings must reach the fusion prefill
            emb = sum(self.backend.embed_bytes(fusion)
                      for name, m in req.modalities.items()
                      if m.kind == "image"
                      and decision.routes.get(name, fusion) != fusion)
            remote_bytes[fusion] += emb
            spx = job.payload.get("speculate")
            if spx is not None:
                # draft token blocks ride the target's uplink — priced as
                # one arrival-time lump like the embed_bytes above (the
                # live backend ships the real bytes round by round over
                # the same link)
                remote_bytes[fusion] += cm.speculation_uplink_bytes(
                    req.decode_tokens, spx["k"], spx["alpha"])
        job.transfer_bytes = sum(remote_bytes.values())
        if remote_bytes:
            # each remote tier's payload crosses its OWN uplink; the links
            # run in parallel and service starts when the last one lands
            # (sorted for deterministic event order)
            for tname, nbytes in sorted(remote_bytes.items()):
                self._enqueue_link(ev.t + score_cost, tname, job, nbytes)
        if job.pending_transfers == 0:  # no links, no session move in flight
            self._enqueue_service(ev.t + score_cost, job)
        if self.hedge_after_s > 0:
            self._push(ev.t + self.hedge_after_s, "hedge_check", job=job)
        self._maybe_preempt(ev.t)

    # -- lifecycle: WAN links ----------------------------------------------

    def _link_seconds(self, tier: str, num_bytes: float,
                      t: Optional[float] = None) -> float:
        spec = self.specs[tier]
        sec = cm.transfer_seconds(num_bytes, spec.uplink_bps, spec.rtt_s)
        if self.plan is not None and t is not None:
            mult = self.plan.link_multiplier(tier, self.rel(t))
            if mult <= 0.0:
                return float("inf")  # partitioned: the transfer black-holes
            sec /= mult
        return sec

    def _link_dispatch(self, t: float, xfer: dict) -> None:
        """Start one transfer on its (already reserved) link server. A
        partitioned link (multiplier 0) never lands the transfer — only a
        configured transfer timeout releases the server then."""
        sec = self._link_seconds(xfer["tier"], xfer["bytes"], t)
        if sec != float("inf"):
            self._push(t + sec, "transfer_done", xfer=xfer)
        if self.resilience.transfer_timeout_s > 0:
            self._push(t + self.resilience.transfer_timeout_s,
                       "transfer_timeout", xfer=xfer)

    def _link_release(self, t: float, tier: str) -> None:
        """Free one link server and dispatch the next queued transfer."""
        link = self.links[tier]
        link.utilization_update(t)
        link.busy -= 1
        if link.queue:
            nxt = link.queue.pop(0)
            link.busy += 1
            self._link_dispatch(t, nxt)

    def _enqueue_link(self, t: float, tier: str, job: Job, num_bytes: float,
                      kind: str = "data"):
        """Queue one transfer (a job may hold several, one per remote tier
        its modalities route to); the job proceeds to service only once
        every pending transfer has landed. ``kind`` — "data" (modality
        payloads), "migrate" (slot payloads, resolving into an injection)
        or "session" (parked-session payloads, installed before service) —
        all ride the SAME link stations, queueing behind each other."""
        if kind == "data":
            job.record.mark("transfer", tier)
        xfer = {"job": job, "tier": tier, "bytes": num_bytes, "kind": kind}
        job.pending_transfers += 1
        link = self.links[tier]
        link.utilization_update(t)
        if link.busy < link.servers:
            link.busy += 1
            self._link_dispatch(t, xfer)
        else:
            link.queue.append(xfer)

    def _on_transfer_done(self, ev: Event):
        xfer = ev.payload["xfer"]
        if xfer.get("timed_out"):
            return  # the timeout already released the server and the job
        xfer["landed"] = True
        self._link_release(ev.t, xfer["tier"])
        job: Job = xfer["job"]
        job.pending_transfers -= 1
        if job.pending_transfers == 0:
            if job.payload.pop("xfer_dead", None):
                return  # a sibling timed out: the retry path owns the job
            if xfer["kind"] == "migrate":
                self._migrate_inject(ev.t, job)
            else:
                self._join_transfers(ev.t, job)

    def _on_transfer_timeout(self, ev: Event):
        """A WAN transfer exceeded the configured timeout (a slow or
        partitioned link): release the link server, count one failure
        against the tier's breaker, and recover per transfer kind — data
        payloads spend a retry, lost migration payloads fall back to a
        fresh prefill, lost session payloads cold-prefill."""
        xfer = ev.payload["xfer"]
        if xfer.get("landed") or xfer.get("timed_out"):
            return
        xfer["timed_out"] = True
        tier, job = xfer["tier"], xfer["job"]
        self._link_release(ev.t, tier)
        job.pending_transfers -= 1
        job.record.mark("timeout", tier)
        self._note_failure(ev.t, job, tier)
        kind = xfer["kind"]
        if kind == "migrate":
            job.payload.pop("migration_wire", None)
            job.payload.pop("migration_nbytes", None)
            job.payload.pop("cost_tier", None)  # reprice at the new tier
            donor = job.payload.pop("migration_donor", None)
            if job.record.done:
                return
            if donor is not None and not donor.record.done:
                return  # the donor still decodes: it wins the dead race
            if job.pending_transfers == 0:
                self._enqueue_service(ev.t, job)
            return
        if kind == "session":
            job.payload.pop("session_wire", None)
            job.payload.pop("session_parked", None)
            job.payload.pop("session_pending", None)
            if job.pending_transfers == 0 and not job.record.done:
                self._enqueue_service(ev.t, job)
            return
        # data: the modality payload never reached the remote tier — one
        # failed attempt; the shared failure path retries/re-routes/sheds
        if job.pending_transfers > 0:
            job.payload["xfer_dead"] = True
        self.handle_service_failure(ev.t, job, tier)

    def _join_transfers(self, t: float, job: Job) -> None:
        """All of a job's arrival-side transfers have landed: install any
        moved session payload so admission finds it, then enqueue."""
        if job.payload.pop("session_pending", None):
            self._wire_transfer_fault(t, f"session:{job.tier}", job,
                                      "session_wire")
            self.backend.session_install(t, job)
        self._enqueue_service(t, job)

    # -- byzantine wire faults on slot-payload transfers --------------------

    def _wire_transfer_fault(self, t: float, link: str, job: Job,
                             key: str) -> None:
        """Decide the fate of one landed slot-payload transfer on ``link``.

        Both draws are made unconditionally so the per-link counters (and
        hence every later decision) advance identically in the analytic
        and live backends. Live wires get their actual bytes flipped (the
        receiving CRC raises and the backend counts the detection); the
        analytic backend carries the same verdict as flags its mirror
        consumes. ``wire_tampered`` is popped by whoever detects it — if
        an injection ever succeeds with the flag still set, the backend
        records undetected corruption and the auditor flags the run."""
        wc = self.wire_chaos
        if wc is None:
            return
        rel = self.rel(t)
        corrupt = wc.decide("corrupt", link, rel)
        drop = wc.decide("msg_drop", link, rel)
        if corrupt:
            wire = job.payload.get(key)
            if isinstance(wire, (bytes, bytearray)):
                job.payload[key] = wc.tamper(bytes(wire), link)
            job.payload["wire_tampered"] = True
            wc.bump("corrupt_injected")
        if drop:
            job.payload.pop(key, None)
            job.payload["wire_dropped"] = True
            wc.bump("msgs_dropped")

    def _migrate_inject(self, t: float, carrier: Job) -> None:
        """Single choke point for landing a migration payload (link and
        local paths): byzantine wire faults apply here, then the backend
        injects (falling back to a fresh prefill on a detected fault)."""
        self._wire_transfer_fault(t, f"migrate:{carrier.tier}", carrier,
                                  "migration_wire")
        self.backend.migrate_inject(t, carrier)

    # -- lifecycle: service ------------------------------------------------

    def _enqueue_service(self, t: float, job: Job):
        # deadline-aware load shedding: refuse the FIRST enqueue of a
        # request already past its SLO (hedge clones and retries carry
        # ``t_enqueue`` and are decided on the retry path instead)
        if (self.resilience.shed and not job.record.done
                and "t_enqueue" not in job.payload
                and t >= job.request.arrival_s + job.request.slo_s):
            self.fail_request(t, job, job.tier, "shed")
            return
        job.record.mark("enqueue", job.tier)
        if "t_enqueue" not in job.payload:
            job.payload["t_enqueue"] = t
            job.record.wan_s = t - job.t_start
        self.backend.enqueue(t, job)

    # -- lifecycle: hedging ------------------------------------------------

    def _on_hedge_check(self, ev: Event):
        job: Job = ev.payload["job"]
        if job.record.done or job.hedged:
            return
        # by default only genuinely queued jobs are hedged — a job already
        # being served would pay a full second prefill elsewhere. With
        # ``hedge_in_service`` a mid-decode straggler is hedged too: its
        # clone re-prefills and races (speculative backup task), or — with
        # migration — receives the donor's prefilled slot instead.
        if job.in_service and not self.hedge_in_service:
            return
        others = [n for n in self.specs if n != job.tier]
        if not others:
            return
        loads = self.backend.tier_loads()
        if job.in_service:
            if job.record.migrated:
                return  # already moved once (e.g. preempted): no ping-pong
            cands = [n for n in others
                     if self.backend.can_migrate(job.tier, n)] \
                if self.migrate else []
            if cands:
                alt = min(cands, key=lambda n: (loads.get(n, 0.0), n))
                clone = job.clone(tier=alt)
                clone.hedged = True
                job.hedged = True
                job.record.mark("hedged", alt)
                if not self._try_migrate(ev.t, job, clone, alt):
                    # donor died between the decision and the extract: the
                    # clone falls back to a fresh prefill on that tier
                    self._enqueue_service(ev.t, clone)
                return
            if self.migrate:
                return  # no compatible tier to ship the slot to
        # duplicate to the least-loaded other tier; first copy wins
        alt = min(others, key=lambda n: (loads.get(n, 0.0), n))
        clone = job.clone(tier=alt)
        clone.hedged = True
        job.hedged = True
        job.record.mark("hedged", alt)
        self._enqueue_service(ev.t, clone)

    # -- lifecycle: cross-tier KV migration --------------------------------

    def _try_migrate(self, t: float, donor: Job, carrier: Job, dst: str, *,
                     remove: bool = False, pre: str = "") -> bool:
        """Extract ``donor``'s slot state and ship it to ``dst``, where
        ``carrier`` (the hedge clone, or ``donor`` itself when moving)
        resumes without a second prefill. The payload crosses the remote
        party's WAN link station (queueing like any transfer) or a LAN hop
        when both tiers are local. Returns False — with no state mutated —
        when the backend cannot extract (dead donor, incompatible tiers).

        Unlike a re-prefill hedge clone, an injected copy resumes from the
        donor's EXACT position, so the donor is redundant the moment the
        injection lands: the backend retires it then (the donor still wins
        if it finishes during the transport window; an injection that fails
        falls back to a re-prefill clone and the race survives)."""
        src = donor.tier
        nbytes = self.backend.migrate_extract(t, donor, carrier, dst,
                                              remove=remove)
        if nbytes is None:
            return False
        if carrier is not donor:
            carrier.payload["migration_donor"] = donor
        # migrated/migration_bytes/migrations are committed only when the
        # injection lands (commit_migration) — a transport that ends in the
        # re-prefill fallback must not report a migration
        carrier.payload["migration_nbytes"] = nbytes
        rec = carrier.record
        if pre:
            rec.mark(pre, src)
        carrier.tier = dst
        rec.mark("migrate", dst)
        spec_s, spec_d = self.specs[src], self.specs[dst]
        if spec_d.is_remote:
            self._enqueue_link(t, dst, carrier, nbytes, kind="migrate")
        elif spec_s.is_remote:
            self._enqueue_link(t, src, carrier, nbytes, kind="migrate")
        else:
            self._push(t + cm.migration_seconds(nbytes, spec_s, spec_d),
                       "migrate_done", job=carrier)
        return True

    def _on_migrate_done(self, ev: Event):
        self._migrate_inject(ev.t, ev.payload["job"])

    # -- lifecycle: session moves ------------------------------------------

    def _session_move(self, t: float, job: Job, src: str) -> None:
        """Ship a parked session payload from ``src`` to the job's serving
        tier ahead of the turn (the scheduler preferred a less-loaded
        compatible tier over sticking). Rides the same transport as KV
        migration; an extract that fails (payload evicted meanwhile) leaves
        the turn to a cold prefill."""
        nbytes = self.backend.session_extract(t, job, src)
        if nbytes is None:
            return
        dst = job.tier
        job.record.mark("session_move", dst)
        self.session_moves += 1
        job.payload["session_pending"] = True
        spec_s, spec_d = self.specs[src], self.specs[dst]
        if spec_d.is_remote:
            self._enqueue_link(t, dst, job, nbytes, kind="session")
        elif spec_s.is_remote:
            self._enqueue_link(t, src, job, nbytes, kind="session")
        else:
            job.pending_transfers += 1
            self._push(t + cm.migration_seconds(nbytes, spec_s, spec_d),
                       "session_done", job=job)

    def _on_session_done(self, ev: Event):
        job: Job = ev.payload["job"]
        job.pending_transfers -= 1
        if job.pending_transfers == 0:
            self._join_transfers(ev.t, job)

    def commit_migration(self, carrier: Job) -> None:
        """Called by the backend when an injection actually lands."""
        nbytes = carrier.payload.pop("migration_nbytes", 0.0)
        carrier.record.migrated = True
        carrier.record.migration_bytes += nbytes
        self.migrations += 1

    def _maybe_preempt(self, t: float):
        """Load-triggered preemption: when a tier's occupancy (in-service +
        queued requests) reaches ``migrate_threshold``, move the in-service
        request with the most remaining decode work to the least-occupied
        compatible tier — shipping its cache rows, not re-running its
        prefill. Checked at every arrival (when fresh load lands)."""
        if self.migrate_threshold <= 0:
            return
        occ = self.backend.occupancy()
        if not occ:
            return
        src = max(occ, key=lambda n: (occ[n], n))
        if occ[src] < self.migrate_threshold:
            return
        cands = [n for n in self.specs
                 if n != src and occ.get(n, 0) < occ[src]
                 and self.backend.can_migrate(src, n)]
        if not cands:
            return
        dst = min(cands, key=lambda n: (occ.get(n, 0), n))
        victim = self.backend.preempt_candidate(src, t)
        if victim is None:
            return
        self._try_migrate(t, victim, victim, dst, remove=True, pre="preempt")

    # -- lifecycle: completion ---------------------------------------------

    def finish(self, job: Job, tier: str, latency_s: float, *,
               correct: bool = True,
               tier_flops: Optional[Dict[str, float]] = None,
               tier_mem_bytes: Optional[Dict[str, float]] = None) -> Outcome:
        """Retire a request: exactly one Outcome per record (the caller must
        have won the ``record.done`` race before calling)."""
        req = job.request
        rec = job.record
        rec.mark("complete", tier)
        self.scheduler.observe(latency_s=latency_s)
        if rec.drafted_tokens > 0:
            # acceptance-rate feedback: the EWMA gates future speculation
            self.scheduler.observe(
                acceptance=rec.accepted_tokens / rec.drafted_tokens)
        if self.health is not None:
            self.health.record_success(tier)
        out = Outcome(
            rid=req.rid, latency_s=latency_s, routes=job.decision.routes,
            correct=correct, tier_flops=tier_flops or {},
            tier_mem_bytes=tier_mem_bytes or {},
            transfer_bytes=job.transfer_bytes, hedged=job.hedged,
            retries=job.retries, served_tier=tier, ttft_s=rec.ttft_s,
            on_time=latency_s <= req.slo_s, truncated=rec.truncated,
            migrated=rec.migrated, migration_bytes=rec.migration_bytes,
            warm=rec.warm, warm_tokens=rec.warm_tokens,
            degraded=rec.degraded, drafted_tokens=rec.drafted_tokens,
            accepted_tokens=rec.accepted_tokens)
        rec.outcome = out
        self.outcomes.append(out)
        return out

    # -- lifecycle: failure, degradation & shedding ------------------------

    def _fallback_tier(self, t: float, exclude: str = "") -> str:
        """Best tier to re-home degraded traffic onto: highest capability
        among tiers whose circuit admits traffic (local preferred at equal
        capability — degraded edge-only routing keeps serving, at the
        accuracy the weaker tier can deliver). Falls back to the full tier
        set when everything is quarantined, so routing never deadlocks."""
        pool = [s for n, s in self.specs.items() if n != exclude
                and (self.health is None
                     or self.health.available(n, self.rel(t)))]
        if not pool:
            pool = list(self.specs.values())
        return max(pool,
                   key=lambda s: (s.capability, not s.is_remote, s.name)).name

    def _note_failure(self, t: float, job: Job, tier: str) -> None:
        """Feed one failed attempt into the breaker; on the open transition
        mark the trace and evacuate the tier's parked sessions."""
        if self.health is None:
            return
        if self.health.record_failure(tier, self.rel(t)):
            if not job.record.done:
                job.record.mark("quarantine", tier)
            if self.resilience.rescue_sessions:
                self._rescue_sessions(t, tier)

    def handle_service_failure(self, t: float, job: Job, tier: str) -> None:
        """Shared post-fault path for BOTH backends: feed the breaker,
        spend one retry or fail terminally, re-route a retry whose tier's
        circuit is open, apply capped-exponential backoff, and shed retries
        that provably cannot meet the deadline."""
        job.in_service = False
        self._note_failure(t, job, tier)
        if job.record.done:
            return
        if job.retries >= self.backend.retry_limit(tier):
            self.fail_request(t, job, tier, "retries")
            return
        job.retries += 1
        job.record.mark("retry", tier)
        res = self.resilience
        if self.health is not None and \
                not self.health.admit(job.tier, self.rel(t)):
            # job.fusion stays put: the fallback tier has no embeddings
            # shipped for it, so the full prefill is priced/executed there
            fb = self._fallback_tier(t, exclude=job.tier)
            if fb != job.tier:
                job.tier = fb
                job.record.degraded = True
                self.degraded_routes += 1
                job.record.mark("degraded", fb)
        delay = 0.0
        if res.retry_backoff:
            delay = retry_backoff_s(res, job.request.rid, job.retries)
        if res.shed and t + delay >= (job.request.arrival_s
                                      + job.request.slo_s):
            self.fail_request(t, job, tier, "shed")
            return
        if delay > 0:
            self._push(t + delay, "retry_enqueue", job=job)
        else:
            self._enqueue_service(t, job)  # retry (possibly behind queue)

    def _on_retry_enqueue(self, ev: Event):
        job: Job = ev.payload["job"]
        if job.record.done:
            return  # a hedged twin finished during the backoff window
        self._enqueue_service(ev.t, job)

    def fail_request(self, t: float, job: Job, tier: str,
                     reason: str) -> None:
        """Terminal failure: exactly one failed Outcome per record (shed or
        retry-budget exhaustion), so callers always get an answer for every
        submitted request instead of a silent hang."""
        rec = job.record
        if rec.done:
            return
        rec.done = True
        rec.mark("shed" if reason == "shed" else "failed", tier)
        if reason == "shed":
            self.shed_count += 1
        else:
            self.failed_count += 1
        abandon = getattr(self.backend, "abandon", None)
        if abandon is not None:
            abandon(job)
        req = job.request
        out = Outcome(
            rid=req.rid, latency_s=t - req.arrival_s,
            routes=job.decision.routes, correct=False,
            transfer_bytes=job.transfer_bytes, hedged=job.hedged,
            retries=job.retries, served_tier=tier, ttft_s=rec.ttft_s,
            on_time=False, truncated=rec.truncated, migrated=rec.migrated,
            migration_bytes=rec.migration_bytes, warm=rec.warm,
            warm_tokens=rec.warm_tokens, failed=True, fail_reason=reason,
            degraded=rec.degraded)
        rec.outcome = out
        self.outcomes.append(out)

    def _rescue_sessions(self, t: float, src: str) -> None:
        """Quarantine transition on ``src``: ship its parked sessions to
        the least-occupied compatible available tier (same slot-payload
        transport as migration, one hop — not through the wedged link
        station) so later turns resume warm somewhere healthy."""
        ids_fn = getattr(self.backend, "parked_session_ids", None)
        if ids_fn is None:
            return
        sids = list(ids_fn(src))
        if not sids:
            return
        cands = [n for n in self.specs
                 if n != src and self.backend.can_migrate(src, n)
                 and (self.health is None
                      or self.health.available(n, self.rel(t)))]
        if not cands:
            return
        occ = self.backend.occupancy()
        dst = min(cands, key=lambda n: (occ.get(n, 0), n))
        spec_s, spec_d = self.specs[src], self.specs[dst]
        for sid in sids:
            out = self.backend.session_rescue_extract(t, sid, src)
            if out is None:
                continue
            nbytes, payload = out
            self._push(t + cm.migration_seconds(nbytes, spec_s, spec_d),
                       "session_rescue_done", sid=sid, dst=dst,
                       payload=payload)
            self.rescued_sessions += 1

    def _on_session_rescue_done(self, ev: Event):
        self.backend.session_rescue_install(
            ev.t, ev.payload["sid"], ev.payload["dst"],
            ev.payload["payload"])

    # -- event loop --------------------------------------------------------

    def _next_due(self) -> Optional[Event]:
        if not self.events:
            return None
        if not self.backend.virtual_clock and \
                self.events[0].t > time.monotonic():
            return None
        return heapq.heappop(self.events)

    def run(self, max_wall_s: Optional[float] = None) -> List[Outcome]:
        deadline = (time.monotonic() + max_wall_s
                    if max_wall_s is not None else None)
        # the live backend's idle wait clamps its sleep to this, so a
        # long event-driven doze can never overshoot the caller's budget
        self.run_deadline = deadline
        while True:
            if deadline is not None and time.monotonic() > deadline:
                break
            ev = self._next_due()
            if ev is not None:
                if self.t0 is None:
                    self.t0 = ev.t  # epoch anchor for plan/health clocks
                self.t = ev.t
                sp = tracing.begin("runtime.event")
                try:
                    self.handlers[ev.kind](ev)
                finally:
                    if sp:
                        tracing.end(sp, rid=_event_rid(ev), kind=ev.kind,
                                    due=ev.t)
                continue
            sp = tracing.begin("runtime.advance")
            try:
                busy = self.backend.advance()
            finally:
                tracing.end(sp)
            if not busy:
                break
        if self.auditor is not None:
            self.auditor.final_check()
        return self.outcomes


def _event_rid(ev: Event) -> Optional[int]:
    """The request an event's payload carries, if any."""
    req = ev.payload.get("request")
    if req is None:
        job = ev.payload.get("job")
        req = job.request if job is not None else None
    return req.rid if req is not None else None


# ---------------------------------------------------------------------------
# Analytic backend (virtual clock + cost model)
# ---------------------------------------------------------------------------


class AnalyticBackend:
    """Discrete-event execution: service times from the analytic cost model
    over the REAL model configs, FIFO multi-server stations per tier, fault
    injection via heartbeat-detected retries, accuracy sampled from the
    calibrated accuracy model."""

    virtual_clock = True

    def __init__(self, topology: ClusterTopology, acc_model, seed: int = 0,
                 fail_rate: float = 0.0,
                 fallback_bandwidth_bps: float = 300e6,
                 prefix_cache_mb: float = 0.0,
                 session_cache_mb: float = 64.0,
                 prefix_min_tokens: int = 16,
                 max_context_tokens: Optional[int] = None,
                 serving: Optional[ServingConfig] = None):
        from repro_torch.configs import get_config  # local import, no cycle

        # retry budget + heartbeat timeout, shared semantics with the live
        # engines (default ServingConfig keeps the historical detect=2.0)
        self.serving = serving or ServingConfig()
        self.acc = acc_model
        self.rng = np.random.default_rng(seed)
        self.fallback_bandwidth_bps = fallback_bandwidth_bps
        self.specs: Dict[str, TierSpec] = {t.name: t for t in topology.tiers}
        self.models: Dict[str, ModelConfig] = {
            t.name: get_config(t.model) for t in topology.tiers}
        self.stations: Dict[str, Station] = {
            t.name: Station(t.name, t.servers, fail_rate)
            for t in topology.tiers}
        self.encode_flops: Dict[str, float] = {}  # partial-offload side work
        self.active: Dict[str, List[Job]] = {t.name: [] for t in topology.tiers}
        self.fault_draws = 0  # fault-rng draws (one per service start)
        # prefix & session KV reuse: the SAME stores (and therefore the
        # same hit/miss decisions) the live engines run, holding virtual
        # sizes instead of cache rows. The prefix mirror engages only for
        # requests carrying real token ids (content decides a hit).
        self.prefix: Dict[str, PrefixStore] = {
            t.name: PrefixStore(prefix_cache_mb * 1e6,
                                min_prefix=prefix_min_tokens)
            for t in topology.tiers}
        self.parked: Dict[str, SessionStore] = {
            t.name: SessionStore(session_cache_mb * 1e6)
            for t in topology.tiers}
        self.prefix_hits = 0
        self.resumed_sessions = 0
        self.parks = 0
        # mirror of the live engines' cache capacity: a turn whose total
        # context would not fit a ``max_seq``-sized engine cold-prefills
        # there, so the analytic mirror must refuse the hit too. None (the
        # default) skips the check — set it to the engines' max_seq when
        # comparing decision traces against a live cluster.
        self.max_context_tokens = max_context_tokens
        self.rt: Optional[ClusterRuntime] = None

    def bind(self, runtime: ClusterRuntime) -> None:
        self.rt = runtime

    def handlers(self):
        return {"service_done": self._on_service_done,
                "service_failed": self._on_service_failed}

    # -- state the scheduler observes --------------------------------------

    def tier_loads(self) -> Dict[str, float]:
        return {name: st.load for name, st in self.stations.items()}

    def queue_depths(self) -> Dict[str, int]:
        return {name: st.busy + len(st.queue)
                for name, st in self.stations.items()}

    def occupancy(self) -> Dict[str, int]:
        # in-service + queued, the preemption trigger (same composition the
        # live backend reports: occupied slots + waiting)
        return self.queue_depths()

    def score_cost_s(self, policy_name: str) -> float:
        return 5e-4 if policy_name.startswith("moa-off") else 0.0

    def embed_bytes(self, tier: str) -> float:
        return cm.embedding_bytes(self.models[tier])

    # -- prefix & session KV reuse ------------------------------------------

    @staticmethod
    def _req_ids(req: Request) -> Optional[np.ndarray]:
        """Real prompt token ids when the workload carries them (the live
        parity workloads do); None keeps the prefix mirror out of play."""
        text = req.modalities.get("text")
        if text is None or text.data is None:
            return None
        return np.asarray(text.data)

    @staticmethod
    def _req_fp(req: Request) -> bytes:
        """Extras fingerprint over the raw image payloads — a different
        value than the engine's patch-embedding hash, but the same
        equivalence (same image <=> same fingerprint), which is all the
        hit/miss decision needs."""
        data = {n: m.data for n, m in req.modalities.items()
                if m.kind == "image" and m.data is not None}
        return extras_fingerprint(data)

    def _context_tokens(self, req: Request, tier: str) -> Tuple[int, int]:
        """(text, image) backbone tokens of a request on a tier's model."""
        mcfg = self.models[tier]
        text = image = 0
        for m in req.modalities.values():
            n = cm.modality_tokens(mcfg, m)
            if m.kind == "image":
                image += n
            else:
                text += n
        return text, image

    def session_tier(self, sid: str) -> Optional[str]:
        for tier, store in self.parked.items():
            if sid in store:
                return tier
        return None

    def session_extract(self, t: float, job: Job, src: str
                        ) -> Optional[float]:
        rec = self.parked[src].resume(job.request.session)
        if rec is None:
            return None
        job.payload["session_parked"] = rec
        return float(rec.nbytes)

    def session_install(self, t: float, job: Job) -> None:
        tampered = job.payload.pop("wire_tampered", False)
        dropped = job.payload.pop("wire_dropped", False)
        rec = job.payload.pop("session_parked", None)
        if rec is None or dropped:
            return  # lost on the wire: the turn cold-prefills
        if tampered:
            # the live twin's CRC rejects the payload at adopt: mirror the
            # detection and the cold-prefill recovery
            self.rt.wire_chaos.bump("corrupt_detected")
            return
        self.parked[job.tier].park(job.request.session, rec)

    def parked_sessions(self) -> Dict[str, int]:
        return {tier: len(store) for tier, store in self.parked.items()}

    def _warm_state(self, job: Job) -> Optional[Tuple[str, int]]:
        """(kind, cached_tokens) when this admission lands on reused rows —
        the mirror of ``TierEngine._warm_plan``: a parked session this turn
        extends wins over a stored prefix; either discounts the prefill to
        the suffix. The analytic session rule cannot compare generated
        token content (it never materializes tokens), so a turn counts as
        extending when its context strictly grew — live and analytic
        decisions agree for well-formed multi-turn histories."""
        req = job.request
        tier = job.tier
        text, image = self._context_tokens(req, tier)
        sid = req.session
        store = self.parked.get(tier)
        if (self.rt.sessions and sid and store is not None
                and store.enabled):
            rec = store.peek(sid)
            if rec is not None and rec.extras_fp == self._req_fp(req):
                cached = int(rec.meta.get("context", 0))
                fits = (self.max_context_tokens is None
                        or text + image + 1 < self.max_context_tokens)
                if text + image > cached and fits:
                    store.resume(sid)  # rows consumed by this turn
                    return ("resume", cached)
        pstore = self.prefix.get(tier)
        if pstore is not None and pstore.enabled:
            ids = self._req_ids(req)
            if ids is not None:
                e = pstore.lookup(ids, self._req_fp(req))
                if e is not None:
                    return ("prefix", len(e.tokens) + image)
        return None

    def _store_prefixes(self, job: Job) -> None:
        """Mirror of ``TierEngine._store_prefixes``: deposit this prompt's
        prefixes (virtual sizes) at bucket-aligned lengths — exact length
        only for the point-in-time state families."""
        tier = job.tier
        pstore = self.prefix.get(tier)
        if pstore is None or not pstore.enabled:
            return
        ids = self._req_ids(job.request)
        if ids is None:
            return
        fp = self._req_fp(job.request)
        mcfg = self.models[tier]
        _, image = self._context_tokens(job.request, tier)
        sliceable = mcfg.family in ("dense", "vlm", "moe")
        lengths = (prefix_buckets(len(ids), pstore.min_prefix)
                   if sliceable else [len(ids)])
        for n in lengths:
            if n < pstore.min_prefix or pstore.contains(ids[:n], fp):
                continue
            pstore.insert(ids[:n], fp,
                          cm.slot_payload_bytes(mcfg, n + image),
                          sliceable=sliceable)

    def _maybe_park(self, job: Job) -> None:
        """Park a completing session turn: remember how much context its
        virtual cache rows cover and what it would cost to ship them."""
        req = job.request
        store = self.parked.get(job.tier)
        if not (self.rt.sessions and req.session and store is not None
                and store.enabled):
            return
        text, image = self._context_tokens(req, job.tier)
        # the rows cover prompt + generated minus the final sampled token
        context = text + image + max(req.decode_tokens - 1, 0)
        nbytes = cm.slot_payload_bytes(self.models[job.tier], context)
        ids = self._req_ids(req)
        ok = store.park(req.session, ParkedSession(
            tokens=(np.zeros(0, np.int32) if ids is None else ids),
            extras_fp=self._req_fp(req), nbytes=float(nbytes),
            meta={"context": context}))
        if ok:
            self.parks += 1
            job.record.mark("park", job.tier)

    # -- cross-tier KV migration --------------------------------------------

    def can_migrate(self, src: str, dst: str) -> bool:
        """KV rows only make sense between tiers serving the SAME model."""
        return (src != dst and src in self.models and dst in self.models
                and self.models[src].name == self.models[dst].name)

    def preempt_candidate(self, tier: str, t: float) -> Optional[Job]:
        """In-service job with the most remaining service time (never one
        already hedged or previously migrated)."""
        best, best_key = None, None
        for job in self.active.get(tier, ()):
            if job.record.done or job.record.migrated or job.hedged:
                continue
            rem = job.payload["t_serve"] + job.payload["service_s"] - t
            if rem <= 0:
                continue
            key = (rem, -job.request.rid)
            if best is None or key > best_key:
                best, best_key = job, key
        return best

    def migrate_extract(self, t: float, donor: Job, carrier: Job, dst: str,
                        *, remove: bool = False) -> Optional[float]:
        """Virtual extract: size the payload from the donor's attended
        context and reprice the carrier as decode-remainder-only on ``dst``
        (the shipped rows replace the prefill AND the already-generated
        fraction of the decode)."""
        if not self.can_migrate(donor.tier, dst):
            return None
        p = donor.payload
        if "t_serve" not in p or p.get("cost_tier") != donor.tier:
            return None  # not in service here: nothing prefilled to ship
        total, pre = p["service_s"], p["service_prefill_s"]
        elapsed = max(0.0, t - p["t_serve"])
        if elapsed < pre:
            # still mid-prefill: there are no cache rows to ship yet (the
            # live engine can only extract an admitted, post-prefill slot)
            return None
        frac = min(1.0, max(0.0, (elapsed - pre) / max(total - pre, 1e-9)))
        req = donor.request
        ctx = int(p.get("service_context", 0.0)
                  + frac * req.decode_tokens)
        nbytes = cm.slot_payload_bytes(self.models[donor.tier], ctx)
        if remove:
            # preemption: release the donor's server NOW and drop its stale
            # completion event when it fires
            self._release_in_service(t, donor)
        # price the carrier's service on dst: decode remainder only
        tier0 = carrier.tier
        carrier.tier = dst
        c = self._service_request(carrier)
        carrier.tier = tier0
        scale = 1.0 - frac
        sec = c["decode_s"] * scale
        carrier.payload.update(
            service_s=sec, service_flops=c["decode_flops"] * scale,
            service_mem=c["mem_byte_s"] * sec / max(c["seconds"], 1e-9),
            service_prefill_s=0.0,
            service_decode_flops=c["decode_flops"] * scale,
            service_context=ctx, cost_tier=dst)
        carrier.in_service = False
        return float(nbytes)

    def _release_in_service(self, t: float, job: Job) -> None:
        """Free the server a genuinely-in-service job occupies, charge its
        tier for the work expended so far, and drop its stale completion
        event. A no-op when the job is no longer in service there (e.g. a
        fault retried it mid-transport), so the station's ``busy`` count
        can never be corrupted by a stale retirement."""
        if job not in self.active.get(job.tier, ()):
            return
        p = job.payload
        st = self.stations[job.tier]
        total, pre = p["service_s"], p["service_prefill_s"]
        elapsed = max(0.0, t - p["t_serve"])
        frac = min(1.0, max(0.0, (elapsed - pre) / max(total - pre, 1e-9)))
        # work done before moving: the WHOLE prefill (migration only happens
        # post-prefill) plus the decoded fraction
        dec_f = p.get("service_decode_flops", 0.0)
        st.flops += (p["service_flops"] - dec_f) + dec_f * frac
        st.mem_byte_s += p["service_mem"] * (
            (pre + frac * (total - pre)) / max(total, 1e-9))
        p.setdefault("preempted", []).append(job.tier)
        self._active_remove(job.tier, job)
        self._next_from_queue(t, st)

    def migrate_inject(self, t: float, carrier: Job) -> None:
        tampered = carrier.payload.pop("wire_tampered", False)
        dropped = carrier.payload.pop("wire_dropped", False)
        donor = carrier.payload.pop("migration_donor", None)
        if carrier.record.done:
            carrier.payload.pop("migration_nbytes", None)
            return  # the donor finished during the transport window
        if tampered or dropped:
            # mirror of the live CRC rejection / vanished payload: no
            # commit, the donor (if any) keeps racing, and the carrier
            # falls back to a fresh prefill priced at the new tier
            if tampered:
                self.rt.wire_chaos.bump("corrupt_detected")
            carrier.payload.pop("migration_nbytes", None)
            carrier.payload.pop("cost_tier", None)  # reprice: full prefill
            self.rt._enqueue_service(t, carrier)
            return
        if donor is not None and not donor.record.done:
            # the injected copy resumes at the donor's exact position on a
            # fresher tier: retire the donor now (release its server, drop
            # its stale completion) instead of decoding the tail twice
            self._release_in_service(t, donor)
        self.rt.commit_migration(carrier)
        self.rt._enqueue_service(t, carrier)

    # -- cost model ---------------------------------------------------------

    def _service_request(self, job: Job,
                         cached_tokens: int = 0) -> Dict[str, float]:
        """Phase-split cost of one fused inference on ``job.tier``.

        Pure function of (request, routes, serving tier) — all accounting
        side effects live with the callers, so it can be re-evaluated (e.g.
        for a hedged clone on another tier) without double charging. The
        prefill/decode split lets the migration path price a clone that
        receives the donor's cache rows (decode remainder only).
        ``cached_tokens`` > 0 is a warm admission: prefill pays the suffix
        only (see ``cost_model.request_phase_costs``).
        """
        req = job.request
        tier = job.tier
        mcfg = self.models[tier]
        tcfg = self.specs[tier]
        text_tokens = 0
        image_tokens = 0
        for m in req.modalities.values():
            n = cm.modality_tokens(mcfg, m)
            if m.kind == "image":
                image_tokens += n
            else:
                text_tokens += n
        # the paper's "severe latency tail typical of edge-only models
        # struggling with difficult samples": a weak model rambles /
        # re-derives on inputs beyond its capability knee -> decode length
        # grows with difficulty, scaled by how far the tier sits from
        # cloud-class capability (easy inputs run at full speed)
        decode_tokens = req.decode_tokens
        weakness = 1.0 - tcfg.capability
        if weakness > 0:
            decode_tokens = int(decode_tokens * (
                1.0 + 14.0 * weakness * max(0.0, req.difficulty - 0.45)))
        # PARTIAL offloading (§3.2): modalities routed to another tier of a
        # fused request are ENCODED there — only their compact embeddings
        # ride along, so the serving tier never spends prefill FLOPs on
        # them (images included; their encode is charged to the routed
        # tier's station by ``encode``). The discount belongs to the PLANNED
        # fusion tier only: a hedged clone running elsewhere has no
        # embeddings waiting for it and must prefill everything.
        if tier == job.fusion:
            routes = job.decision.routes
            off_text = off_img = 0
            for nm, m in req.modalities.items():
                if routes.get(nm, tier) == tier:
                    continue
                if m.kind == "image":
                    off_img += cm.modality_tokens(mcfg, m)
                else:
                    off_text += cm.modality_tokens(mcfg, m)
            text_tokens = max(0, text_tokens - off_text)
            image_tokens = max(0, image_tokens - off_img)
        costs = cm.request_phase_costs(mcfg, text_tokens, image_tokens,
                                       decode_tokens, tcfg,
                                       cached_tokens=cached_tokens)
        decode_s = costs["decode"].seconds
        decode_flops = costs["decode"].flops
        spec_stats: Dict[str, float] = {}
        spx = job.payload.get("speculate")
        if (spx is not None and tier == spx["target"]
                and spx["draft"] in self.models):
            # draft-and-verify decode: the draft tier proposes k-token
            # blocks, the target verifies each block in ONE chunked pass —
            # its memory-bound weight read amortizes over the accepted
            # prefix. Decode seconds come from the speculative schedule;
            # the target's flops become the (k+1)-wide verify chunks, and
            # the draft tier's work is stashed for _on_service_done to
            # charge to the DRAFT station (like off-fusion ``encode``).
            sc = cm.speculation_costs(
                mcfg, self.models[spx["draft"]], tcfg,
                self.specs[spx["draft"]], decode_tokens,
                text_tokens + image_tokens, spx["k"], spx["alpha"],
                rtt_s=self.specs[spx["draft"]].rtt_s or tcfg.rtt_s)
            decode_s = sc["seconds"]
            decode_flops = sc["verify_flops"]
            spec_stats = {"spec_rounds": sc["rounds"],
                          "spec_drafted": sc["drafted"],
                          "spec_accepted": sc["accepted"],
                          "spec_draft_flops": sc["draft_flops"],
                          "spec_draft_hbm": sc["draft_hbm_bytes"],
                          "spec_draft_s": sc["draft_s"]}
        sec = costs["prefill"].seconds + decode_s
        flops = costs["prefill"].flops + decode_flops
        kv = cm._kv_bytes_per_token(mcfg) * (text_tokens + image_tokens
                                             + req.decode_tokens)
        mem_byte_s = (cm.weights_bytes(mcfg) / max(tcfg.servers, 1)
                      + kv) * sec
        out = {"seconds": sec, "flops": flops, "mem_byte_s": mem_byte_s,
               "prefill_s": costs["prefill"].seconds,
               "decode_s": decode_s,
               "decode_flops": decode_flops,
               "context_tokens": float(text_tokens + image_tokens)}
        out.update(spec_stats)
        return out

    def encode(self, t: float, job: Job) -> None:
        """Partial-offload encode work: every modality routed away from the
        fusion tier is charged ONCE, at arrival, to the encoding tier's
        station counters (the virtual-clock analogue of running the remote
        encoder — images included, matching the live backend's executed
        off-fusion ``encode_image``)."""
        req, fusion = job.request, job.fusion
        routes = job.decision.routes
        for nm, m in req.modalities.items():
            routed = routes.get(nm, fusion)
            if routed == fusion:
                continue
            enc_cfg = self.models[routed]
            spec = self.specs[routed]
            toks = cm.modality_tokens(enc_cfg, m)
            if toks <= 0:
                continue
            enc = cm.request_phase_costs(enc_cfg, toks, 0, 0, spec)["prefill"]
            kv = cm._kv_bytes_per_token(enc_cfg) * toks
            mem = (cm.weights_bytes(enc_cfg) / max(spec.servers, 1)
                   + kv) * enc.seconds
            st = self.stations[routed]
            st.flops += enc.flops
            st.mem_byte_s += mem
            self.encode_flops[routed] = (self.encode_flops.get(routed, 0.0)
                                         + enc.flops)

    # -- stations ------------------------------------------------------------

    def enqueue(self, t: float, job: Job) -> None:
        st = self.stations[job.tier]
        st.utilization_update(t)
        if st.busy < st.servers:
            self.start_service(t, st, job)
        else:
            st.queue.append(job)

    def start_service(self, t: float, st: Station, job: Job) -> None:
        st.busy += 1
        job.in_service = True
        # compute once per (job, tier) and cache — _on_service_done reads
        # the cached values, so resources are charged exactly once. Warm
        # (prefix-hit / resumed-session) state is decided here, the
        # analytic analogue of engine admission: the service then pays
        # suffix-only prefill.
        if job.payload.get("cost_tier") != job.tier:
            warm = self._warm_state(job)
            cached = 0
            if warm is not None:
                kind, cached = warm
                rec = job.record
                rec.warm = kind
                rec.warm_tokens += cached
                rec.mark(kind, job.tier)
                if kind == "resume":
                    self.resumed_sessions += 1
                else:
                    self.prefix_hits += 1
            self._store_prefixes(job)
            c = self._service_request(job, cached_tokens=cached)
            job.payload.update(service_s=c["seconds"],
                               service_flops=c["flops"],
                               service_mem=c["mem_byte_s"],
                               service_prefill_s=c["prefill_s"],
                               service_decode_flops=c["decode_flops"],
                               service_context=c["context_tokens"],
                               cost_tier=job.tier)
            if "spec_rounds" in c:
                job.payload["spec_stats"] = {
                    k: c[k] for k in ("spec_rounds", "spec_drafted",
                                      "spec_accepted", "spec_draft_flops",
                                      "spec_draft_hbm", "spec_draft_s")}
            else:
                job.payload.pop("spec_stats", None)
        job.record.mark("serve", job.tier)
        if job.payload.get("spec_stats"):
            # one draft/verify triplet per request (not per round) so the
            # analytic trace matches the live co-drive's marks
            spx = job.payload["speculate"]
            job.record.mark("draft", spx["draft"])
            job.record.mark("verify", job.tier)
        job.payload["t_serve"] = t
        self.active[job.tier].append(job)
        sec = job.payload["service_s"]
        # fault injection: the node serving this job dies mid-flight and the
        # failure is detected after a heartbeat timeout, then retried. The
        # Bernoulli draw keeps its historical rng-stream position (one draw
        # per service start whenever fail_rate > 0); plan crash windows
        # stack on top without consuming the stream, and slow windows
        # stretch the service time of attempts started inside them.
        plan = self.rt.plan
        fail = False
        if st.fail_rate > 0:
            self.fault_draws += 1  # every service start re-draws the fault
            fail = self.rng.random() < st.fail_rate
        if plan is not None:
            if not fail and plan.crashed(st.name, self.rt.rel(t)):
                fail = True
            sec *= plan.slow_multiplier(st.name, self.rt.rel(t))
        if fail:
            detect = self.serving.heartbeat_timeout_s
            self.rt._push(t + detect, "service_failed", job=job,
                          station=st.name)
        else:
            self.rt._push(t + sec, "service_done", job=job, station=st.name)

    def _next_from_queue(self, t: float, st: Station):
        st.utilization_update(t)
        st.busy -= 1
        if st.queue:
            job = st.queue.pop(0)
            self.start_service(t, st, job)

    def _active_remove(self, tier: str, job: Job) -> None:
        try:
            self.active[tier].remove(job)
        except ValueError:
            pass

    @staticmethod
    def _drop_stale(job: Job, station: str) -> bool:
        """True if this completion event belongs to a service the job was
        migrated away from (one marker per release, so releasing twice —
        preempt then hedge-retire — drops exactly the two stale events)."""
        stale = job.payload.get("preempted", [])
        if station in stale:
            stale.remove(station)
            return True
        return False

    def _on_service_failed(self, ev: Event):
        st = self.stations[ev.payload["station"]]
        job: Job = ev.payload["job"]
        if self._drop_stale(job, ev.payload["station"]):
            # migrated away mid-service; this station was released at
            # migration time and the stale completion event is dropped
            return
        self._active_remove(ev.payload["station"], job)
        self._next_from_queue(ev.t, st)
        # shared retry/terminal-failure/degradation path (bounded by the
        # retry budget — a permanently dead tier can no longer livelock)
        self.rt.handle_service_failure(ev.t, job, ev.payload["station"])

    def _on_service_done(self, ev: Event):
        tier = ev.payload["station"]
        st = self.stations[tier]
        job: Job = ev.payload["job"]
        if self._drop_stale(job, tier):
            return  # stale event: see _on_service_failed
        self._active_remove(tier, job)
        self._next_from_queue(ev.t, st)
        if job.record.done:
            return  # the hedged twin finished first
        job.record.done = True
        self._maybe_park(job)
        req = job.request
        flops = job.payload["service_flops"]
        mem = job.payload["service_mem"]
        st.flops += flops
        st.mem_byte_s += mem
        sstats = job.payload.get("spec_stats")
        if sstats:
            # the verify loop is done: commit the acceptance ledger and
            # charge the draft tier's station for its proposal work
            # (counters only, like off-fusion ``encode`` — drafting rides
            # between the draft tier's own decode steps)
            spx = job.payload["speculate"]
            job.record.mark("accept", tier)
            job.record.drafted_tokens += int(sstats["spec_drafted"])
            job.record.accepted_tokens += int(sstats["spec_accepted"])
            dst = self.stations.get(spx["draft"])
            if dst is not None:
                dst.flops += sstats["spec_draft_flops"]
                dst.mem_byte_s += sstats["spec_draft_hbm"]
        spec = self.specs[tier]
        # return path: response tokens ride the serving tier's downlink
        down = cm.downlink_seconds(req.decode_tokens, spec)
        latency = ev.t + down - req.arrival_s
        on_time = latency <= req.slo_s
        correct = self.acc.sample(self.rng, req.difficulty, tier, on_time,
                                  capability=spec.capability)
        self.rt.finish(job, tier, latency, correct=correct,
                       tier_flops={tier: flops}, tier_mem_bytes={tier: mem})

    # -- resilience hooks ----------------------------------------------------

    def retry_limit(self, tier: str) -> int:
        return self.serving.retry_limit

    def abandon(self, job: Job) -> None:
        """Terminal failure: make sure the job can't consume a server
        later from some station queue (its in-service state was already
        released by the failure path)."""
        for st in self.stations.values():
            if job in st.queue:
                st.queue.remove(job)

    def parked_session_ids(self, tier: str) -> List[str]:
        store = self.parked.get(tier)
        return list(store.ids()) if store is not None else []

    def session_rescue_extract(self, t: float, sid: str, src: str):
        rec = self.parked[src].resume(sid)
        if rec is None:
            return None
        return float(rec.nbytes), rec

    def session_rescue_install(self, t: float, sid: str, dst: str,
                               payload) -> None:
        self.parked[dst].park(sid, payload)

    def advance(self) -> bool:
        return False  # purely event-driven: no events left means done

    def audit_residue(self) -> List[str]:
        """Invariant check at teardown: stations idle, nothing in service."""
        out: List[str] = []
        for name, st in sorted(self.stations.items()):
            if st.busy:
                out.append(f"station {name!r} left busy={st.busy}")
            if st.queue:
                out.append(f"station {name!r} left {len(st.queue)} queued")
        for tier, jobs in sorted(self.active.items()):
            if jobs:
                out.append(f"tier {tier!r} left {len(jobs)} jobs in service")
        return out


# ---------------------------------------------------------------------------
# Live backend (monotonic clock + real TierEngines)
# ---------------------------------------------------------------------------


class LiveBackend:
    """Real execution: a replicated :class:`EnginePool` per tier.

    * **Replicated tiers** — each tier runs ``TierSpec.servers`` engine
      replicas behind an :class:`~repro.serving.pool.EnginePool` (local
      in-process engines and/or spawn-process workers, selected by
      transport). New submissions go to the least-loaded replica with a
      deterministic tie-break; a parked session's turn sticks to the
      replica holding its KV, and a prompt extending a cached prefix
      prefers the replica that stored it. A bare ``TierEngine`` dict is
      accepted and wrapped in single-replica local pools — that path is
      bit-identical to the pre-pool backend.
    * **Executed partial offload** — an image routed off the fusion tier is
      encoded by the routed pool's least-loaded replica (in the fusion
      model's patch geometry so tokens are identical to a fusion-local
      encode) and only the compact embeddings reach the fusion prefill.
    * **Streaming + EDF admission** — requests carry an EDF deadline
      (arrival + SLO) into the engine's admission queue; tokens stream back
      through the engine's ``on_token`` hook (piped up from process
      replicas), giving true per-request TTFT.
    * **Hedging** — the runtime's shared hedge_check fires on the monotonic
      clock; a clone runs on the least-loaded other tier's pool and the
      loser is cancelled wherever its replica lives.
    * **Fault recovery** — with ``fail_rate`` > 0, an enqueued request may
      kill its replica: after the heartbeat timeout that ONE replica is
      rebuilt from its last ``snapshot()``, its restored in-flight slots
      re-home onto sibling replicas inside the tier (wire round trip, no
      WAN) before any cross-tier rescue, and the submissions since the
      snapshot are replayed (``record.done`` drops duplicates). A process
      replica that dies mid-flight surfaces its rids as *lost*; they
      re-enter through the shared failure path and land on a sibling.
    """

    virtual_clock = False
    fallback_bandwidth_bps = 300e6

    def __init__(self, engines: Dict, topology: ClusterTopology,
                 fail_rate: float = 0.0, seed: int = 0,
                 snapshot_every: int = 4):
        from repro_torch.serving.pool import EnginePool
        from repro_torch.serving.transport import LocalTransport

        # accept prebuilt pools or bare engines (wrapped 1:1)
        self.pools: Dict[str, EnginePool] = {
            t: (v if isinstance(v, EnginePool)
                else EnginePool(t, [LocalTransport(v)]))
            for t, v in engines.items()}
        # primary local engine per tier: the single-replica back-compat
        # surface (tests/benches read counters off ``server.engines``)
        self.engines = {t: p.primary_engine for t, p in self.pools.items()
                        if p.primary_engine is not None}
        self.topology = topology
        self.fail_rate = fail_rate
        self.rng = np.random.default_rng(seed)
        self.snapshot_every = snapshot_every
        self.restores = 0  # fault-recovery counter (tests/benchmarks)
        self.rehomes = 0  # intra-tier slot moves after a replica fault
        self.replica_losses = 0  # rids resubmitted off dead process replicas
        self.offloaded_encodes = 0  # images encoded away from their fusion
        self.fault_draws = 0  # fault-rng draws (one per engine submission)
        self._inflight: Dict[str, Dict[int, Job]] = {
            t: {} for t in self.pools}
        # snapshot/replay discipline is replica-granular: (tier, replica)
        self._snapshots: Dict[Tuple[str, int], dict] = {}
        self._since_snap: Dict[Tuple[str, int], List[Job]] = {}
        self._rt: Optional[weakref.ref] = None
        self._chaos = fail_rate > 0  # snapshot discipline needed?
        self._idle_cap_s = 0.0
        for tier, pool in self.pools.items():
            pool.wire_hooks(self._make_on_admit(tier),
                            self._make_on_token(tier),
                            self._make_on_warm(tier),
                            self._make_on_park(tier))

    @property
    def rt(self) -> Optional[ClusterRuntime]:
        # weak: the runtime holds its backend, not the other way round
        return self._rt() if self._rt is not None else None

    def bind(self, runtime: ClusterRuntime) -> None:
        self._rt = weakref.ref(runtime)
        # snapshot/replay discipline is paid whenever faults can consume
        # the snapshots: a Bernoulli fail_rate OR plan crash windows
        self._chaos = self.fail_rate > 0 or (
            runtime.plan is not None and runtime.plan.has_crashes)
        if self._chaos and not all(p.supports_restore
                                   for p in self.pools.values()):
            raise ValueError(
                "chaos injection (fail_rate / crash plans) needs host-side "
                "snapshot/restore; process-transport replicas have none — "
                "use the local transport")
        # idle-wait cap: 0 = purely event-driven (sleep until the next
        # scheduled event); a positive ServingConfig.idle_poll_s caps the
        # doze, and process replicas force a cap so their pipes keep
        # draining while the parent waits
        caps = [p.serving.idle_poll_s for p in self.pools.values()
                if p.serving.idle_poll_s > 0]
        cap = min(caps) if caps else 0.0
        if any(tr.kind == "process" for p in self.pools.values()
               for tr in p.transports):
            cap = min(cap, 0.02) if cap > 0 else 0.02
        self._idle_cap_s = cap
        # byzantine wires: arm every replica's event/finish stream with the
        # runtime's chaos + shared stats (local transports gain the
        # sequenced delivery guard; process guards get chaos attached)
        if runtime.wire_chaos is not None:
            now_rel = lambda: runtime.rel(time.monotonic())  # noqa: E731
            for pool in self.pools.values():
                pool.arm_wire_chaos(runtime.wire_chaos, runtime.wire_stats,
                                    now_rel)

    def handlers(self):
        return {"node_fault": self._on_node_fault}

    # -- state the scheduler observes --------------------------------------

    def tier_loads(self) -> Dict[str, float]:
        return {t: p.load() for t, p in self.pools.items()}

    def queue_depths(self) -> Dict[str, int]:
        return {t: p.queue_depth() for t, p in self.pools.items()}

    def kv_headroom(self) -> Dict[str, float]:
        """Per-tier free fraction of the KV pool (real page accounting on
        paged engines, slot-granular on dense ones; best replica)."""
        return {t: p.kv_headroom() for t, p in self.pools.items()}

    def replica_loads(self) -> Dict[str, List[float]]:
        """Raw per-replica occupancy vectors (scheduler-visible imbalance
        signal; the tier-level EWMA still smooths ``tier_loads``)."""
        return {t: p.replica_loads() for t, p in self.pools.items()}

    def score_cost_s(self, policy_name: str) -> float:
        return 0.0  # the real scoring time already elapsed on the clock

    def embed_bytes(self, tier: str) -> float:
        return cm.embedding_bytes(self.pools[tier].cfg)

    # -- engine callbacks ---------------------------------------------------

    def _make_on_admit(self, tier: str):
        backend = weakref.ref(self)  # an engine's hook keeps no backend alive

        def on_admit(rid: int, t: float):
            self = backend()
            if self is None:
                return
            job = self._inflight[tier].get(rid)
            if job is not None and not job.in_service:
                job.in_service = True
                job.record.mark("serve", tier)
        return on_admit

    def _make_on_warm(self, tier: str):
        backend = weakref.ref(self)  # an engine's hook keeps no backend alive

        def on_warm(rid: int, kind: str, cached: int, suffix: int):
            self = backend()
            if self is None:
                return
            job = self._inflight[tier].get(rid)
            if job is None or job.record.done:
                return
            rec = job.record
            rec.warm = kind
            rec.warm_tokens += cached
            rec.mark(kind, tier)
        return on_warm

    def _make_on_park(self, tier: str):
        backend = weakref.ref(self)  # an engine's hook keeps no backend alive

        def on_park(rid: int, sid: str):
            self = backend()
            if self is None:
                return
            job = self._inflight[tier].get(rid)
            if job is None or job.record.done:
                return  # a losing hedge twin parking late: rows kept, no mark
            job.record.mark("park", tier)
        return on_park

    def _make_on_token(self, tier: str):
        backend = weakref.ref(self)  # an engine's hook keeps no backend alive
        first_down = {t.name: cm.downlink_seconds(1, t)
                      for t in self.topology.tiers}

        def on_token(rid: int, token: int, t: float):
            self = backend()
            if self is None:
                return
            job = self._inflight[tier].get(rid)
            if job is None or job.record.done:
                return
            rec = job.record
            if rec.ttft_s <= 0.0:
                # first streamed token from ANY attempt; a remote tier's
                # token must ride the downlink back to the user
                rec.ttft_s = t - job.request.arrival_s + first_down[tier]
        return on_token

    # -- partial offload ----------------------------------------------------

    def encode(self, t: float, job: Job) -> None:
        req, fusion = job.request, job.fusion
        fus_cfg = self.pools[fusion].cfg
        if fus_cfg.frontend != "vision_stub":
            return
        for nm, m in req.modalities.items():
            if m.kind != "image" or m.data is None:
                continue
            routed = job.decision.routes.get(nm, fusion)
            if routed == fusion:
                continue  # fusion prefill encodes its own image at enqueue
            # EXECUTED partial offload: the routed tier's least-loaded
            # replica runs the frontend (device work, counted on that
            # engine) and only the compact embeddings travel to the
            # fusion prefill
            emb = self.pools[routed].encode_image(
                np.asarray(m.data), fus_cfg.num_patches,
                fus_cfg.frontend_dim)
            job.payload.setdefault("extras", {})["patches"] = emb
            self.offloaded_encodes += 1

    # -- admission ----------------------------------------------------------

    def _maybe_fault(self, t: float, job: Job, tier: str,
                     replica: int) -> None:
        """EVERY submission re-draws the fault rng — including retried
        ones, which reach this path again through the runtime (they used
        to be replayed engine-side without a draw, diverging from the
        analytic backend's per-retry draws), and migrated injections (the
        analytic carrier re-enters start_service and draws there). An
        attempt whose retry budget is already spent faults too: the shared
        failure path then emits the terminal failed Outcome, matching the
        analytic backend's bounded retries. Plan crash windows stack on
        the Bernoulli draw without consuming the rng stream. The fault
        kills ONE replica — the one this submission landed on."""
        pool = self.pools[tier]
        fail = False
        if self.fail_rate > 0:
            self.fault_draws += 1
            fail = self.rng.random() < self.fail_rate
        plan = self.rt.plan
        if not fail and plan is not None \
                and plan.crashed(tier, self.rt.rel(t)):
            fail = True
        if fail:
            # replica dies mid-flight; detected after heartbeat timeout
            self.rt._push(t + pool.serving.heartbeat_timeout_s,
                          "node_fault", job=job, tier=tier, replica=replica)

    def _choose_replica(self, pool, job: Job) -> int:
        """Replica pick for a fresh submission. Session affinity first (a
        parked turn resumes on the replica holding its KV), then prefix
        affinity, then least-loaded. Pre-encode extras approximate the
        final fingerprint — affinity is a routing hint, never correctness."""
        req = job.request
        ids = np.asarray(req.modalities["text"].data, np.int32)
        fp = extras_fingerprint(dict(job.payload.get("extras", {})))
        sid = req.session if self.rt.sessions else None
        return pool.choose(ids, fp, sid)

    def enqueue(self, t: float, job: Job) -> None:
        tier = job.tier
        pool = self.pools[tier]
        r = self._choose_replica(pool, job)
        if self._chaos:
            self._maybe_fault(t, job, tier, r)
            # snapshot cadence (a full host copy of the KV pool) is only
            # paid when faults can actually consume the snapshots; it is
            # replica-granular — a fault only rolls back the replica it hit
            key = (tier, r)
            if len(self._since_snap.get(key, ())) >= self.snapshot_every \
                    or key not in self._snapshots:
                self._snapshots[key] = pool.snapshot_replica(r)
                self._since_snap[key] = []
            self._since_snap[key].append(job)
        spx = job.payload.get("speculate")
        if spx is not None and tier == spx["target"]:
            if self._spec_drive(t, pool, r, tier, job, spx):
                return  # submitted (and possibly fully decoded) in-drive
        self._engine_submit(pool, r, tier, job)

    def _spec_drive(self, t: float, pool, r: int, tier: str, job: Job,
                    spx: Dict) -> bool:
        """Cross-tier speculative decoding, live: admit the request on the
        TARGET replica, shadow-admit its prompt on a DRAFT replica, then
        co-drive draft→verify rounds synchronously (``step()`` only runs
        from ``advance``/poll, so nothing races the slots). Every exit path
        degrades to the plain fused decode: the target slot is always left
        in a state ``step()`` can finish, and the draft shadow is always
        cancelled. Returns True once the job was submitted to the target —
        the caller must not submit it again."""
        from repro_torch.serving.transport import LocalTransport

        dpool = self.pools.get(spx["draft"])
        if dpool is None:
            return False
        # co-driving needs direct engine access on BOTH sides: the chosen
        # target replica if it is local, else any local one with room
        rt_idx = None
        if isinstance(pool.transports[r], LocalTransport):
            rt_idx = r
        else:
            for i, tr in enumerate(pool.transports):
                if isinstance(tr, LocalTransport) and tr.alive \
                        and tr.free_slots() > 0:
                    rt_idx = i
                    break
        rd_idx = None
        for i, tr in enumerate(dpool.transports):
            if isinstance(tr, LocalTransport) and tr.alive \
                    and tr.free_slots() > 0:
                rd_idx = i
                break
        if rt_idx is None or rd_idx is None:
            return False  # process-only replicas / no room: plain decode
        teng = pool.transports[rt_idx].engine
        deng = dpool.transports[rd_idx].engine
        req = job.request
        rid = req.rid
        self._engine_submit(pool, rt_idx, tier, job)
        teng._admit()
        slot_t = teng.spec_slot(rid)
        if slot_t is None:
            # queued behind a full engine (or finished straight out of
            # prefill): the normal step()/harvest path takes over
            return True
        k = int(spx["k"])
        ids, extras, _ = self._prepare_prompt(dpool.transports[rd_idx], job)
        slot_d = deng.spec_admit_quiet(rid, ids,
                                       max_new=req.decode_tokens + k + 2,
                                       extras=extras)
        if slot_d is None:
            return True  # no draft shadow: plain fused decode
        # the draft continues from the target's ACTUAL first token
        deng.spec_set_pending(rid, teng.slots[slot_t].generated[-1])
        job.record.mark("draft", spx["draft"])
        teng.spec_begin(rid)
        drafted = accepted = 0
        wc = self.rt.wire_chaos
        draft_link = f"draft:{spx['draft']}"
        try:
            while True:
                d = deng.spec_draft(rid, k)
                if d is None or len(d) == 0:
                    break  # draft out of room: target finishes plainly
                if wc is not None:
                    # the draft block crosses a wire to the verifier: frame
                    # it through the checksummed transport format so a
                    # corrupted block is detected (never verified against
                    # garbage) and the round falls back to plain decode
                    from repro_torch.serving.transport import (TransportError,
                                                         msg_from_bytes,
                                                         msg_to_bytes)
                    frame = msg_to_bytes("draft", np.asarray(d))
                    if wc.decide("corrupt", draft_link,
                                 self.rt.rel(time.monotonic())):
                        frame = wc.tamper(frame, draft_link)
                        wc.bump("corrupt_injected")
                    try:
                        _, d = msg_from_bytes(frame)
                    except TransportError:
                        wc.bump("corrupt_detected")
                        break  # lost round: target finishes plainly
                res = teng.spec_verify(rid, d)
                if res is None:
                    break
                drafted += res["drafted"]
                accepted += res["accepted"]
                if res["finished"]:
                    break
                if not deng.spec_sync(rid, res["committed"]):
                    break  # draft cache exhausted mid-request
        finally:
            # the shadow never outlives the drive, and a surviving target
            # slot gets its full-budget page reservation back for step()
            deng.cancel(rid)
            if teng.spec_slot(rid) is not None:
                teng.spec_release(rid)
        job.record.mark("verify", tier)
        job.record.mark("accept", tier)
        job.record.drafted_tokens += drafted
        job.record.accepted_tokens += accepted
        return True

    def _engine_submit(self, pool, r: int, tier: str, job: Job) -> None:
        req = job.request
        tokens, extras, truncated = self._prepare_prompt(
            pool.transports[r], job)
        job.record.truncated |= truncated
        self._inflight[tier][req.rid] = job
        pool.submit_to(r, req.rid, tokens, max_new=req.decode_tokens,
                       extras=extras, deadline=req.arrival_s + req.slo_s,
                       session=(req.session if self.rt.sessions else None))

    def _prepare_prompt(self, eng, job: Job):
        """Tokens + extras for one engine, against its REAL budget.

        The prompt budget is ``max_seq - max_new - vision_prefix`` — every
        token past it is dropped WITH a recorded ``truncated`` flag (the
        old server silently clipped at ``max_seq // 2``).

        An attempt whose extras hold no usable embeddings — the image was
        routed here, or this is a hedge clone with nothing shipped for it,
        or shipped patches are in another model's geometry — encodes the
        image on ITS OWN engine: like the analytic backend, a clone pays
        the full prefill; the image is never silently dropped.
        """
        req = job.request
        sp = tracing.begin("runtime.prepare_prompt", rid=req.rid)
        ids = np.asarray(req.modalities["text"].data, np.int32)
        extras = dict(job.payload.get("extras", {}))
        img = req.modalities.get("image")
        if (eng.cfg.frontend == "vision_stub" and img is not None
                and img.data is not None):
            want = (eng.cfg.num_patches, eng.cfg.frontend_dim)
            patches = extras.get("patches")
            if patches is None or tuple(np.shape(patches)) != want:
                extras["patches"] = eng.encode_image(np.asarray(img.data))
        prefix = eng.cfg.num_patches if ("patches" in extras) else 0
        budget = max(1, eng.serving.max_seq - req.decode_tokens - prefix)
        truncated = len(ids) > budget
        if truncated:
            ids = ids[:budget]
        tracing.end(sp)
        return ids, extras, truncated

    # -- fault recovery -----------------------------------------------------

    def _on_node_fault(self, ev: Event):
        job: Job = ev.payload["job"]
        tier = ev.payload["tier"]
        r = ev.payload.get("replica", 0)
        if job.record.done:
            # the request resolved during the detect window; the failure
            # still feeds the breaker (the node really died)
            self.rt.handle_service_failure(ev.t, job, tier)
            return
        pool = self.pools[tier]
        # rebuild the crashed REPLICA on a standby from its last snapshot,
        # then replay the submissions the snapshot doesn't contain —
        # sibling replicas never notice
        pool.restore_replica(r, self._snapshots[(tier, r)])
        self.restores += 1
        moved: set = set()
        if pool.n_alive > 1:
            # first line of defense is INSIDE the tier: ship the restored
            # in-flight slots to sibling replicas over the wire format —
            # same model, no WAN hop, and the (likely unhealthy) standby
            # sheds its decode load
            for rid in pool.slot_rids_on(r):
                j2 = self._inflight[tier].get(rid)
                if j2 is None or j2 is job or j2.record.done \
                        or j2.record.migrated:
                    continue
                dst = pool.move_slot(rid, r)
                if dst is None:
                    break  # no sibling has a free slot: stop probing
                if dst == -1:
                    # extracted but nobody could take it: cold resubmit
                    # on the least-loaded survivor
                    self._replay(pool, pool.least_loaded(skip=r), tier, j2)
                    moved.add(rid)
                    continue
                self.rehomes += 1
                j2.record.mark("rehome", tier)
                moved.add(rid)
        if self.rt.migrate:
            # anything still stuck on the standby may re-home ACROSS tiers:
            # prefilled cache rows ship instead of re-running; jobs with no
            # compatible target stay put
            for rid in pool.slot_rids_on(r):
                if rid in moved:
                    continue
                j2 = self._inflight[tier].get(rid)
                if j2 is None or j2 is job or j2.record.done \
                        or j2.record.migrated:
                    continue
                dst = self._rehome_target(tier)
                if dst is None:
                    break
                if self.rt._try_migrate(ev.t, j2, j2, dst, remove=True):
                    moved.add(rid)
        have = set(pool.rids_on(r)) | moved
        frid = job.request.rid
        replay, self._since_snap[(tier, r)] = \
            self._since_snap.get((tier, r), []), []
        for j in replay:
            rid = j.request.rid
            if j.record.done or rid in have or rid == frid:
                continue
            have.add(rid)
            self._replay(pool, r, tier, j)
        # the faulted submission itself re-enters through the runtime's
        # shared failure path: the fault rng is re-drawn for the retry
        # (draw-per-submission parity with the analytic backend) and the
        # retry budget / backoff / shed / terminal-failure rules apply
        # identically to both backends
        self.rt.handle_service_failure(ev.t, job, tier)

    def _replay(self, pool, r: int, tier: str, j: Job) -> None:
        """Replayed submissions re-register for the NEXT fault on their
        replica but never trigger a snapshot mid-recovery (matching the
        single-engine replay semantics)."""
        j.in_service = False
        self._since_snap.setdefault((tier, r), []).append(j)
        self._engine_submit(pool, r, tier, j)

    def _rehome_target(self, src: str) -> Optional[str]:
        cands = [n for n, p in self.pools.items()
                 if n != src and self.can_migrate(src, n)
                 and p.has_free_slot()]
        if not cands:
            return None
        occ = self.occupancy()
        return min(cands, key=lambda n: (occ.get(n, 0), n))

    # -- prefix & session KV reuse ------------------------------------------

    def session_tier(self, sid: str) -> Optional[str]:
        for tier, pool in self.pools.items():
            if pool.has_session(sid):
                return tier
        return None

    def session_extract(self, t: float, job: Job, src: str
                        ) -> Optional[float]:
        """Pop the REAL parked payload and ship its wire bytes (the same
        serialized form KV migration uses, prompt tokens included)."""
        pool = self.pools.get(src)
        if pool is None:
            return None
        wire = pool.resume_session_wire(job.request.session)
        if wire is None:
            return None
        job.payload["session_wire"] = wire
        return float(len(wire))

    def session_install(self, t: float, job: Job) -> None:
        tampered = job.payload.pop("wire_tampered", False)
        job.payload.pop("wire_dropped", False)
        wire = job.payload.pop("session_wire", None)
        if wire is None:
            return  # dropped on the wire: the turn cold-prefills
        ok = self.pools[job.tier].adopt_session_wire(job.request.session,
                                                     wire)
        if tampered:
            # adopt deserializes through the CRC'd wire format: a tampered
            # payload MUST have been rejected there
            wc = self.rt.wire_chaos
            wc.bump("corrupt_detected" if not ok else "corrupt_undetected")

    def parked_sessions(self) -> Dict[str, int]:
        return {tier: pool.session_count()
                for tier, pool in self.pools.items()}

    # -- cross-tier KV migration --------------------------------------------

    def can_migrate(self, src: str, dst: str) -> bool:
        ps, pd = self.pools.get(src), self.pools.get(dst)
        return (src != dst and ps is not None and pd is not None
                and ps.cfg.name == pd.cfg.name
                and ps.serving.max_seq == pd.serving.max_seq)

    def occupancy(self) -> Dict[str, int]:
        return {t: p.occupancy() for t, p in self.pools.items()}

    def preempt_candidate(self, tier: str, t: float) -> Optional[Job]:
        """Decoding slot with the most remaining token budget (never one
        already hedged or previously migrated)."""
        pool = self.pools[tier]
        best, best_key = None, None
        for rid, rem in pool.decode_slots():
            j = self._inflight[tier].get(rid)
            if j is None or j.record.done or j.record.migrated or j.hedged:
                continue
            if rem < 2:
                continue  # about to finish: not worth shipping
            key = (rem, -rid)
            if best is None or key > best_key:
                best, best_key = j, key
        return best

    def migrate_extract(self, t: float, donor: Job, carrier: Job, dst: str,
                        *, remove: bool = False) -> Optional[float]:
        """REAL extract: serialize the donor slot through the versioned wire
        format and ship the actual bytes (the same payload is deserialized
        and injected on arrival)."""
        pool = self.pools.get(donor.tier)
        if pool is None:
            return None
        wire = pool.extract_wire(donor.request.rid, remove=remove)
        if wire is None:
            return None
        carrier.payload["migration_wire"] = wire
        if remove:
            self._inflight[donor.tier].pop(donor.request.rid, None)
        return float(len(wire))

    def migrate_inject(self, t: float, carrier: Job) -> None:
        tampered = carrier.payload.pop("wire_tampered", False)
        carrier.payload.pop("wire_dropped", False)
        wire = carrier.payload.pop("migration_wire", None)
        donor = carrier.payload.pop("migration_donor", None)
        if carrier.record.done:
            carrier.payload.pop("migration_nbytes", None)
            return  # the donor finished during the transport window
        tier = carrier.tier
        pool = self.pools[tier]
        try:
            if wire is None:
                raise MigrationError("no payload shipped")
            r = pool.inject_wire(wire, carrier.request.rid)
        except MigrationError:
            # target full / died mid-transfer / CORRUPT WIRE (the payload
            # CRC raises before any engine state mutates): fall back to a
            # fresh prefill submission on the same tier (still completes,
            # just slower — the donor keeps decoding so the race survives,
            # and the request is NOT reported as migrated)
            if tampered:
                self.rt.wire_chaos.bump("corrupt_detected")
            carrier.payload.pop("migration_nbytes", None)
            self.rt._enqueue_service(t, carrier)
            return
        if tampered:
            # a flipped byte slid past every checksum: garbage KV is now
            # serving — exactly what the auditor must flag
            self.rt.wire_chaos.bump("corrupt_undetected")
        self.rt.commit_migration(carrier)
        if donor is not None:
            # the injected copy resumes at the donor's exact position on a
            # fresher tier: retire the donor instead of decoding the tail
            # twice (it already won if it finished during transport, above)
            dpool = self.pools.get(donor.tier)
            if dpool is not None:
                dpool.cancel(donor.request.rid)
            self._inflight[donor.tier].pop(donor.request.rid, None)
        rec = carrier.record
        rec.mark("enqueue", tier)
        rec.mark("serve", tier)
        carrier.in_service = True
        self._inflight[tier][carrier.request.rid] = carrier
        if self._chaos:
            # same fault/snapshot discipline as enqueue: make sure the
            # RECEIVING replica has a snapshot (taken AFTER the injection,
            # so recovery restores the migrated slot), register the carrier
            # for replay in case a later fault restores an older snapshot,
            # and let the migrated service fault like any other submission
            # (the analytic carrier draws in start_service too)
            key = (tier, r)
            if len(self._since_snap.get(key, ())) >= self.snapshot_every \
                    or key not in self._snapshots:
                self._snapshots[key] = pool.snapshot_replica(r)
                self._since_snap[key] = []
            self._since_snap[key].append(carrier)
            self._maybe_fault(t, carrier, tier, r)

    # -- driving the engines -----------------------------------------------

    def _harvest(self, tier: str, fins) -> None:
        if not fins:
            return
        now = time.monotonic()
        ws = self.rt.wire_stats
        for st in fins:
            job = self._inflight[tier].pop(st.rid, None)
            if job is None:
                continue  # cancelled attempt / replayed duplicate
            if job.record.done:
                # per-rid delivery ledger: a duplicated/hedged finish can
                # never double-serve or double-charge — the single ``done``
                # cell is the idempotence bit, counted so dup suppression
                # is machine-visible
                ws["dup_finishes_suppressed"] = \
                    ws.get("dup_finishes_suppressed", 0) + 1
                continue
            job.record.done = True
            job.record.tokens = list(st.generated)
            spec = self.rt.specs[tier]
            # return path: the full response rides the tier's downlink
            down = cm.downlink_seconds(len(st.generated), spec)
            latency = (st.t_done or now) + down - job.request.arrival_s
            self.rt.finish(job, tier, latency)
            sid = job.request.session if self.rt.sessions else None
            # cancel the losing hedge twin wherever it is — and drop any
            # session state a twin parked elsewhere before cancellation
            # (the winner's tier holds the authoritative park; a loser's
            # generated tokens are not this conversation's history)
            for other, pool2 in self.pools.items():
                if other == tier:
                    continue
                if st.rid in self._inflight[other]:
                    pool2.cancel(st.rid)
                    self._inflight[other].pop(st.rid, None)
                if sid is not None and pool2.has_session(sid):
                    pool2.drop_session(sid)

    def _on_replica_lost(self, tier: str, rid: int) -> None:
        """A process replica died with this rid in flight (no host-side
        snapshot exists for process workers). The request re-enters through
        the shared failure path and its retry lands cold on a surviving
        sibling via the usual least-loaded pick."""
        job = self._inflight[tier].pop(rid, None)
        if job is None or job.record.done:
            return
        self.replica_losses += 1
        self.rt.handle_service_failure(time.monotonic(), job, tier)

    # -- resilience hooks ----------------------------------------------------

    def retry_limit(self, tier: str) -> int:
        return self.pools[tier].serving.retry_limit

    def abandon(self, job: Job) -> None:
        """Terminal failure: cancel every replica copy of the request and
        drop it from the in-flight maps, so ``advance`` can drain (a
        permanently faulting submission used to livelock the server)."""
        rid = job.request.rid
        for tier, pool in self.pools.items():
            if rid in self._inflight[tier]:
                pool.cancel(rid)
                self._inflight[tier].pop(rid, None)

    def parked_session_ids(self, tier: str) -> List[str]:
        pool = self.pools.get(tier)
        return pool.session_ids() if pool is not None else []

    def session_rescue_extract(self, t: float, sid: str, src: str):
        pool = self.pools.get(src)
        if pool is None:
            return None
        wire = pool.resume_session_wire(sid)
        if wire is None:
            return None
        return float(len(wire)), wire

    def session_rescue_install(self, t: float, sid: str, dst: str,
                               wire) -> None:
        self.pools[dst].adopt_session_wire(sid, wire)

    def audit_residue(self) -> List[str]:
        """Invariant check at teardown: no in-flight requests, no owned
        rids, clean delivery ledgers, every local engine quiescent (slots
        free, queue empty) and its paged KV pool conserving pages."""
        from repro_torch.serving.transport import LocalTransport

        out: List[str] = []
        for tier in sorted(self.pools):
            pool = self.pools[tier]
            stuck = sorted(self._inflight[tier])
            if stuck:
                out.append(f"{tier}: rids {stuck} still in flight")
            if pool._owner:
                out.append(f"{tier}: pool still owns rids "
                           f"{sorted(pool._owner)}")
            out.extend(pool.delivery_audit())
            for i, tr in enumerate(pool.transports):
                if not isinstance(tr, LocalTransport) or not tr.alive:
                    continue
                eng = tr.engine
                busy = [s.rid for s in eng.slots if s is not None]
                if busy:
                    out.append(f"{tier}/{i}: leaked engine slots for rids "
                               f"{busy}")
                if eng.waiting:
                    out.append(f"{tier}/{i}: {len(eng.waiting)} requests "
                               f"stuck in the admission queue")
                if eng.pool is not None:
                    try:
                        eng.pool.check()  # free XOR referenced, per page
                    except AssertionError as e:
                        out.append(f"{tier}/{i}: page pool conservation "
                                   f"violated: {e}")
        return out

    def advance(self) -> bool:
        plan = self.rt.plan
        if plan is not None and self.rt.t0 is not None:
            # slow-node windows: throttle the replicas' step cadence while
            # the window is open (the live analogue of the analytic
            # backend's stretched service times)
            now_rel = self.rt.rel(time.monotonic())
            for tier, pool in self.pools.items():
                pool.set_throttle(plan.slow_multiplier(tier, now_rel))
        if self.rt.health is not None:
            for tier, pool in self.pools.items():
                self.rt.health.heartbeat(tier, bool(pool.heartbeat_ok()))
        any_active = False
        for tier, pool in self.pools.items():
            # local replicas step here; process replicas step in their own
            # workers and this only drains their pipes — tiers genuinely
            # overlap their device work
            fins, active, lost = pool.poll()
            any_active |= active
            self._harvest(tier, fins)
            for rid in lost:
                self._on_replica_lost(tier, rid)
        if any_active:
            return True
        if self.rt.events:
            # idle but future events are scheduled (paced arrivals, hedge
            # checks, fault detections): doze until the earliest one
            # instead of burning a core. ``idle_poll_s`` caps the doze
            # (0 = fully event-driven); process pipes keep a small cap so
            # token streams drain while the parent waits
            dt = self.rt.events[0].t - time.monotonic()
            if dt > 0:
                ddl = self.rt.run_deadline
                if ddl is not None:
                    dt = min(dt, max(ddl - time.monotonic(), 0.0))
                cap = self._idle_cap_s
                if dt > 0:
                    sp = tracing.begin("runtime.doze")
                    time.sleep(min(dt, cap) if cap > 0 else dt)
                    tracing.end(sp)
            return True
        return any(self._inflight[t] for t in self._inflight)
