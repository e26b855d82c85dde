"""N-tier live serving: the MoA-Off scheduler in front of real engines.
Counterpart of ``repro/serving/tiers.py``; engines are built on a device.

``ClusterServer`` is now a thin shell over the shared event-driven
:class:`~repro.serving.runtime.ClusterRuntime` driven by its
:class:`~repro.serving.runtime.LiveBackend` — the SAME lifecycle state
machine as the discrete-event ``ClusterSimulator``, executed on the
monotonic clock against one real ``TierEngine`` per tier. That buys the
live path everything that used to be sim-only fiction:

* **Executed partial offload** — an image routed off the fusion tier is
  genuinely encoded by the routed tier's engine and only its compact patch
  embeddings ship into the fusion prefill (previously the image was
  silently skipped and a latency adder charged).
* **Modeled WAN with queueing** — remote-routed payloads cross their tier's
  uplink through a real link station (parallel links, join before service)
  as elapsed wall time, not a post-hoc latency adder.
* **Streaming decode** — per-request TTFT and SLO (``on_time``) tracking via
  the engine's token stream, with EDF-ordered admission into engine slots.
* **Hedging and fault recovery** — ``hedge_after_s`` clones stragglers onto
  the least-loaded other tier (first finisher wins, loser cancelled) and
  ``fail_rate`` injects node faults recovered through engine
  ``snapshot()``/``restore()``.

``EdgeCloudServer`` is the original two-tier entry point, now a thin
wrapper building the legacy edge/cloud topology.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Union

import numpy as np
import torch

from repro_torch.config import (ClusterTopology, ResilienceConfig, ServingConfig,
                          SpecConfig, two_tier_topology)
from repro_torch.core.request import ModalityInput, Request
from repro_torch.core.scheduler import MoAOffScheduler
from repro_torch.data.tokenizer import ToyTokenizer
from repro_torch.serving.engine import TierEngine
from repro_torch.serving.faults import FaultPlan
from repro_torch.serving.pool import EnginePool, build_engine_pools  # noqa: F401
from repro_torch.serving.runtime import ClusterRuntime, LiveBackend


@dataclass
class ServedResult:
    rid: int
    tier: str
    routes: Dict[str, str]
    tokens: List[int]
    latency_s: float
    wan_s: float
    ttft_s: float = 0.0  # time to first streamed token (incl. WAN delay)
    on_time: bool = True  # finished within the request's SLO
    truncated: bool = False  # prompt clipped to the engine budget
    hedged: bool = False
    retries: int = 0
    migrated: bool = False  # KV cache moved across tiers mid-flight
    migration_bytes: float = 0.0  # slot-payload bytes shipped
    warm: str = ""  # "prefix" | "resume": admitted onto reused KV rows
    warm_tokens: float = 0.0  # cached tokens whose prefill was skipped
    failed: bool = False  # terminal: never completed
    fail_reason: str = ""  # "retries" | "shed" | "" (completed)
    degraded: bool = False  # served after re-routing off an open circuit


def build_cluster_engines(topology: ClusterTopology,
                          serving: ServingConfig,
                          dtype: str = "float32",
                          device: Union[str, torch.device] = "cuda",
                          full_width: bool = False
                          ) -> Dict[str, TierEngine]:
    """One ``TierEngine`` per topology tier on ``device`` (deterministic
    per-tier param seeds) — the canonical construction shared by the
    launcher and the tests. Models are the reduced configs, or with
    ``full_width`` the published ones (``get_config``)."""
    from repro_torch.configs import get_config, reduced_config  # no cycle
    from repro_torch.models import build_model

    engines = {}
    for i, tier in enumerate(topology.tiers):
        base = get_config if full_width else reduced_config
        cfg = base(tier.model).replace(dtype=dtype)
        model = build_model(cfg, device=device)
        engines[tier.name] = TierEngine(model, model.init(i), serving)
    return engines


def engines_device(engines) -> torch.device:
    """The device the first engine (or pool replica) of ``engines`` runs
    on: a process replica's is its ``ReplicaSpec.device``."""
    for eng in engines.values():
        if isinstance(eng, EnginePool):
            tr = eng.transports[0]
            eng = getattr(tr, "engine", None) or getattr(tr, "spec", None)
        dev = getattr(eng, "device", None)
        if dev is not None:
            return torch.device(dev)
    return torch.device("cuda")


def _default_topology(engine_names, bandwidth_bps: float,
                      rtt_s: float) -> ClusterTopology:
    """Topology inferred from engine names when none is given: a tier named
    "cloud" is remote behind the WAN, everything else is local. Hardware
    specs come from the canonical testbed pair in ``two_tier_topology``."""
    edge_spec, cloud_spec = two_tier_topology(
        bandwidth_bps=bandwidth_bps, rtt_s=rtt_s).tiers
    return ClusterTopology("inferred", tuple(
        dataclasses.replace(
            cloud_spec if name == "cloud" else edge_spec, name=name)
        for name in engine_names))


class ClusterServer:
    """MoA-Off control plane in front of live engines — one ``TierEngine``
    per tier, or a replicated :class:`~repro.serving.pool.EnginePool`
    (built by :func:`~repro.serving.pool.build_engine_pools`); ``engines``
    values may be either, and bare engines wrap into single-replica pools
    with bit-identical behavior."""

    def __init__(self, engines: Dict[str, TierEngine],
                 topology: Optional[ClusterTopology] = None,
                 scheduler: Optional[MoAOffScheduler] = None,
                 bandwidth_bps: Optional[float] = None, rtt_s: float = 0.02,
                 hedge_after_s: float = 0.0, fail_rate: float = 0.0,
                 seed: int = 0, migrate: bool = False,
                 migrate_threshold: int = 0, hedge_in_service: bool = False,
                 snapshot_every: int = 4, sessions: bool = False,
                 session_move_threshold: int = 0,
                 fault_plan: Optional[FaultPlan] = None,
                 resilience: Optional[ResilienceConfig] = None,
                 spec: Optional[SpecConfig] = None,
                 audit: bool = False):
        # legacy-shim: a plan carrying only a Bernoulli rate compiles back
        # into the scalar knob, through the same rng stream as ever
        if fault_plan is not None and fail_rate == 0.0:
            fail_rate = fault_plan.fail_rate
        supplied = dict(engines)
        self.topology = topology or _default_topology(
            supplied, bandwidth_bps if bandwidth_bps is not None
            else 300e6, rtt_s)
        missing = set(self.topology.names) - set(supplied)
        if missing:
            raise ValueError(f"no engine for topology tiers {sorted(missing)}")
        from repro_torch.core.baselines import make_policy

        # the image-statistics kernel runs where the engines run; CPU
        # engines score with its plain version
        self.scheduler = scheduler or MoAOffScheduler(
            policy=make_policy("moa-off", topology=self.topology),
            use_kernel=engines_device(supplied).type == "cuda")
        self.tok = ToyTokenizer()
        self.backend = LiveBackend(supplied, self.topology,
                                   fail_rate=fail_rate, seed=seed,
                                   snapshot_every=snapshot_every)
        # pool view (always) and the single-replica back-compat engine view
        # (tests/benches read counters off ``server.engines``)
        self.pools = self.backend.pools
        self.engines = self.backend.engines
        self.runtime = ClusterRuntime(
            self.topology, self.scheduler,
            getattr(self.scheduler.policy, "name", "moa-off"), self.backend,
            hedge_after_s=hedge_after_s,
            observed_bandwidth_bps=bandwidth_bps, migrate=migrate,
            migrate_threshold=migrate_threshold,
            hedge_in_service=hedge_in_service, sessions=sessions,
            session_move_threshold=session_move_threshold,
            resilience=resilience, fault_plan=fault_plan, spec=spec,
            audit=audit)
        self._rid = 0
        self._reported = 0  # outcomes already converted to ServedResults
        self.results: List[ServedResult] = []
        # per-session transcript: prompt ids of the last submitted turn and
        # its rid (the next turn extends prompt + that turn's generation)
        self._session_hist: Dict[str, Dict] = {}

    def _engine(self, tier: str) -> TierEngine:
        return self.engines[tier]

    # ------------------------------------------------------------------

    def build_request(self, text: str, image: Optional[np.ndarray] = None,
                      max_new: int = 16, slo_s: float = 5.0,
                      delay_s: float = 0.0,
                      complexity: Optional[Dict[str, float]] = None,
                      session: Optional[str] = None,
                      prompt_ids: Optional[np.ndarray] = None) -> Request:
        """Tokenize/score-prepare one request without submitting it (the
        sim-vs-live parity test feeds the same payloads to both backends).
        ``complexity`` pins per-modality scores, bypassing the scorer.
        ``prompt_ids`` bypasses tokenization (multi-turn histories already
        carry generated token ids)."""
        rid = self._rid
        self._rid += 1
        mods: Dict[str, ModalityInput] = {}
        if image is not None:
            mods["image"] = ModalityInput("image", data=image,
                                          size_bytes=image.size // 2)
        if prompt_ids is not None:
            arr = np.asarray(prompt_ids, np.int32)
            if text:
                arr = np.concatenate(
                    [arr, np.asarray(self.tok.encode(text), np.int32)])
        else:
            arr = np.asarray(self.tok.encode(text), np.int32)
        mods["text"] = ModalityInput(
            "text", data=arr, size_bytes=len(arr) * 4,
            meta={"tokens": len(arr),
                  "entities": int(self.tok.is_entity(arr).sum()),
                  "sentences": max(1, int(self.tok.is_sentence_end(arr).sum()))})
        if complexity:
            for name, c in complexity.items():
                if name in mods:
                    mods[name].complexity = float(c)
        return Request(rid=rid, arrival_s=time.monotonic() + delay_s,
                       modalities=mods, decode_tokens=max_new, slo_s=slo_s,
                       session=session)

    def submit(self, text: str, image: Optional[np.ndarray] = None,
               max_new: int = 16, slo_s: float = 5.0,
               delay_s: float = 0.0,
               complexity: Optional[Dict[str, float]] = None) -> int:
        """Queue one request; ``delay_s`` paces its arrival into the future
        (the runtime processes it when the monotonic clock reaches it), so a
        caller can model an arrival process instead of a closed batch."""
        req = self.build_request(text, image, max_new=max_new, slo_s=slo_s,
                                 delay_s=delay_s, complexity=complexity)
        return self.submit_request(req)

    def submit_request(self, req: Request) -> int:
        self.runtime.submit(req)
        return req.rid

    # -- multi-turn sessions -------------------------------------------------

    def build_turn(self, sid: str, text: str,
                   image: Optional[np.ndarray] = None, max_new: int = 16,
                   slo_s: float = 5.0, delay_s: float = 0.0,
                   complexity: Optional[Dict[str, float]] = None) -> Request:
        """One chat turn of session ``sid``: the prompt is the FULL
        conversation so far — previous turns' prompts and generated tokens
        — plus the new user text, so the engine's parked state (or prefix
        store) makes it a suffix-only prefill. Requires the previous turn
        to have completed (its generation is part of the history)."""
        st = self._session_hist.setdefault(
            sid, {"ids": np.zeros((0,), np.int32), "last": None})
        if st["last"] is not None:
            rec = self.runtime.records.get(st["last"])
            gen = rec.tokens if rec is not None and rec.done else []
            if gen:
                st["ids"] = np.concatenate(
                    [st["ids"], np.asarray(gen, np.int32)])
        req = self.build_request(text, image=image, max_new=max_new,
                                 slo_s=slo_s, delay_s=delay_s,
                                 complexity=complexity, session=sid,
                                 prompt_ids=st["ids"])
        st["ids"] = np.asarray(req.modalities["text"].data, np.int32)
        st["last"] = req.rid
        return req

    def submit_turn(self, sid: str, text: str,
                    image: Optional[np.ndarray] = None, max_new: int = 16,
                    slo_s: float = 5.0, delay_s: float = 0.0,
                    complexity: Optional[Dict[str, float]] = None) -> int:
        return self.submit_request(self.build_turn(
            sid, text, image=image, max_new=max_new, slo_s=slo_s,
            delay_s=delay_s, complexity=complexity))

    # ------------------------------------------------------------------

    def run(self, timeout_s: float = 300.0) -> List[ServedResult]:
        """Drive the runtime until every submitted request resolves — a
        completion OR a terminal failed/shed Outcome — or ``timeout_s`` of
        wall clock elapses; on timeout the results gathered so far are
        returned (partial results under a permanent fault, not a hang)."""
        self.runtime.run(max_wall_s=timeout_s)
        outcomes = self.runtime.outcomes
        for out in outcomes[self._reported:]:
            rec = self.runtime.records[out.rid]
            self.results.append(ServedResult(
                rid=out.rid, tier=out.served_tier, routes=out.routes,
                tokens=list(rec.tokens), latency_s=out.latency_s,
                wan_s=rec.wan_s, ttft_s=out.ttft_s, on_time=out.on_time,
                truncated=out.truncated, hedged=out.hedged,
                retries=out.retries, migrated=out.migrated,
                migration_bytes=out.migration_bytes, warm=out.warm,
                warm_tokens=out.warm_tokens, failed=out.failed,
                fail_reason=out.fail_reason, degraded=out.degraded))
        self._reported = len(outcomes)
        return self.results

    def close(self) -> None:
        """Shut down replica transports (joins/terminates process workers;
        a no-op for purely local pools)."""
        for pool in self.pools.values():
            pool.close()


class EdgeCloudServer(ClusterServer):
    """Two-tier live serving (the paper's testbed) over ClusterServer."""

    def __init__(self, edge_engine: TierEngine, cloud_engine: TierEngine,
                 scheduler: Optional[MoAOffScheduler] = None,
                 bandwidth_bps: float = 300e6, rtt_s: float = 0.02,
                 hedge_after_s: float = 0.0, fail_rate: float = 0.0):
        topo = two_tier_topology(bandwidth_bps=bandwidth_bps, rtt_s=rtt_s)
        super().__init__({"edge": edge_engine, "cloud": cloud_engine},
                         topology=topo, scheduler=scheduler,
                         bandwidth_bps=bandwidth_bps, rtt_s=rtt_s,
                         hedge_after_s=hedge_after_s, fail_rate=fail_rate)
        self.edge = edge_engine
        self.cloud = cloud_engine
