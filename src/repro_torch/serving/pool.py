"""Replicated tier pools: ``TierSpec.servers`` engine replicas behind one
tier-level façade.

An :class:`EnginePool` owns N replica transports (local in-process
engines and/or spawn-process workers — see
:mod:`repro.serving.transport`) for one topology tier and gives the
``LiveBackend`` a single surface for:

* **tier-local load balancing** — new submissions go to the least-loaded
  replica by (occupancy, KV headroom) with a deterministic index
  tie-break, so replicated runs are reproducible;
* **replica-aware affinity** — a turn of a parked session is submitted to
  the replica holding its parked KV, and a prompt extending a replica's
  cached prefix prefers that replica (longest stored prefix wins);
* **replica-granular faults** — snapshots/restores target one replica,
  and a crashed replica's restored slots re-home onto sibling replicas
  *inside* the tier (LAN-free wire round trip through the versioned
  ``SlotPayload`` format) before any cross-tier rescue triggers;
* **aggregated observation** — tier load / queue depth / KV headroom /
  counters summed or maxed across replicas for the scheduler, plus the
  raw per-replica vectors (``replica_loads``) the state estimator now
  carries for imbalance visibility.

A pool of ONE local replica is a transparent pass-through: same calls,
same order, bit-identical to the pre-pool single-engine path.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import MigrationError
from repro_torch.serving.transport import (FinishedSeq, LocalTransport,
                                     ProcessTransport, ReplicaSpec,
                                     TransportError)

AGG_COUNTERS = ("decode_tokens", "prefill_tokens", "encode_tokens",
                "prefix_hits", "prefix_hit_tokens", "resumed_sessions",
                "resumed_tokens", "parks", "drafted_tokens",
                "accepted_tokens", "spec_rounds")


class EnginePool:
    """N replica transports serving ONE topology tier."""

    def __init__(self, name: str, transports: List):
        if not transports:
            raise ValueError(f"pool {name!r} needs at least one replica")
        self.name = name
        self.transports = list(transports)
        self._owner: Dict[int, int] = {}  # rid -> replica index

    # -- shape --------------------------------------------------------------

    def __len__(self) -> int:
        return len(self.transports)

    @property
    def n_alive(self) -> int:
        return sum(tr.alive for tr in self.transports)

    @property
    def cfg(self):
        return self.transports[0].cfg

    @property
    def serving(self):
        return self.transports[0].serving

    @property
    def primary_engine(self):
        """First local replica's engine (None for all-process pools) —
        kept for single-replica back-compat (``server.engines``)."""
        for tr in self.transports:
            if isinstance(tr, LocalTransport):
                return tr.engine
        return None

    @property
    def supports_restore(self) -> bool:
        return all(tr.supports_restore for tr in self.transports)

    def wire_hooks(self, on_admit, on_token, on_warm, on_park) -> None:
        for tr in self.transports:
            tr.wire_hooks(on_admit, on_token, on_warm, on_park)

    def arm_wire_chaos(self, chaos, stats, now_rel) -> None:
        """Arm byzantine message chaos on every replica's event/finish
        stream (link ``events:<tier>/<i>``). Local transports gain the
        sequenced delivery guard; process transports attach chaos to the
        guard they always run."""
        for i, tr in enumerate(self.transports):
            tr.arm_delivery(chaos, stats, now_rel,
                            f"events:{self.name}/{i}")

    def delivery_audit(self) -> List[str]:
        """Invariant check: no replica guard holding frames or gaps."""
        out = []
        for i, tr in enumerate(self.transports):
            guard = getattr(tr, "_guard", None)
            if guard is not None:
                out.extend(guard.audit(f"{self.name}/{i}"))
        return out

    # -- observation --------------------------------------------------------

    def load(self) -> float:
        """Occupied-slot fraction across the pool (1.0 when fully busy)."""
        total = sum(tr.total_slots() for tr in self.transports)
        free = sum(tr.free_slots() for tr in self.transports if tr.alive)
        return 1.0 - free / max(total, 1)

    def replica_loads(self) -> List[float]:
        """Instantaneous per-replica occupied-slot fractions (dead = 1.0)."""
        out = []
        for tr in self.transports:
            total = max(tr.total_slots(), 1)
            free = tr.free_slots() if tr.alive else 0
            out.append(1.0 - free / total)
        return out

    def queue_depth(self) -> int:
        return sum(tr.queue_len() for tr in self.transports)

    def kv_headroom(self) -> float:
        """Best replica's free KV fraction: admission feasibility (a new
        request lands on ONE replica, the least-loaded one)."""
        return max((tr.kv_headroom() for tr in self.transports if tr.alive),
                   default=0.0)

    def occupancy(self) -> int:
        return sum(tr.occupancy() for tr in self.transports)

    def has_free_slot(self) -> bool:
        return any(tr.alive and tr.free_slots() > 0
                   for tr in self.transports)

    def counters(self) -> Dict[str, int]:
        agg = {k: 0 for k in AGG_COUNTERS}
        for tr in self.transports:
            for k, v in tr.counters().items():
                agg[k] = agg.get(k, 0) + int(v)
        return agg

    def __getattr__(self, name: str):
        # aggregated counter properties (pool.decode_tokens etc.) so the
        # launcher/benchmarks read pools like they read engines
        if name in AGG_COUNTERS:
            return self.counters()[name]
        raise AttributeError(name)

    def replica_stats(self) -> List[Dict]:
        """Per-replica utilization row (the launcher's stats line)."""
        out = []
        for i, tr in enumerate(self.transports):
            out.append({
                "replica": i, "kind": tr.kind, "alive": tr.alive,
                "active": tr.total_slots() - tr.free_slots()
                if tr.alive else 0,
                "slots": tr.total_slots(), "queue": tr.queue_len(),
                "kv_headroom": tr.kv_headroom(),
                "decode_tokens": tr.counters().get("decode_tokens", 0)})
        return out

    # -- replica selection --------------------------------------------------

    def _load_key(self, i: int) -> Tuple:
        tr = self.transports[i]
        # least-loaded: fewest queued+active first, most KV headroom
        # second, replica index as the deterministic tie-break
        return (tr.occupancy(), -tr.kv_headroom(), i)

    def _alive(self) -> List[int]:
        return [i for i, tr in enumerate(self.transports) if tr.alive]

    def least_loaded(self, skip: Optional[int] = None,
                     need_slot: bool = False) -> Optional[int]:
        cands = [i for i in self._alive() if i != skip
                 and (not need_slot or self.transports[i].free_slots() > 0)]
        return min(cands, key=self._load_key) if cands else None

    def session_replica(self, sid: str) -> Optional[int]:
        for i in self._alive():
            if self.transports[i].has_session(sid):
                return i
        return None

    def choose(self, tokens: Optional[np.ndarray], extras_fp: bytes,
               session: Optional[str] = None) -> int:
        """Replica for one new submission: parked-session home first, then
        longest cached prefix, then least-loaded (deterministic ties)."""
        if len(self.transports) == 1:
            return 0
        if session is not None:
            home = self.session_replica(session)
            if home is not None:
                return home
        if tokens is not None:
            best_hit, best_i = 0, None
            for i in self._alive():
                hit = self.transports[i].prefix_hit_len(tokens, extras_fp)
                if hit > best_hit or (hit == best_hit and hit > 0
                                      and best_i is not None
                                      and self._load_key(i)
                                      < self._load_key(best_i)):
                    best_hit, best_i = hit, i
            if best_i is not None:
                return best_i
        r = self.least_loaded()
        if r is None:
            raise TransportError(f"pool {self.name!r} has no live replica")
        return r

    # -- request plane ------------------------------------------------------

    def replica_of(self, rid: int) -> Optional[int]:
        return self._owner.get(rid)

    def submit_to(self, r: int, rid: int, tokens, max_new: int, extras,
                  deadline, session) -> None:
        self._owner[rid] = r
        self.transports[r].submit(rid, tokens, max_new, extras,
                                  deadline, session)

    def cancel(self, rid: int) -> None:
        r = self._owner.pop(rid, None)
        if r is not None:
            self.transports[r].cancel(rid)
        else:  # unknown home (e.g. replayed duplicate): sweep the pool
            for tr in self.transports:
                if tr.alive:
                    tr.cancel(rid)

    def poll(self) -> Tuple[List[FinishedSeq], bool, List[int]]:
        """Drive/drain every replica once; merged finished sequences,
        any-activity flag, and rids lost to dead process replicas."""
        fins: List[FinishedSeq] = []
        lost: List[int] = []
        active = False
        for tr in self.transports:
            # dead process replicas still drain their buffered finished
            # sequences and report their in-flight rids as lost
            f, a, l = tr.poll()
            fins.extend(f)
            lost.extend(l)
            active |= a
        for seq in fins:
            self._owner.pop(seq.rid, None)
        for rid in lost:
            self._owner.pop(rid, None)
        return fins, active, lost

    def set_throttle(self, mult: float) -> None:
        for tr in self.transports:
            if tr.alive:
                tr.set_throttle(mult)

    def heartbeat_ok(self) -> bool:
        """Tier heartbeat: ANY live replica responding keeps the tier
        routable (replica-granular loss is handled inside the pool)."""
        return any(tr.alive and tr.heartbeat_ok() for tr in self.transports)

    @property
    def healthy(self) -> bool:
        return any(tr.alive and tr.healthy for tr in self.transports)

    def close(self) -> None:
        for tr in self.transports:
            tr.close()

    # -- partial offload ----------------------------------------------------

    def encode_image(self, image, num_patches: int = 0,
                     frontend_dim: int = 0):
        r = self.least_loaded()
        if r is None:
            raise TransportError(f"pool {self.name!r} has no live replica")
        return self.transports[r].encode_image(image, num_patches,
                                               frontend_dim)

    # -- slot wire (cross-tier migration + intra-tier re-homing) ------------

    def extract_wire(self, rid: int, *, remove: bool = False
                     ) -> Optional[bytes]:
        r = self._owner.get(rid)
        if r is None or not self.transports[r].alive \
                or not self.transports[r].healthy:
            return None
        try:
            wire = self.transports[r].extract_wire(rid, remove=remove)
        except (MigrationError, TransportError):
            return None
        if remove:
            self._owner.pop(rid, None)
        return wire

    def inject_wire(self, wire: bytes, rid: int) -> int:
        """Inject a shipped slot into the least-loaded replica with a free
        slot; raises MigrationError when nothing can take it (the caller
        falls back to a fresh prefill, exactly like the single-engine
        path)."""
        r = self.least_loaded(need_slot=True)
        if r is None:
            raise MigrationError(f"pool {self.name!r}: no replica with a "
                                 f"free slot")
        try:
            self.transports[r].inject_wire(wire)
        except TransportError as e:
            raise MigrationError(str(e)) from e
        self._owner[rid] = r
        return r

    def move_slot(self, rid: int, src: int) -> Optional[int]:
        """Intra-tier re-home: ship ``rid``'s slot off replica ``src`` to a
        sibling through the standard wire. Returns the destination replica
        index, None when nothing moved (no capacity / extract failed — the
        slot is still on ``src``), or -1 when the slot was extracted but
        every inject failed (lost: the caller must resubmit it cold)."""
        dsts = sorted((i for i in self._alive()
                       if i != src and self.transports[i].free_slots() > 0),
                      key=self._load_key)
        if not dsts:
            return None
        try:
            wire = self.transports[src].extract_wire(rid, remove=True)
        except (MigrationError, TransportError):
            return None
        self._owner.pop(rid, None)
        for dst in dsts + [src]:  # last resort: back onto the source
            try:
                self.transports[dst].inject_wire(wire)
            except (MigrationError, TransportError):
                continue
            self._owner[rid] = dst
            return dst if dst != src else None
        return -1

    # -- fault discipline (replica-granular) --------------------------------

    def snapshot_replica(self, r: int) -> dict:
        return self.transports[r].snapshot()

    def restore_replica(self, r: int, snap: dict) -> None:
        tr = self.transports[r]
        tr.restore(snap)
        # ownership of the restored rids returns to r (slots moved away
        # since the snapshot keep their new home — their record.migrated
        # flag keeps them off the replay path)
        for rid in tr.rids():
            self._owner.setdefault(rid, r)

    def rids_on(self, r: int) -> List[int]:
        return self.transports[r].rids()

    def slot_rids_on(self, r: int) -> List[int]:
        return self.transports[r].slot_rids()

    # -- sessions ------------------------------------------------------------

    def has_session(self, sid: str) -> bool:
        return self.session_replica(sid) is not None

    def session_count(self) -> int:
        return sum(tr.session_count() for tr in self.transports if tr.alive)

    def session_ids(self) -> List[str]:
        out: List[str] = []
        for i in self._alive():
            out.extend(self.transports[i].session_ids())
        return out

    def resume_session_wire(self, sid: str) -> Optional[bytes]:
        r = self.session_replica(sid)
        if r is None:
            return None
        return self.transports[r].resume_session_wire(sid)

    def adopt_session_wire(self, sid: str, wire: bytes) -> bool:
        r = self.least_loaded()
        if r is None:
            return False
        return self.transports[r].adopt_session_wire(sid, wire)

    def drop_session(self, sid: str) -> None:
        r = self.session_replica(sid)
        if r is not None:
            self.transports[r].drop_session(sid)

    # -- preemption ----------------------------------------------------------

    def decode_slots(self) -> List[Tuple[int, int]]:
        """(rid, remaining) across local replicas, replica-major order (a
        single local replica reproduces the engine's slot order exactly)."""
        out: List[Tuple[int, int]] = []
        for tr in self.transports:
            if tr.alive:
                out.extend(tr.decode_slots())
        return out


def build_engine_pools(topology, serving, dtype: str = "float32",
                       replicas: Optional[Dict[str, int]] = None,
                       transport: str = "local",
                       serving_overrides: Optional[Dict[str, object]] = None,
                       device: str = "cuda",
                       ) -> Dict[str, EnginePool]:
    """One :class:`EnginePool` per topology tier.

    Replica counts default to each tier's ``TierSpec.servers`` (the
    topology's declared server count, finally instantiated); ``replicas``
    overrides per tier name. Local replicas of a tier share ONE model +
    params build (same ``PRNGKey(tier_index)`` seed as
    ``build_cluster_engines``), so replicated decoding is token-identical
    to the single-engine path at temp=0; process replicas rebuild the
    same params from the same seed in their worker.

    ``serving_overrides`` swaps the shared :class:`ServingConfig` per tier
    name — heterogeneous tiers rarely share slot budgets (an edge device
    admits fewer concurrent decodes than a cloud pod).

    Every replica runs on ``device`` (``cuda`` by default; raises when no
    card is present).
    """
    if transport not in ("local", "process"):
        raise ValueError(f"unknown transport {transport!r} "
                         f"(expected 'local' or 'process')")
    pools: Dict[str, EnginePool] = {}
    for i, tier in enumerate(topology.tiers):
        n = max(1, int((replicas or {}).get(tier.name, tier.servers)))
        sv = (serving_overrides or {}).get(tier.name, serving)
        if transport == "process":
            trs: List = [ProcessTransport(ReplicaSpec(
                model=tier.model, serving=sv, dtype=dtype,
                param_seed=i, name=f"{tier.name}/{r}", device=str(device)))
                for r in range(n)]
        else:
            from repro_torch.configs import reduced_config  # local: no cycle
            from repro_torch.models import build_model
            from repro_torch.serving.engine import TierEngine

            cfg = reduced_config(tier.model).replace(dtype=dtype)
            model = build_model(cfg, device=device)
            params = model.init(i)
            trs = [LocalTransport(TierEngine(model, params, sv))
                   for _ in range(n)]
        pools[tier.name] = EnginePool(tier.name, trs)
    return pools
