"""Replica transports: how an :class:`~repro.serving.pool.EnginePool`
talks to ONE ``TierEngine`` replica.

Two implementations behind the same duck-typed surface:

* :class:`LocalTransport` — the replica lives in this process and every
  call is a direct method call on the engine. With a single replica this
  is bit-identical to the pre-pool serving path (same call order, same
  engine hooks), which keeps it the parity/debug baseline.
* :class:`ProcessTransport` — the replica runs in a worker process
  (``multiprocessing`` *spawn* context: a forked child cannot use a CUDA
  context its parent created, so each worker opens its own). The worker
  rebuilds its engine deterministically from a :class:`ReplicaSpec` (same
  reduced model, same param seed as the in-process construction, on the
  spec's device, so temp=0 tokens are identical), free-runs
  ``step()`` while it has work, and streams admit/token/warm/park events,
  finished sequences and utilization stats back over a pipe. Synchronous
  operations (image encode, slot extract/inject, session ship) are
  tagged RPCs handled between worker steps; ``SlotPayload`` and parked
  sessions cross the pipe in the existing versioned migration wire
  format (``SlotPayload.to_bytes``).

Every pipe message is framed by :func:`msg_to_bytes`: a magic tag, the
transport wire version and a CRC32 of the pickled body, so a mismatched
peer fails loudly and a corrupted frame raises :class:`TransportError`
*before* any untrusted bytes reach ``pickle.loads`` — and a garbage
length prefix can never trigger a giant allocation (``max_frame_bytes``
caps both parsing and the pipe reads).

Event/finish streams are additionally *sequenced*: the sender stamps a
monotonic per-replica sequence number on every frame and keeps a bounded
outbox; the receiving :class:`DeliveryGuard` suppresses duplicates,
restores order, and heals gaps by replaying from the outbox (a resync) —
exactly-once delivery over a byzantine wire.
"""
from __future__ import annotations

import multiprocessing as mp
import pickle
import struct
import time
import zlib
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.config import ServingConfig
from repro_torch.serving.engine import MigrationError, SlotPayload

TRANSPORT_WIRE_VERSION = 2
_FRAME_MAGIC = b"MOAF"
_FRAME_HDR = struct.Struct("<HI")  # (version, crc32 of body)
# generous default: large enough for any slot payload the reduced models
# can produce, small enough that a garbage length can't OOM the host
DEFAULT_MAX_FRAME_BYTES = 256 * 1024 * 1024
# how many sequenced frames a sender keeps for gap replay
OUTBOX_DEPTH = 512

# event tuples streamed from a replica: ("admit", rid, t),
# ("token", rid, token, t), ("warm", rid, kind, cached, suffix),
# ("park", rid, sid)
EVENT_KINDS = ("admit", "token", "warm", "park")


class TransportError(RuntimeError):
    """A replica transport failed (dead worker, bad frame, RPC timeout)."""


@dataclass
class FinishedSeq:
    """Transport-neutral finished sequence (what ``_harvest`` consumes)."""
    rid: int
    generated: List[int]
    t_done: Optional[float]


def msg_to_bytes(kind: str, payload: Any) -> bytes:
    """Frame one transport message: magic + version + CRC32, then the
    pickled ``(kind, payload)`` body."""
    body = pickle.dumps((kind, payload), protocol=pickle.HIGHEST_PROTOCOL)
    return (_FRAME_MAGIC
            + _FRAME_HDR.pack(TRANSPORT_WIRE_VERSION, zlib.crc32(body))
            + body)


def msg_from_bytes(raw: bytes,
                   max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES
                   ) -> Tuple[str, Any]:
    """Parse + validate one frame; raises TransportError on any mismatch.

    Validation order matters: size cap, magic, version and CRC are all
    checked BEFORE the body reaches ``pickle.loads`` — corrupt or hostile
    bytes fail deterministically instead of crashing (or allocating) in
    the unpickler."""
    if len(raw) > max_frame_bytes:
        raise TransportError(
            f"oversized transport frame: {len(raw)} > {max_frame_bytes}")
    hdr_end = len(_FRAME_MAGIC) + _FRAME_HDR.size
    if len(raw) < hdr_end:
        raise TransportError(f"short transport frame: {len(raw)} bytes")
    if raw[:len(_FRAME_MAGIC)] != _FRAME_MAGIC:
        raise TransportError("bad transport frame magic")
    ver, crc = _FRAME_HDR.unpack(raw[len(_FRAME_MAGIC):hdr_end])
    if ver != TRANSPORT_WIRE_VERSION:
        raise TransportError(
            f"transport wire version {ver} != {TRANSPORT_WIRE_VERSION}")
    body = raw[hdr_end:]
    if zlib.crc32(body) != crc:
        raise TransportError("transport frame checksum mismatch")
    try:
        msg = pickle.loads(body)
    except Exception as e:  # truncated / corrupt frame
        raise TransportError(f"undecodable transport frame: {e}") from e
    if not isinstance(msg, tuple) or len(msg) != 2:
        raise TransportError(f"malformed transport frame: {type(msg)}")
    kind, payload = msg
    if not isinstance(kind, str):
        raise TransportError(f"malformed message kind: {kind!r}")
    return kind, payload


class DeliveryGuard:
    """Exactly-once, in-order receiver for one replica's sequenced
    event/finish stream — and the injection point for byzantine message
    chaos on that stream.

    The sender stamps a monotonic ``seq`` on every frame and keeps a
    bounded outbox. On receive: a seq at-or-below the ledger's high-water
    mark is a duplicate (suppressed); the next expected seq is delivered
    (plus any buffered successors); a gap buffers the frame and requests
    ONE resync, which replays the missing range from the sender's outbox
    through :meth:`redeliver` (chaos-exempt — a retransmission). If the
    gap outlives ``resync_patience`` heal sweeps it is abandoned: the
    ledger jumps forward so delivery stays live (the per-rid idempotence
    in ``_harvest`` keeps lost finishes recoverable).
    """

    def __init__(self, link: str, chaos=None,
                 stats: Optional[Dict[str, int]] = None,
                 now_rel: Optional[Callable[[], float]] = None,
                 resync: Optional[Callable[[int], None]] = None,
                 resync_patience: int = 0):
        self.link = link
        self.chaos = chaos
        self.stats = stats if stats is not None else {}
        self.now_rel = now_rel or (lambda: 0.0)
        self._resync = resync
        self.resync_patience = resync_patience
        self.last_seq = 0
        # sender's high-water mark, advertised out of band (local: at send
        # time; process: via stats frames) — how a dropped TAIL frame with
        # no successor is still detected as a gap
        self.expected = 0
        self._pending: Dict[int, Tuple[str, Any]] = {}
        self._held: Optional[Tuple[int, str, Any]] = None
        self._out: List[Tuple[str, Any]] = []
        self._gap_waited = -1  # -1: no outstanding gap / resync

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    @property
    def _gapped(self) -> bool:
        return bool(self._pending) or self.expected > self.last_seq

    # -- wire side -----------------------------------------------------------

    def receive(self, seq: int, kind: str, payload: Any) -> None:
        """One sequenced frame off the wire (chaos applies here)."""
        if self.chaos is not None:
            t = self.now_rel()
            if self.chaos.decide("msg_drop", self.link, t):
                self._bump("msgs_dropped")
                return
            if self._held is None and self.chaos.decide(
                    "msg_reorder", self.link, t):
                self._held = (seq, kind, payload)
                self._bump("msgs_reordered")
                return
            if self.chaos.decide("msg_dup", self.link, t):
                self._bump("msgs_duped")
                self._accept(seq, kind, payload)
            self._accept(seq, kind, payload)
            if self._held is not None:
                held, self._held = self._held, None
                self._accept(*held)  # delivered AFTER its successor
        else:
            self._accept(seq, kind, payload)

    def redeliver(self, seq: int, kind: str, payload: Any) -> None:
        """Resync replay path: chaos-exempt, still exactly-once."""
        self._accept(seq, kind, payload)

    def _accept(self, seq: int, kind: str, payload: Any) -> None:
        self.expected = max(self.expected, seq)
        if seq <= self.last_seq or seq in self._pending:
            self._bump("dups_suppressed")
            return
        if seq == self.last_seq + 1:
            self.last_seq = seq
            self._out.append((kind, payload))
            while self.last_seq + 1 in self._pending:
                self.last_seq += 1
                self._out.append(self._pending.pop(self.last_seq))
            if not self._gapped:
                self._gap_waited = -1
            return
        if not self._pending:
            self._bump("gaps_detected")
        self._pending[seq] = (kind, payload)

    # -- receiver side -------------------------------------------------------

    def heal(self) -> None:
        """End-of-poll sweep: release a held reorder, then drive gap
        recovery (request a resync once; abandon if it never lands)."""
        if self._held is not None:
            held, self._held = self._held, None
            self._accept(*held)
        if not self._gapped:
            self._gap_waited = -1
            return
        if self._gap_waited < 0:
            self._gap_waited = 0
            if self._resync is not None:
                self._bump("resyncs")
                try:
                    self._resync(self.last_seq)
                except TransportError:
                    pass  # sender is dead; lost-rid recovery owns it now
            if not self._gapped:  # synchronous (in-process) replay landed
                self._gap_waited = -1
            return
        self._gap_waited += 1
        if self._gap_waited > self.resync_patience:
            self._bump("gaps_abandoned")
            while self._pending:
                self.last_seq = min(self._pending)
                self._out.append(self._pending.pop(self.last_seq))
            self.last_seq = max(self.last_seq, self.expected)
            self._gap_waited = -1

    def drain(self) -> List[Tuple[str, Any]]:
        out, self._out = self._out, []
        return out

    def audit(self, label: str) -> List[str]:
        """Invariant check at teardown: nothing held, no open gap."""
        out = []
        if self._held is not None:
            out.append(f"{label}: delivery guard still holding a reordered "
                       f"frame (seq {self._held[0]})")
        if self._pending:
            out.append(f"{label}: delivery guard has an unresolved gap "
                       f"(last_seq {self.last_seq}, "
                       f"pending {sorted(self._pending)})")
        if self._out:
            out.append(f"{label}: {len(self._out)} delivered frames were "
                       f"never drained")
        return out


@dataclass(frozen=True)
class ReplicaSpec:
    """Everything a worker needs to rebuild its engine deterministically.

    ``param_seed`` matches the in-process construction
    (``build_cluster_engines`` seeds tier *i* with ``PRNGKey(i)``), so a
    process replica serves the SAME weights as its local twin and temp=0
    decoding is token-identical across transports.
    """
    model: str
    serving: ServingConfig
    dtype: str = "float32"
    param_seed: int = 0
    eos_id: int = 2
    sample_temp: float = 0.0
    seed: int = 0
    name: str = "replica"
    # where the worker builds its model; a worker asked for "cuda" on a
    # machine with no card reports "died" (it never falls back to the CPU)
    device: str = "cuda"


def _prefix_hit_len(store, tokens: np.ndarray, extras_fp: bytes) -> int:
    """Longest stored strict prefix of ``tokens`` (0 = miss) WITHOUT
    touching LRU recency — the affinity probe must not reorder the store
    the eventual admission will consult."""
    if not store.enabled:
        return 0
    tokens = np.asarray(tokens)
    for n in sorted(store._lengths, reverse=True):
        if n >= len(tokens) or n < store.min_prefix:
            continue
        if store.contains(tokens[:n], extras_fp):
            return n
    return 0


class LocalTransport:
    """In-process replica: direct calls on a live ``TierEngine``.

    By default hooks attach straight to the engine and ``poll`` harvests
    ``eng.finished`` directly — bit-identical to the pre-pool serving
    path. :meth:`arm_delivery` (armed by the pool when a fault plan
    carries message faults) reroutes the event/finish stream through a
    sequenced :class:`DeliveryGuard` with an in-process outbox, so
    byzantine drop/dup/reorder chaos exercises the SAME exactly-once
    machinery the process transport uses; injected faults all heal
    within the poll that produced them.
    """

    kind = "local"
    supports_restore = True

    def __init__(self, engine):
        self.engine = engine
        self.alive = True
        self._guard: Optional[DeliveryGuard] = None
        self._sink = (None, None, None, None)
        self._seq = 0
        self._outbox: deque = deque(maxlen=OUTBOX_DEPTH)

    # -- config surface -----------------------------------------------------

    @property
    def cfg(self):
        return self.engine.cfg

    @property
    def serving(self) -> ServingConfig:
        return self.engine.serving

    def wire_hooks(self, on_admit, on_token, on_warm, on_park) -> None:
        self._sink = (on_admit, on_token, on_warm, on_park)
        self._attach()

    def _attach(self) -> None:
        on_admit, on_token, on_warm, on_park = self._sink
        if self._guard is None:
            self.engine.on_admit = on_admit
            self.engine.on_token = on_token
            self.engine.on_warm = on_warm
            self.engine.on_park = on_park
        else:
            self.engine.on_admit = \
                lambda rid, t: self._gsend("ev", ("admit", rid, t))
            self.engine.on_token = \
                lambda rid, tok, t: self._gsend("ev", ("token", rid, tok, t))
            self.engine.on_warm = \
                lambda rid, k, c, s: self._gsend("ev", ("warm", rid, k, c, s))
            self.engine.on_park = \
                lambda rid, sid: self._gsend("ev", ("park", rid, sid))

    def arm_delivery(self, chaos, stats: Dict[str, int],
                     now_rel: Callable[[], float], link: str) -> None:
        """Route events/finishes through a sequenced delivery guard with
        byzantine chaos on the wire side. The resync path replays
        synchronously from the in-process outbox."""
        self._guard = DeliveryGuard(
            link, chaos=chaos, stats=stats, now_rel=now_rel,
            resync=self._replay, resync_patience=0)
        self._attach()

    def _gsend(self, kind: str, payload: Any) -> None:
        self._seq += 1
        self._outbox.append((self._seq, kind, payload))
        # advertise the sender high-water mark BEFORE the wire so even a
        # dropped tail frame is seen as a gap at the next heal
        self._guard.expected = max(self._guard.expected, self._seq)
        self._guard.receive(self._seq, kind, payload)

    def _replay(self, last_seq: int) -> None:
        for seq, kind, payload in self._outbox:
            if seq > last_seq:
                self._guard.redeliver(seq, kind, payload)

    # -- request plane ------------------------------------------------------

    def submit(self, rid: int, tokens, max_new: int, extras,
               deadline, session) -> None:
        self.engine.submit(rid, tokens, max_new=max_new, extras=extras,
                           deadline=deadline, session=session)

    def cancel(self, rid: int) -> None:
        self.engine.cancel(rid)

    def poll(self) -> Tuple[List[FinishedSeq], bool, List[int]]:
        """One engine step; returns (finished, any-activity, lost rids)."""
        eng = self.engine
        n = eng.step()
        if self._guard is None:
            fins = [FinishedSeq(st.rid, list(st.generated), st.t_done)
                    for st in eng.finished]
            eng.finished.clear()
        else:
            for st in eng.finished:
                self._gsend("fin",
                            FinishedSeq(st.rid, list(st.generated),
                                        st.t_done))
            eng.finished.clear()
            self._guard.heal()
            on_admit, on_token, on_warm, on_park = self._sink
            fins = []
            for kind, payload in self._guard.drain():
                if kind == "fin":
                    fins.append(payload)
                    continue
                ev = payload
                if ev[0] == "admit" and on_admit:
                    on_admit(ev[1], ev[2])
                elif ev[0] == "token" and on_token:
                    on_token(ev[1], ev[2], ev[3])
                elif ev[0] == "warm" and on_warm:
                    on_warm(ev[1], ev[2], ev[3], ev[4])
                elif ev[0] == "park" and on_park:
                    on_park(ev[1], ev[2])
            while self._outbox and self._outbox[0][0] <= self._guard.last_seq:
                self._outbox.popleft()
        active = bool(n) or bool(eng.waiting) \
            or any(s is not None for s in eng.slots)
        return fins, active, []

    # -- observation --------------------------------------------------------

    def free_slots(self) -> int:
        return sum(s is None for s in self.engine.slots)

    def total_slots(self) -> int:
        return len(self.engine.slots)

    def queue_len(self) -> int:
        return len(self.engine.waiting)

    def kv_headroom(self) -> float:
        return self.engine.kv_headroom()

    def occupancy(self) -> int:
        return len(self.engine.waiting) + sum(
            s is not None for s in self.engine.slots)

    def rids(self) -> List[int]:
        return self.engine.rids()

    def slot_rids(self) -> List[int]:
        return [s.rid for s in self.engine.slots if s is not None]

    def decode_slots(self) -> List[Tuple[int, int]]:
        """(rid, remaining decode budget) per occupied slot, slot order."""
        return [(s.rid, s.max_new - len(s.generated))
                for s in self.engine.slots if s is not None]

    def prefix_hit_len(self, tokens, extras_fp: bytes) -> int:
        return _prefix_hit_len(self.engine.prefix_store, tokens, extras_fp)

    def counters(self) -> Dict[str, int]:
        e = self.engine
        return {"decode_tokens": e.decode_tokens,
                "prefill_tokens": e.prefill_tokens,
                "encode_tokens": e.encode_tokens,
                "prefix_hits": e.prefix_hits,
                "prefix_hit_tokens": e.prefix_hit_tokens,
                "resumed_sessions": e.resumed_sessions,
                "resumed_tokens": e.resumed_tokens,
                "parks": e.parks,
                "drafted_tokens": e.drafted_tokens,
                "accepted_tokens": e.accepted_tokens,
                "spec_rounds": e.spec_rounds}

    @property
    def healthy(self) -> bool:
        return self.engine.healthy

    def heartbeat_ok(self) -> bool:
        return self.engine.heartbeat_ok()

    def set_throttle(self, mult: float) -> None:
        self.engine.throttle = mult

    # -- partial offload ----------------------------------------------------

    def encode_image(self, image, num_patches: int = 0,
                     frontend_dim: int = 0):
        return self.engine.encode_image(image, num_patches, frontend_dim)

    # -- slot / session wire ------------------------------------------------

    def extract_wire(self, rid: int, *, remove: bool = False) -> bytes:
        return self.engine.extract_slot(rid, remove=remove).to_bytes()

    def inject_wire(self, wire: bytes) -> None:
        self.engine.inject_slot(SlotPayload.from_bytes(wire))

    def has_session(self, sid: str) -> bool:
        return sid in self.engine.sessions

    def session_ids(self) -> List[str]:
        return list(self.engine.sessions.ids())

    def session_count(self) -> int:
        return len(self.engine.sessions)

    def resume_session_wire(self, sid: str) -> Optional[bytes]:
        parked = self.engine.resume_session(sid)
        if parked is None or not isinstance(parked.data, SlotPayload):
            return None
        return parked.data.to_bytes()

    def adopt_session_wire(self, sid: str, wire: bytes) -> bool:
        try:
            payload = SlotPayload.from_bytes(wire)
        except MigrationError:
            return False  # corrupt in transit: the turn cold-prefills
        return bool(self.engine.adopt_session(sid, payload))

    def drop_session(self, sid: str) -> None:
        self.engine.sessions.resume(sid)  # pop + discard

    # -- fault discipline ---------------------------------------------------

    def snapshot(self) -> dict:
        return self.engine.snapshot()

    def restore(self, snap: dict) -> None:
        self.engine.restore(snap)

    def close(self) -> None:
        self.alive = False


# ---------------------------------------------------------------------------
# process transport


def _worker_main(conn, spec_raw: bytes) -> None:
    """Worker entry: rebuild the engine from its spec, then free-run —
    step while there is work, drain the command pipe between steps, and
    stream events / finished sequences / stats upward."""
    try:
        kind, spec = msg_from_bytes(spec_raw)
        assert kind == "spec"
        from repro_torch.configs import reduced_config
        from repro_torch.models import build_model
        from repro_torch.serving.engine import TierEngine

        cfg = reduced_config(spec.model).replace(dtype=spec.dtype)
        model = build_model(cfg, device=spec.device)
        eng = TierEngine(model, model.init(spec.param_seed),
                         spec.serving, eos_id=spec.eos_id,
                         sample_temp=spec.sample_temp, seed=spec.seed)
    except Exception as e:  # construction failed: report, don't hang
        try:
            conn.send_bytes(msg_to_bytes("died", f"build: {e!r}"))
        finally:
            conn.close()
        return

    events: List[tuple] = []
    eng.on_admit = lambda rid, t: events.append(("admit", rid, t))
    eng.on_token = lambda rid, tok, t: events.append(("token", rid, tok, t))
    eng.on_warm = lambda rid, k, c, s: events.append(("warm", rid, k, c, s))
    eng.on_park = lambda rid, sid: events.append(("park", rid, sid))

    # sequenced stream state: every events/fin frame carries a monotonic
    # seq and lands in a bounded outbox so the parent's delivery guard
    # can request a gap replay ("resync")
    stream_seq = 0
    outbox: deque = deque(maxlen=OUTBOX_DEPTH)

    def send_seq(kind: str, payload: Any) -> None:
        nonlocal stream_seq
        stream_seq += 1
        outbox.append((stream_seq, kind, payload))
        conn.send_bytes(msg_to_bytes(kind, (stream_seq, payload)))

    def handle_rpc(seq: int, op: str, arg: dict) -> None:
        try:
            if op == "encode":
                out = eng.encode_image(arg["image"], arg["num_patches"],
                                       arg["frontend_dim"])
            elif op == "extract":
                out = eng.extract_slot(arg["rid"],
                                       remove=arg["remove"]).to_bytes()
            elif op == "inject":
                eng.inject_slot(SlotPayload.from_bytes(arg["wire"]))
                out = True
            elif op == "resume_session":
                parked = eng.resume_session(arg["sid"])
                out = (parked.data.to_bytes()
                       if parked is not None
                       and isinstance(parked.data, SlotPayload) else None)
            elif op == "adopt_session":
                try:
                    payload = SlotPayload.from_bytes(arg["wire"])
                except MigrationError:
                    out = False
                else:
                    out = bool(eng.adopt_session(arg["sid"], payload))
            elif op == "drop_session":
                eng.sessions.resume(arg["sid"])
                out = True
            elif op == "ping":
                out = True
            else:
                raise TransportError(f"unknown rpc op {op!r}")
            conn.send_bytes(msg_to_bytes("reply", (seq, True, out)))
        except MigrationError as e:
            conn.send_bytes(msg_to_bytes("reply", (seq, False,
                                                   ("migration", str(e)))))
        except Exception as e:
            conn.send_bytes(msg_to_bytes("reply", (seq, False,
                                                   ("error", repr(e)))))

    def stats() -> dict:
        return {
            "stream_seq": stream_seq,
            "free_slots": sum(s is None for s in eng.slots),
            "total_slots": len(eng.slots),
            "queue": len(eng.waiting),
            "kv_headroom": eng.kv_headroom(),
            "sessions": list(eng.sessions.ids()),
            "healthy": eng.healthy,
            "counters": {
                "decode_tokens": eng.decode_tokens,
                "prefill_tokens": eng.prefill_tokens,
                "encode_tokens": eng.encode_tokens,
                "prefix_hits": eng.prefix_hits,
                "prefix_hit_tokens": eng.prefix_hit_tokens,
                "resumed_sessions": eng.resumed_sessions,
                "resumed_tokens": eng.resumed_tokens,
                "parks": eng.parks,
                "drafted_tokens": eng.drafted_tokens,
                "accepted_tokens": eng.accepted_tokens,
                "spec_rounds": eng.spec_rounds},
        }

    conn.send_bytes(msg_to_bytes("ready", stats()))
    last_stats = time.monotonic()
    running = True
    try:
        while running:
            busy = bool(eng.waiting) or any(
                s is not None for s in eng.slots)
            # drain commands; when idle, block briefly so the worker
            # doesn't spin a core waiting for work
            while conn.poll(0.0 if busy else 0.02):
                kind, payload = msg_from_bytes(
                    conn.recv_bytes(maxlength=DEFAULT_MAX_FRAME_BYTES))
                if kind == "stop":
                    running = False
                    break
                if kind == "submit":
                    eng.submit(payload["rid"], payload["tokens"],
                               max_new=payload["max_new"],
                               extras=payload["extras"],
                               deadline=payload["deadline"],
                               session=payload["session"])
                elif kind == "cancel":
                    eng.cancel(payload)
                elif kind == "throttle":
                    eng.throttle = float(payload)
                elif kind == "resync":
                    replay = [(s, k, p) for s, k, p in outbox
                              if s > int(payload)]
                    conn.send_bytes(msg_to_bytes("replay", replay))
                elif kind == "rpc":
                    handle_rpc(*payload)
                busy = True  # a command may have created work
            if not running:
                break
            if eng.waiting or any(s is not None for s in eng.slots):
                eng.step()
            if events:
                send_seq("events", events)
                events = []
            fins = None
            if eng.finished:
                fins = [(st.rid, list(st.generated), st.t_done)
                        for st in eng.finished]
                eng.finished.clear()
                send_seq("fin", fins)
            now = time.monotonic()
            if fins is not None or now - last_stats > 0.05:
                conn.send_bytes(msg_to_bytes("stats", stats()))
                last_stats = now
    except (EOFError, OSError, BrokenPipeError):
        pass  # parent went away
    except Exception as e:
        try:
            conn.send_bytes(msg_to_bytes("died", repr(e)))
        except Exception:
            pass
    finally:
        conn.close()


class ProcessTransport:
    """A replica in a spawn-context worker process behind a duplex pipe.

    The parent mirrors the worker's utilization (slots, queue, KV
    headroom, parked session ids, counters) from its periodic stats
    messages — observation reads are mirror-fresh, never blocking RPCs.
    A dead worker (crash, closed pipe, RPC timeout) flips ``alive``; the
    owning pool then reports the replica's in-flight rids as *lost* so
    the runtime's shared failure path resubmits them to siblings.
    """

    kind = "process"
    supports_restore = False

    def __init__(self, spec: ReplicaSpec, start_timeout_s: float = 120.0,
                 rpc_timeout_s: float = 60.0,
                 max_frame_bytes: int = DEFAULT_MAX_FRAME_BYTES):
        self.spec = spec
        self.alive = True
        self.rpc_timeout_s = rpc_timeout_s
        self.max_frame_bytes = int(max_frame_bytes)
        self._rpc_seq = 0
        self._live_rids: set = set()
        self._pending_fins: List[FinishedSeq] = []
        self._pending_lost: List[int] = []
        self._hooks = (None, None, None, None)
        # the sequenced event/fin stream always rides a delivery guard
        # (exactly-once even on an honest pipe); byzantine chaos and the
        # shared stats dict are armed later by the pool when a fault plan
        # carries message faults
        self._chaos = None
        self._frame_link = f"frame:{spec.name}"
        self._now_rel: Callable[[], float] = lambda: 0.0
        self._guard = DeliveryGuard(
            f"events:{spec.name}", resync=self._request_resync,
            resync_patience=64)
        self._stats: Dict[str, Any] = {
            "free_slots": spec.serving.max_batch,
            "total_slots": spec.serving.max_batch,
            "queue": 0, "kv_headroom": 1.0, "sessions": [],
            "healthy": True, "counters": {}}
        # parent-side model config twin (for patch geometry / embed bytes
        # without a round trip) — the worker builds the same reduced config
        from repro_torch.configs import reduced_config
        self.cfg = reduced_config(spec.model).replace(dtype=spec.dtype)
        ctx = mp.get_context("spawn")
        self._conn, child = ctx.Pipe(duplex=True)
        self._proc = ctx.Process(
            target=_worker_main,
            args=(child, msg_to_bytes("spec", spec)),
            name=f"tier-replica-{spec.name}", daemon=True)
        self._proc.start()
        child.close()
        # block until the worker's engine is built: submissions before
        # "ready" would race construction failures
        deadline = time.monotonic() + start_timeout_s
        while True:
            if self._conn.poll(0.1):
                try:
                    kind, payload = msg_from_bytes(
                        self._conn.recv_bytes(maxlength=self.max_frame_bytes),
                        self.max_frame_bytes)
                except (EOFError, OSError) as e:
                    # spawn failed before the worker could report (e.g. a
                    # non-importable __main__): surface a TransportError
                    self._mark_dead()
                    raise TransportError(
                        f"replica {spec.name} died during spawn: "
                        f"{e!r}") from e
                if kind == "ready":
                    self._stats.update(payload)
                    break
                if kind == "died":
                    self._mark_dead()
                    raise TransportError(
                        f"replica {spec.name} failed to start: {payload}")
            if time.monotonic() > deadline:
                self._mark_dead()
                raise TransportError(
                    f"replica {spec.name} start timeout")

    @property
    def serving(self) -> ServingConfig:
        return self.spec.serving

    def wire_hooks(self, on_admit, on_token, on_warm, on_park) -> None:
        self._hooks = (on_admit, on_token, on_warm, on_park)

    def arm_delivery(self, chaos, stats: Dict[str, int],
                     now_rel: Callable[[], float], link: str) -> None:
        """Attach byzantine chaos + the runtime's shared wire-stats dict
        to this replica's streams. The existing guard keeps its sequence
        state; raw frame corruption applies on the matching frame link."""
        self._chaos = chaos
        self._now_rel = now_rel
        self._frame_link = "frame:" + link.split(":", 1)[-1]
        self._guard.link = link
        self._guard.chaos = chaos
        self._guard.stats = stats
        self._guard.now_rel = now_rel

    # -- plumbing -----------------------------------------------------------

    def _mark_dead(self) -> None:
        if not self.alive:
            return
        self.alive = False
        self._pending_lost.extend(sorted(self._live_rids))
        self._live_rids.clear()

    def _send(self, kind: str, payload: Any) -> None:
        if not self.alive:
            raise TransportError(f"replica {self.spec.name} is dead")
        try:
            self._conn.send_bytes(msg_to_bytes(kind, payload))
        except (OSError, BrokenPipeError, ValueError) as e:
            self._mark_dead()
            raise TransportError(
                f"replica {self.spec.name} pipe broken: {e}") from e

    def _dispatch(self, kind: str, payload: Any) -> None:
        """Route one inbound message. Sequenced events/fin frames pass
        through the delivery guard (exactly-once, in order); replays and
        stats feed its gap machinery out of band."""
        if kind == "events" or kind == "fin":
            seq, body = payload
            self._guard.receive(int(seq), kind, body)
            self._flush_guard()
        elif kind == "replay":
            for seq, k, body in payload:
                self._guard.redeliver(int(seq), k, body)
            self._flush_guard()
        elif kind == "stats":
            self._stats.update(payload)
            self._guard.expected = max(
                self._guard.expected, int(payload.get("stream_seq", 0)))
        elif kind == "died":
            self._mark_dead()

    def _flush_guard(self) -> None:
        """Deliver in-order frames released by the guard."""
        for kind, body in self._guard.drain():
            if kind == "events":
                on_admit, on_token, on_warm, on_park = self._hooks
                for ev in body:
                    if ev[0] == "admit" and on_admit:
                        on_admit(ev[1], ev[2])
                    elif ev[0] == "token" and on_token:
                        on_token(ev[1], ev[2], ev[3])
                    elif ev[0] == "warm" and on_warm:
                        on_warm(ev[1], ev[2], ev[3], ev[4])
                    elif ev[0] == "park" and on_park:
                        on_park(ev[1], ev[2])
            else:  # fin
                for rid, generated, t_done in body:
                    self._live_rids.discard(rid)
                    self._pending_fins.append(
                        FinishedSeq(rid, list(generated), t_done))

    def _request_resync(self, last_seq: int) -> None:
        self._send("resync", int(last_seq))

    def _drain(self) -> None:
        try:
            while self.alive and self._conn.poll(0.0):
                raw = self._conn.recv_bytes(maxlength=self.max_frame_bytes)
                if self._chaos is not None and self._chaos.decide(
                        "corrupt", self._frame_link, self._now_rel()):
                    raw = self._chaos.tamper(raw, self._frame_link)
                    self._chaos.bump("corrupt_injected")
                try:
                    kind, payload = msg_from_bytes(raw, self.max_frame_bytes)
                except TransportError:
                    # corrupt frame: count, discard, let the sequence
                    # layer detect the hole and resync — never unpickled
                    self._guard._bump("corrupt_detected")
                    continue
                if kind == "reply":
                    continue  # stale reply from a timed-out RPC
                self._dispatch(kind, payload)
        except (EOFError, OSError, BrokenPipeError):
            self._mark_dead()
        if self.alive and not self._proc.is_alive():
            self._mark_dead()

    def _rpc(self, op: str, **arg):
        self._rpc_seq += 1
        seq = self._rpc_seq
        self._send("rpc", (seq, op, arg))
        deadline = time.monotonic() + self.rpc_timeout_s
        while time.monotonic() < deadline:
            try:
                if not self._conn.poll(0.05):
                    continue
                kind, payload = msg_from_bytes(
                    self._conn.recv_bytes(maxlength=self.max_frame_bytes),
                    self.max_frame_bytes)
            except (EOFError, OSError, BrokenPipeError) as e:
                self._mark_dead()
                raise TransportError(
                    f"replica {self.spec.name} died mid-RPC") from e
            if kind == "reply":
                rseq, ok, out = payload
                if rseq != seq:
                    continue  # stale reply from an earlier timeout
                if ok:
                    return out
                tag, detail = out
                if tag == "migration":
                    raise MigrationError(detail)
                raise TransportError(f"{op} failed on "
                                     f"{self.spec.name}: {detail}")
            self._dispatch(kind, payload)
        self._mark_dead()
        raise TransportError(f"rpc {op} timed out on {self.spec.name}")

    # -- request plane ------------------------------------------------------

    def submit(self, rid: int, tokens, max_new: int, extras,
               deadline, session) -> None:
        self._send("submit", {"rid": rid, "tokens": np.asarray(tokens),
                              "max_new": max_new, "extras": extras,
                              "deadline": deadline, "session": session})
        self._live_rids.add(rid)

    def cancel(self, rid: int) -> None:
        self._live_rids.discard(rid)
        if self.alive:
            try:
                self._send("cancel", rid)
            except TransportError:
                pass  # already dead: the rid is gone either way

    def poll(self) -> Tuple[List[FinishedSeq], bool, List[int]]:
        self._drain()
        self._guard.heal()
        self._flush_guard()
        fins, self._pending_fins = self._pending_fins, []
        lost, self._pending_lost = self._pending_lost, []
        return fins, bool(self._live_rids), lost

    # -- observation (mirror-fresh, non-blocking) ---------------------------

    def free_slots(self) -> int:
        return int(self._stats["free_slots"]) if self.alive else 0

    def total_slots(self) -> int:
        return int(self._stats["total_slots"])

    def queue_len(self) -> int:
        return int(self._stats["queue"]) if self.alive else 0

    def kv_headroom(self) -> float:
        return float(self._stats["kv_headroom"]) if self.alive else 0.0

    def occupancy(self) -> int:
        # live rids the parent actually submitted: robust against a stale
        # stats mirror between heartbeats
        return len(self._live_rids)

    def rids(self) -> List[int]:
        return sorted(self._live_rids)

    def slot_rids(self) -> List[int]:
        return []  # no slot-granular visibility across the pipe

    def decode_slots(self) -> List[Tuple[int, int]]:
        return []  # preemption scans only local replicas

    def prefix_hit_len(self, tokens, extras_fp: bytes) -> int:
        return 0  # affinity probe is local-only; process picks by load

    def counters(self) -> Dict[str, int]:
        return dict(self._stats.get("counters", {}))

    @property
    def healthy(self) -> bool:
        return self.alive and bool(self._stats.get("healthy", True))

    def heartbeat_ok(self) -> bool:
        return self.alive and self._proc.is_alive()

    def set_throttle(self, mult: float) -> None:
        if self.alive:
            try:
                self._send("throttle", float(mult))
            except TransportError:
                pass

    # -- partial offload ----------------------------------------------------

    def encode_image(self, image, num_patches: int = 0,
                     frontend_dim: int = 0):
        return self._rpc("encode", image=np.asarray(image),
                         num_patches=num_patches, frontend_dim=frontend_dim)

    # -- slot / session wire ------------------------------------------------

    def extract_wire(self, rid: int, *, remove: bool = False) -> bytes:
        wire = self._rpc("extract", rid=rid, remove=remove)
        if remove:
            self._live_rids.discard(rid)
        return wire

    def inject_wire(self, wire: bytes) -> None:
        self._rpc("inject", wire=wire)

    def has_session(self, sid: str) -> bool:
        return self.alive and sid in self._stats.get("sessions", [])

    def session_ids(self) -> List[str]:
        return list(self._stats.get("sessions", [])) if self.alive else []

    def session_count(self) -> int:
        return len(self.session_ids())

    def resume_session_wire(self, sid: str) -> Optional[bytes]:
        try:
            return self._rpc("resume_session", sid=sid)
        except TransportError:
            return None

    def adopt_session_wire(self, sid: str, wire: bytes) -> bool:
        try:
            return bool(self._rpc("adopt_session", sid=sid, wire=wire))
        except TransportError:
            return False

    def drop_session(self, sid: str) -> None:
        try:
            self._rpc("drop_session", sid=sid)
        except TransportError:
            pass

    # -- fault discipline ---------------------------------------------------

    def snapshot(self) -> dict:
        raise TransportError(
            "process replicas have no host-side snapshot; chaos injection "
            "(fail_rate / crash plans) requires the local transport")

    def restore(self, snap: dict) -> None:
        raise TransportError("process replicas cannot restore")

    def close(self) -> None:
        if self.alive:
            try:
                self._send("stop", None)
            except TransportError:
                pass
        self.alive = False
        self._proc.join(timeout=5.0)
        if self._proc.is_alive():
            self._proc.terminate()
            self._proc.join(timeout=5.0)
        try:
            self._conn.close()
        except OSError:
            pass
