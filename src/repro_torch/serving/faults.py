"""Declarative, deterministic fault plans for chaos-testing the runtime.

A :class:`FaultPlan` is a schedule of :class:`FaultEvent` windows on the
**epoch-relative** clock (seconds since the runtime's first event), so one
plan drives the analytic backend's virtual clock and the live backend's
monotonic clock identically — the acceptance bar for sim-vs-live chaos
parity. Four event kinds:

* ``crash`` — the tier's node is down for the window: every service attempt
  started inside it faults (heartbeat-detected, then retried/failed through
  the runtime's shared retry budget).
* ``slow`` — service on the tier takes ``magnitude``× as long while the
  window is open (a thermally-throttled / contended node).
* ``degrade`` — the tier's WAN link runs at ``magnitude``× bandwidth;
  ``magnitude == 0`` is a full partition (transfers black-hole and only a
  configured transfer timeout releases them).
* ``flap`` — sugar for periodic crashing: expands into crash windows of
  ``magnitude`` duty cycle (down fraction) every ``period`` seconds.

Byzantine *message-level* fault kinds ride the same windows, keyed per
**wire link** instead of per tier. ``magnitude`` is the per-message
probability in (0, 1]; the event's ``tier`` field selects the link(s):

* ``corrupt`` — flip byte(s) of a frame / slot payload on the wire (the
  receiving side's CRC32 must detect it and raise
  ``TransportError``/``MigrationError``);
* ``msg_drop`` — the message silently vanishes (the sequence layer
  detects the gap and resyncs from the sender's outbox);
* ``msg_dup`` — the message is delivered twice (the per-replica delivery
  ledger suppresses the duplicate);
* ``msg_reorder`` — the message is held and delivered after its
  successor (the sequence layer restores order).

Links are named ``proto:tier`` or ``proto:tier/replica`` — e.g.
``events:edge/0`` (replica 0's sequenced event stream),
``frame:cloud/1`` (a process replica's raw pipe frames),
``migrate:cloud`` / ``session:edge`` (slot-payload transfers landing on
a tier) and ``draft:edge`` (speculative draft blocks). An event's
``tier`` selector matches a link when it equals the full link name, is a
``proto:tier`` prefix of it, names the link's tier, or is ``"*"``.

All draws are made by :class:`WireChaos` from per-(kind, link) counters
hashed with the plan's ``wire_seed`` — no shared rng stream, so the
analytic and live backends make IDENTICAL per-link decisions whenever
they issue the same sequence of queries per link (the byzantine
sim-vs-live parity bar; windows spanning the whole run make window
membership clock-independent too).

The scalar ``fail_rate`` the runtime always supported is kept as a shim:
``FaultPlan.from_fail_rate(p)`` compiles it into a plan whose Bernoulli
draws flow through the exact same rng stream as before, so golden metrics
stay bit-identical. Plans are plain data: JSON round-trip via
``to_json``/``from_json`` (the ``--fault-plan`` launcher flag), and
``FaultPlan.storm(seed=...)`` builds a seeded pseudo-random storm for
benchmarks — deterministic given the seed, never drawing at query time.
"""
from __future__ import annotations

import json
import math
import zlib
from dataclasses import asdict, dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = ["FaultEvent", "FaultPlan", "WireChaos"]

MSG_KINDS = ("corrupt", "msg_drop", "msg_dup", "msg_reorder")
KINDS = ("crash", "slow", "degrade", "flap") + MSG_KINDS
INF = float("inf")


@dataclass(frozen=True)
class FaultEvent:
    """One fault window. ``t`` is epoch-relative (seconds since the
    runtime's first event); ``duration`` may be infinite (never recovers).
    ``magnitude``: slow -> service-time multiplier (>1), degrade ->
    bandwidth multiplier in [0, 1] (0 = partition), flap -> down duty
    cycle in (0, 1]. ``period`` is the flap cycle length."""

    kind: str
    tier: str
    t: float = 0.0
    duration: float = INF
    magnitude: float = 1.0
    period: float = 1.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(
                f"unknown fault kind {self.kind!r} (known: {KINDS}); "
                "a stale plan file must fail loudly, not inject silently")
        if self.t < 0 or self.duration < 0:
            raise ValueError("fault windows cannot start/extend before 0")
        if self.kind == "flap" and (self.period <= 0
                                    or not 0 < self.magnitude <= 1):
            raise ValueError("flap needs period > 0 and duty in (0, 1]")
        if self.kind == "degrade" and not 0 <= self.magnitude:
            raise ValueError("degrade magnitude is a bandwidth multiplier")
        if self.kind in MSG_KINDS and not 0 < self.magnitude <= 1:
            raise ValueError(
                f"{self.kind} magnitude is a per-message probability in "
                f"(0, 1], got {self.magnitude}")


class FaultPlan:
    """Immutable compiled schedule answering point-in-time queries."""

    def __init__(self, events: Sequence[FaultEvent] = (),
                 fail_rate: float = 0.0, wire_seed: int = 0):
        self.events: Tuple[FaultEvent, ...] = tuple(events)
        self.fail_rate = float(fail_rate)
        self.wire_seed = int(wire_seed)
        # compile: flap -> crash windows; bucket windows per tier
        self._crash: Dict[str, List[Tuple[float, float]]] = {}
        self._slow: Dict[str, List[Tuple[float, float, float]]] = {}
        self._link: Dict[str, List[Tuple[float, float, float]]] = {}
        # message faults bucket per kind: (selector, t0, t1, probability)
        self._msg: Dict[str, List[Tuple[str, float, float, float]]] = {}
        for e in self.events:
            if e.kind in MSG_KINDS:
                self._msg.setdefault(e.kind, []).append(
                    (e.tier, e.t, e.t + e.duration, e.magnitude))
            elif e.kind == "crash":
                self._crash.setdefault(e.tier, []).append(
                    (e.t, e.t + e.duration))
            elif e.kind == "flap":
                if math.isinf(e.duration):
                    raise ValueError("flap needs a finite duration")
                cycles = max(1, int(math.ceil(e.duration / e.period)))
                for k in range(cycles):
                    t0 = e.t + k * e.period
                    t1 = min(t0 + e.magnitude * e.period, e.t + e.duration)
                    if t1 > t0:
                        self._crash.setdefault(e.tier, []).append((t0, t1))
            elif e.kind == "slow":
                self._slow.setdefault(e.tier, []).append(
                    (e.t, e.t + e.duration, e.magnitude))
            elif e.kind == "degrade":
                self._link.setdefault(e.tier, []).append(
                    (e.t, e.t + e.duration, e.magnitude))
        for wins in self._crash.values():
            wins.sort()

    # -- queries (t is epoch-relative) --------------------------------------

    @property
    def has_crashes(self) -> bool:
        return bool(self._crash)

    @property
    def has_msg_faults(self) -> bool:
        return bool(self._msg)

    @staticmethod
    def _sel_match(sel: str, link: str) -> bool:
        """Does selector ``sel`` cover wire link ``link``? Matches the full
        link name, a ``proto:tier`` prefix, the bare tier name, or ``*``."""
        if sel == "*" or sel == link:
            return True
        if link.startswith(sel + "/"):
            return True
        tier = link.split(":", 1)[-1].split("/", 1)[0]
        return sel == tier

    def msg_prob(self, kind: str, link: str, t: float) -> float:
        """Per-message probability of ``kind`` on ``link`` at rel-time ``t``
        (max over matching open windows)."""
        p = 0.0
        for sel, t0, t1, prob in self._msg.get(kind, ()):
            if t0 <= t < t1 and self._sel_match(sel, link):
                p = max(p, prob)
        return p

    def crashed(self, tier: str, t: float) -> bool:
        return any(t0 <= t < t1 for t0, t1 in self._crash.get(tier, ()))

    def slow_multiplier(self, tier: str, t: float) -> float:
        mult = 1.0
        for t0, t1, m in self._slow.get(tier, ()):
            if t0 <= t < t1:
                mult *= m
        return mult

    def link_multiplier(self, tier: str, t: float) -> float:
        mult = 1.0
        for t0, t1, m in self._link.get(tier, ()):
            if t0 <= t < t1:
                mult *= m
        return mult

    # -- construction --------------------------------------------------------

    @classmethod
    def from_fail_rate(cls, fail_rate: float) -> "FaultPlan":
        """Shim for the legacy scalar knob: the plan carries the Bernoulli
        rate and no windows, and the backends draw it through the SAME rng
        stream the bare ``fail_rate`` used (golden metrics bit-identical)."""
        return cls((), fail_rate=fail_rate)

    @classmethod
    def storm(cls, seed: int, tiers: Sequence[str], duration: float,
              crash_frac: float = 0.5, slow_mult: float = 4.0,
              degrade_mult: float = 0.25) -> "FaultPlan":
        """Seeded pseudo-random fault storm over ``tiers``: one crash
        window, one slow window and one link-degrade window land on rng-
        chosen tiers at rng-chosen offsets inside ``duration``. All draws
        happen HERE — the compiled plan is deterministic data."""
        rng = np.random.default_rng(seed)
        tiers = list(tiers)
        ev = []
        crash_tier = tiers[int(rng.integers(len(tiers)))]
        t0 = float(rng.uniform(0.05, 0.3) * duration)
        ev.append(FaultEvent("crash", crash_tier, t=t0,
                             duration=crash_frac * duration))
        slow_tier = tiers[int(rng.integers(len(tiers)))]
        ev.append(FaultEvent("slow", slow_tier,
                             t=float(rng.uniform(0.0, 0.4) * duration),
                             duration=0.5 * duration, magnitude=slow_mult))
        link_tier = tiers[int(rng.integers(len(tiers)))]
        ev.append(FaultEvent("degrade", link_tier,
                             t=float(rng.uniform(0.1, 0.5) * duration),
                             duration=0.4 * duration,
                             magnitude=degrade_mult))
        return cls(ev)

    @classmethod
    def byzantine_storm(cls, seed: int, corrupt: float = 0.5,
                        dup: float = 0.2, drop: float = 0.1,
                        reorder: float = 0.1,
                        links: str = "*") -> "FaultPlan":
        """Whole-run byzantine wire storm: corruption on every link plus
        dup/drop/reorder on the sequenced streams. Infinite windows keep
        the decisions clock-independent (identical across backends)."""
        ev = []
        if corrupt > 0:
            ev.append(FaultEvent("corrupt", links, magnitude=corrupt))
        if dup > 0:
            ev.append(FaultEvent("msg_dup", links, magnitude=dup))
        if drop > 0:
            ev.append(FaultEvent("msg_drop", links, magnitude=drop))
        if reorder > 0:
            ev.append(FaultEvent("msg_reorder", links, magnitude=reorder))
        return cls(ev, wire_seed=seed)

    # -- JSON round-trip ------------------------------------------------------

    def to_json(self) -> str:
        events = []
        for e in self.events:
            d = asdict(e)
            if math.isinf(d["duration"]):
                d["duration"] = "inf"
            events.append(d)
        return json.dumps({"fail_rate": self.fail_rate,
                           "wire_seed": self.wire_seed, "events": events},
                          sort_keys=True)

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        obj = json.loads(raw)
        events = []
        for d in obj.get("events", ()):
            d = dict(d)
            if d.get("duration") == "inf":
                d["duration"] = INF
            events.append(FaultEvent(**d))
        return cls(events, fail_rate=float(obj.get("fail_rate", 0.0)),
                   wire_seed=int(obj.get("wire_seed", 0)))

    def __repr__(self) -> str:
        return (f"FaultPlan({len(self.events)} events, "
                f"fail_rate={self.fail_rate})")


class WireChaos:
    """Deterministic message-level fault injector for one runtime.

    Every decision hashes ``(wire_seed, kind, link, n)`` with a per-
    (kind, link) counter ``n`` — no rng object, no shared stream, and no
    dependence on PYTHONHASHSEED — so two backends (or a re-run) that
    issue the same sequence of queries per link make identical choices.
    ``stats`` is a shared mutable counter dict (usually the runtime's
    ``wire_stats``) that injection sites and delivery guards bump."""

    def __init__(self, plan: FaultPlan, stats: Optional[Dict[str, int]] = None):
        self.plan = plan
        self.seed = plan.wire_seed
        self.stats: Dict[str, int] = stats if stats is not None else {}
        self._n: Dict[Tuple[str, str], int] = {}

    def bump(self, key: str, n: int = 1) -> None:
        self.stats[key] = self.stats.get(key, 0) + n

    def _unit(self, kind: str, link: str) -> float:
        key = (kind, link)
        n = self._n.get(key, 0)
        self._n[key] = n + 1
        h = zlib.crc32(f"{self.seed}|{kind}|{link}|{n}".encode())
        return (h % 999983) / 999983.0

    def decide(self, kind: str, link: str, t: float) -> bool:
        """Draw the fate of one message of ``kind`` on ``link`` at
        rel-time ``t``. Counters only advance inside an open window, so
        whole-run windows preserve cross-backend determinism."""
        p = self.plan.msg_prob(kind, link, t)
        if p <= 0.0:
            return False
        return self._unit(kind, link) < p

    def tamper(self, data: bytes, link: str) -> bytes:
        """Deterministically flip one byte of ``data`` (guaranteed to
        differ: the xor mask is never zero)."""
        if not data:
            return data
        key = ("tamper", link)
        n = self._n.get(key, 0)
        self._n[key] = n + 1
        h = zlib.crc32(f"{self.seed}|tamper|{link}|{n}".encode())
        pos = h % len(data)
        mask = 1 + ((h >> 8) % 255)
        out = bytearray(data)
        out[pos] ^= mask
        return bytes(out)
