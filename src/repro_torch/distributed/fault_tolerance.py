"""Fault-tolerance coordination for multi-pod training/serving.

Single-controller pattern: a HeartbeatRegistry tracks liveness of worker
groups (pods / hosts); on a missed deadline the RecoveryCoordinator decides
between (a) restart-in-place from the latest checkpoint, (b) elastic
downsize (rebuild the mesh without the dead pod and re-shard via
``repro_torch.checkpoint.elastic``), or (c) hot-spare swap. On one host this is
exercised with simulated clocks in tests; the decision logic is exactly what
a 1000-node deployment runs — detection is transport-level either way.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional


@dataclass
class WorkerHealth:
    name: str
    last_beat: float
    failures: int = 0
    alive: bool = True


class HeartbeatRegistry:
    def __init__(self, timeout_s: float = 10.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.workers: Dict[str, WorkerHealth] = {}

    def register(self, name: str) -> None:
        self.workers[name] = WorkerHealth(name, self.clock())

    def beat(self, name: str) -> None:
        w = self.workers[name]
        w.last_beat = self.clock()
        w.alive = True

    def check(self) -> List[str]:
        """Returns newly-dead worker names."""
        now = self.clock()
        dead = []
        for w in self.workers.values():
            if w.alive and now - w.last_beat > self.timeout:
                w.alive = False
                w.failures += 1
                dead.append(w.name)
        return dead

    def alive_workers(self) -> List[str]:
        return [w.name for w in self.workers.values() if w.alive]


@dataclass
class RecoveryEvent:
    t: float
    worker: str
    action: str  # restart | elastic_downsize | spare_swap
    detail: str = ""


class RecoveryCoordinator:
    """Policy: use a hot spare if available; otherwise downsize the mesh if
    the job tolerates it (>= min_workers); otherwise restart-in-place and
    wait for the scheduler to reprovision."""

    def __init__(self, registry: HeartbeatRegistry, min_workers: int = 1,
                 spares: Optional[List[str]] = None):
        self.reg = registry
        self.min_workers = min_workers
        self.spares = list(spares or [])
        self.log: List[RecoveryEvent] = []

    def tick(self) -> List[RecoveryEvent]:
        events = []
        for dead in self.reg.check():
            if self.spares:
                spare = self.spares.pop(0)
                self.reg.register(spare)
                ev = RecoveryEvent(self.reg.clock(), dead, "spare_swap",
                                   f"replaced by {spare}")
            elif len(self.reg.alive_workers()) >= self.min_workers:
                ev = RecoveryEvent(self.reg.clock(), dead, "elastic_downsize",
                                   f"{len(self.reg.alive_workers())} left")
            else:
                ev = RecoveryEvent(self.reg.clock(), dead, "restart",
                                   "below min_workers; full restart")
            self.log.append(ev)
            events.append(ev)
        return events
