"""Per-tier health state machine: the runtime's circuit breaker.

Each tier walks ``healthy -> suspect -> quarantined -> probing -> healthy``
driven by the failure edges the runtime already produces (heartbeat-detected
service faults, transfer timeouts) plus a failure-rate EWMA:

* ``healthy``  — routable; ``suspect_after`` consecutive failures -> suspect.
* ``suspect``  — still routable (a degraded signal the scheduler can weigh),
  one success heals it; ``quarantine_after`` consecutive failures ->
  quarantined.
* ``quarantined`` — the circuit is OPEN: the policy and the runtime route
  around the tier. After ``probe_after_s`` of cool-down the next admission
  request is let through as a *probe*.
* ``probing`` — exactly one in-flight probe; success closes the circuit
  (healthy), failure re-opens it (quarantined, cool-down restarts).

The monitor publishes ``snapshot()`` — tier name -> state string — which the
runtime feeds into ``SystemState.health`` for the scheduler, and answers
``available``/``admit`` for the runtime's own degraded-routing decisions.
All transitions are pure functions of the (time, event) sequence, so the
analytic and live backends drive identical state trajectories from
identical fault plans.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable

from repro_torch.config import ResilienceConfig

__all__ = ["HEALTHY", "SUSPECT", "QUARANTINED", "PROBING",
           "TierHealth", "HealthMonitor", "retry_backoff_s"]

HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"
PROBING = "probing"


def retry_backoff_s(cfg: ResilienceConfig, rid: int, attempt: int) -> float:
    """Capped exponential backoff with deterministic jitter.

    ``attempt`` is 1-based (the first retry waits ~base). The jitter is a
    hash of (rid, attempt) — no rng stream is consumed, so backoff can
    never perturb the golden fault/accuracy draws, and both backends
    compute the identical delay."""
    base = cfg.backoff_base_s * (2.0 ** (max(attempt, 1) - 1))
    jitter = ((rid * 1_000_003 + attempt * 7_919) % 997) / 997.0
    return min(base, cfg.backoff_cap_s) * (1.0 + cfg.backoff_jitter * jitter)


@dataclass
class TierHealth:
    """One tier's breaker state + failure statistics."""

    state: str = HEALTHY
    consecutive_failures: int = 0
    failure_ewma: float = 0.0  # EWMA of the per-attempt failure indicator
    quarantined_at: float = 0.0  # epoch-relative time the circuit opened
    failures: int = 0
    successes: int = 0
    heartbeat_ok: bool = True


class HealthMonitor:
    """Failure-driven circuit breaker over the topology's tiers."""

    def __init__(self, tiers: Iterable[str], cfg: ResilienceConfig):
        self.cfg = cfg
        self.tiers: Dict[str, TierHealth] = {t: TierHealth() for t in tiers}
        self.quarantine_count = 0  # circuit-open transitions (monotonic)
        self.probe_count = 0

    # -- event feeds ---------------------------------------------------------

    def record_failure(self, tier: str, t: float) -> bool:
        """One failed attempt on ``tier`` at epoch-relative ``t``. Returns
        True when this failure OPENED the circuit (healthy/suspect ->
        quarantined, or a failed probe re-opening it) — the runtime's cue
        to rescue parked sessions."""
        h = self.tiers.get(tier)
        if h is None:
            return False
        a = self.cfg.failure_ewma_alpha
        h.failure_ewma = (1 - a) * h.failure_ewma + a
        h.failures += 1
        h.consecutive_failures += 1
        if h.state == PROBING:
            # the probe died: re-open, restart the cool-down
            h.state = QUARANTINED
            h.quarantined_at = t
            self.quarantine_count += 1
            return True
        if h.state == QUARANTINED:
            return False
        if h.consecutive_failures >= self.cfg.quarantine_after:
            h.state = QUARANTINED
            h.quarantined_at = t
            self.quarantine_count += 1
            return True
        if h.consecutive_failures >= self.cfg.suspect_after:
            h.state = SUSPECT
        return False

    def record_success(self, tier: str) -> None:
        """One completed attempt on ``tier``: heals suspect tiers and
        closes the circuit when it was the in-flight probe."""
        h = self.tiers.get(tier)
        if h is None:
            return
        a = self.cfg.failure_ewma_alpha
        h.failure_ewma = (1 - a) * h.failure_ewma
        h.successes += 1
        h.consecutive_failures = 0
        if h.state in (SUSPECT, PROBING):
            h.state = HEALTHY

    def heartbeat(self, tier: str, ok: bool) -> None:
        """Liveness signal (live backend): a stale heartbeat marks a
        healthy tier suspect; it never opens the circuit by itself (only
        real failures do), so backends can't diverge on routing."""
        h = self.tiers.get(tier)
        if h is None:
            return
        h.heartbeat_ok = ok
        if not ok and h.state == HEALTHY:
            h.state = SUSPECT

    # -- queries -------------------------------------------------------------

    def state(self, tier: str) -> str:
        h = self.tiers.get(tier)
        return h.state if h is not None else HEALTHY

    def available(self, tier: str, t: float) -> bool:
        """Pure check: may traffic be placed on ``tier`` now? (Does NOT
        consume the probe slot — use ``admit`` on the placement path.)"""
        h = self.tiers.get(tier)
        if h is None:
            return True
        if h.state == QUARANTINED:
            return t - h.quarantined_at >= self.cfg.probe_after_s
        return h.state != PROBING

    def admit(self, tier: str, t: float) -> bool:
        """Placement check. A quarantined tier past its cool-down admits
        exactly ONE request — the probe — and transitions to probing;
        further requests are refused until the probe resolves."""
        h = self.tiers.get(tier)
        if h is None:
            return True
        if h.state == QUARANTINED:
            if t - h.quarantined_at >= self.cfg.probe_after_s:
                h.state = PROBING
                self.probe_count += 1
                return True
            return False
        if h.state == PROBING:
            return False  # one probe at a time
        return True

    def snapshot(self) -> Dict[str, str]:
        return {t: h.state for t, h in self.tiers.items()}

    def __repr__(self) -> str:
        states = ", ".join(f"{t}={h.state}" for t, h in self.tiers.items())
        return f"HealthMonitor({states})"
