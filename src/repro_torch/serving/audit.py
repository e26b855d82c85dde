"""Runtime invariant auditor: turn "the chaos bench looked fine" into a
machine-checked claim.

:class:`InvariantAuditor` hangs off a :class:`ClusterRuntime`
(``ClusterRuntime(..., audit=True)``) and, at completion/teardown,
asserts the invariants that must hold under ANY fault schedule — tier
crashes, byzantine wires, replica losses:

* **exactly-once completion** — every submitted request reached exactly
  ONE terminal ``Outcome`` (never zero, never two: a duplicated finish
  frame or a replayed resubmit must not double-serve or double-charge);
* **clean token streams** — every delivery guard's ledger closed with no
  unresolved gap, no held reordered frame and no undrained messages
  (duplicate/gap-free delivery is enforced AT the wire, so a clean
  ledger is the stream-level invariant);
* **no stuck plumbing** — no WAN link ``Station`` left busy or queued,
  no backend in-flight entries, no pool ownership rows for finished
  requests;
* **resource conservation** — every engine slot free, waiting queues
  empty, and the paged KV pool's refcount/free-list conservation
  (``PagePool.check``: each page free XOR referenced) intact, so chaos
  can never leak pages or slots;
* **no undetected corruption** — every wire the chaos layer tampered
  with was caught by a checksum (``wire_stats["corrupt_undetected"]``
  must be zero).

The auditor only *reads* runtime/backend/engine state; backends expose
their residue via an ``audit_residue() -> List[str]`` hook. The verdict
is a plain dict (``{"clean": bool, "violations": [...], ...}``) — the
soak bench commits it to ``BENCH_cluster.json`` and tests assert on it.
"""
from __future__ import annotations

from collections import Counter
from typing import Dict, List

__all__ = ["InvariantAuditor"]


class InvariantAuditor:
    """Read-only invariant checks over one runtime and its backend."""

    def __init__(self, runtime):
        self.rt = runtime
        self.last: Dict = {}

    # -- checks --------------------------------------------------------------

    def _check_outcomes(self) -> List[str]:
        out: List[str] = []
        rt = self.rt
        counts = Counter(o.rid for o in rt.outcomes)
        for rid, c in sorted(counts.items()):
            if c > 1:
                out.append(f"rid {rid} reached {c} terminal Outcomes")
            if rid not in rt.records:
                out.append(f"rid {rid} has an Outcome but no record")
        for rid, rec in sorted(rt.records.items()):
            n = counts.get(rid, 0)
            if n == 0:
                out.append(f"rid {rid} submitted but reached no terminal "
                           f"Outcome")
            if n >= 1 and not rec.done:
                out.append(f"rid {rid} has an Outcome but record.done is "
                           f"False")
        return out

    def _check_stations(self) -> List[str]:
        out: List[str] = []
        for name, st in sorted(self.rt.links.items()):
            if st.busy:
                out.append(f"link station {name!r} left busy={st.busy}")
            if st.queue:
                out.append(f"link station {name!r} left {len(st.queue)} "
                           f"queued transfers")
        return out

    def _check_wire(self) -> List[str]:
        ws = self.rt.wire_stats
        n = ws.get("corrupt_undetected", 0)
        if n:
            return [f"{n} tampered wire(s) were injected WITHOUT a "
                    f"checksum failure (undetected corruption)"]
        return []

    def final_check(self) -> Dict:
        """Run every invariant; returns (and remembers) the verdict."""
        violations: List[str] = []
        violations += self._check_outcomes()
        violations += self._check_stations()
        violations += self._check_wire()
        residue = getattr(self.rt.backend, "audit_residue", None)
        if residue is not None:
            violations += residue()
        self.last = {
            "clean": not violations,
            "violations": violations,
            "requests": len(self.rt.records),
            "outcomes": len(self.rt.outcomes),
            "wire": dict(self.rt.wire_stats),
        }
        return self.last
