"""Spans of the serving path, on the host's monotonic clock.

A span is one :class:`Span` record: its name, start and end on
``time.monotonic_ns()`` (the clock the runtime, the engines and their
callers use), its own id, the id of the span that was open when it began
(its parent, 0 for none), the request it belongs to (``rid``), the tier
whose engine ran it (``tier``) and a small dict of attributes. Spans stay
in memory, at most :data:`CAPACITY` of them; the ones past that are
counted in :data:`dropped`. They leave only through :func:`records` and
:func:`clear`.

The tracer records while a ``torch.profiler`` session is open (whatever
its activities) and after :func:`enable`, until :func:`disable`. Off, a
site costs one call that reads two flags and returns 0: no object is made.
A site reads::

    sp = tracing.begin("engine.step", tier=self.tier)
    ...
    tracing.end(sp)                  # or, with attributes built only when on:
    if sp:
        tracing.end(sp, k=k, slots=[...])

``end`` closes the span it is given and forgets, unrecorded, any span
opened inside it that is still open (one an exception skipped), so an
outer span that always ends keeps the nesting whole. The serving path
runs on one thread, and so does the tracer. A span whose start and end
fall in different outer spans is recorded whole when it ends, with no
parent (:func:`record`); it is the one span that does not nest.

The profiler stamps its events on ``time.time_ns()``; a reader maps a
span onto them with the offset its device trace was mapped with
(``moabench/trace.py``'s ``DeviceTrace.offset_ns``).

The spans, their attributes (``rid``/``tier`` are the record's own
fields; times in attributes are ``time.monotonic()`` seconds) and what
reads each in ``moabench/`` (a metric by its name; "idle" is
``program_spans.idle_gaps`` and ``idle_by_span``, which name each idle
stretch of the device by the innermost span open at its middle):

* ``runtime.event`` (rid where the payload has a request or job): one
  event the runtime handled; ``kind``, ``due`` (the event's time; for an
  arrival, start - due is its wait for the event loop).
  ``runtime.arrival_wait_ms``; idle.
* ``runtime.advance``: one ``backend.advance()``; ``runtime.doze``: the
  live backend's idle sleep inside it; ``runtime.prepare_prompt`` (rid):
  a prompt's tokens and image patches made for its engine. Idle.
* ``engine.step`` (tier): one ``TierEngine.step``. Idle.
* ``engine.prefill_group`` (tier): ``bucket``, ``rows_padded`` and
  ``rows``, one ``(rid, text tokens, has image, received)`` a request,
  ``received`` being when the engine was given it; ``kv_pages``, the
  pool pages the group's K/V was written into (its rows' reserved pages;
  0 off a paged pool of positional pages).
  ``engine.queue_wait_ms``, ``engine.prefill_device_busy_pct``,
  ``engine.page_wait_ms`` (``kv_pages`` marks a program that records
  page waits); idle.
  Its children, each read by idle:
  ``engine.prefill.stage`` (the host batch and its copy to the device),
  ``engine.prefill.issue`` (the prefill and the cache scatter launched),
  ``engine.prefill.sync`` (the logits copied to the host),
  ``engine.prefill.start`` (each row's first token and callbacks).
* ``engine.decode_block`` (tier): ``k``, ``teff`` and ``slots``, one
  ``(rid, position, budget)`` a live slot; ``graph``, true when every
  step of the block was a CUDA graph's replay (the engine's
  ``decode_graph_steps`` / ``decode_eager_steps`` count the steps); on a
  paged engine ``pages_used`` (the pool's pages in use as the block
  starts) and ``pool_pages`` (its pages, the null page left out), whose
  ratio on the remote tier ``engine.kv_pool_used_pct`` reads;
  ``rows_live``, the context rows the block's live slots attend
  (position + 1 at each step a slot lives), and ``rows_grid``, the rows
  of its grid (B x ``teff`` a step): their ratio is the share of the grid
  a paged decode with extents reads. The engine sums both over its
  blocks (``decode_rows_live``, ``decode_rows_grid``), traced or not.
  ``engine.decode_device_busy_pct``, ``engine.decode_issue_ms`` (its
  ``k``); idle. Its children: ``engine.decode.issue`` (entry to the last
  launch of the k steps: the inputs' copies to the device and the k
  replays, or the k steps' eager launches and any capture;
  ``engine.decode_issue_ms``, idle) and
  ``engine.decode.sync`` (the token block copied to the host; idle).
* ``engine.emit`` (tier): the block's tokens handed out, callbacks
  included. Idle.
* ``engine.page_wait`` (tier, rid; recorded by :func:`record`, no
  parent): from the admission pass in which the request, at the head of
  the engine's queue, found too few free pages in the pool to the one
  that reserved them. The engine also counts every such wait
  (``page_waits``) and its seconds (``page_wait_s``), traced or not.
  ``engine.page_wait_ms`` (0 for an admitted row that never waited).
"""
from __future__ import annotations

import itertools
import time
from typing import Any, Dict, List, NamedTuple, Optional

from torch.autograd import profiler as _profiler

#: most spans held; later ones are counted in :data:`dropped`
CAPACITY = 1 << 20


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int
    rid: Optional[int]
    tier: Optional[str]
    attrs: Dict[str, Any]


_enabled = False
_spans: List[Span] = []
# open spans, innermost last: (id, name, rid, tier, parent, t0_ns)
_open: List[tuple] = []
_ids = itertools.count(1)
#: spans lost because the buffer was full
dropped = 0


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def on() -> bool:
    """Whether a span begun now is recorded."""
    return _enabled or _profiler._is_profiler_enabled


def begin(name: str, rid: Optional[int] = None,
          tier: Optional[str] = None) -> int:
    """Open a span; returns its id, or 0 when the tracer is off."""
    if not (_enabled or _profiler._is_profiler_enabled):
        return 0
    sid = next(_ids)
    _open.append((sid, name, rid, tier, _open[-1][0] if _open else 0,
                  time.monotonic_ns()))
    return sid


def end(sid: int, rid: Optional[int] = None, **attrs) -> None:
    """Close span ``sid`` (forgetting any still open inside it); ``rid``
    sets the span's request where its start did not know it."""
    global dropped
    if not sid:
        return
    t1 = time.monotonic_ns()
    for i in range(len(_open) - 1, -1, -1):
        if _open[i][0] == sid:
            break
    else:
        return
    _, name, rid0, tier, parent, t0 = _open[i]
    del _open[i:]
    if len(_spans) >= CAPACITY:
        dropped += 1
        return
    _spans.append(Span(name, t0, t1, sid, parent,
                       rid0 if rid is None else rid, tier, attrs))


def record(name: str, t0_ns: int, rid: Optional[int] = None,
           tier: Optional[str] = None, **attrs) -> int:
    """Record a span that began at ``t0_ns`` (``time.monotonic_ns()``) and
    ends now, with no parent: one whose start and end fall in different
    outer spans. Returns its id, or 0 when the tracer is off."""
    global dropped
    if not (_enabled or _profiler._is_profiler_enabled):
        return 0
    sid = next(_ids)
    if len(_spans) >= CAPACITY:
        dropped += 1
        return sid
    _spans.append(Span(name, t0_ns, time.monotonic_ns(), sid, 0, rid, tier,
                       attrs))
    return sid


def records(t0: Optional[float] = None,
            t1: Optional[float] = None) -> List[Span]:
    """The spans recorded, in the order they ended; with ``t0``/``t1``
    (``time.monotonic()`` seconds) only those that began inside."""
    lo = -float("inf") if t0 is None else t0
    hi = float("inf") if t1 is None else t1
    return [s for s in _spans if lo <= s.t0_ns / 1e9 <= hi]


def clear() -> None:
    """Forget every recorded span and the dropped count."""
    global dropped
    _spans.clear()
    dropped = 0

