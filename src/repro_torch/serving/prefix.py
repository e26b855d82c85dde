"""Tier-local prefix & session KV stores: the hit/miss logic shared by BOTH
execution backends.

``PrefixStore`` holds cache rows keyed by the exact bytes of a token prefix
(plus an extras fingerprint covering any modality payload that occupies
cache positions, e.g. a VLM's image patches). Entries are inserted at
bucket-aligned prefix lengths — the same power-of-two ladder the engine's
bucketed prefill uses — so a lookup only probes the handful of lengths the
store actually holds, longest first. The store is bounded in bytes and
LRU-evicted.

``SessionStore`` parks ONE payload per session id between turns. A resume is
a hit when the new prompt token-for-token extends the parked conversation
(prompt + generated tokens of the previous turn) with at least one new
token.

The ``data`` slot of an entry is opaque to the store: the live
``TierEngine`` keeps real per-slot cache rows (numpy leaves), the
``AnalyticBackend`` keeps only the virtual sizes — both run the SAME
insert/lookup code, so their hit/miss decision traces are identical by
construction (byte budgets aside: the analytic store prices entries with the
analytic ``slot_payload_bytes``, so under a budget tight enough to evict,
eviction order may differ from the live store's exact accounting).
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

__all__ = ["PrefixEntry", "PrefixStore", "SessionStore", "ParkedSession",
           "extension_suffix", "prefix_buckets", "extras_fingerprint"]


def extras_fingerprint(extras: Optional[Dict[str, Any]]) -> bytes:
    """Stable content hash of prefill extras (e.g. vision patches). Two
    prompts share cache positions only when their extras are identical —
    the image occupies the leading positions of a VLM prompt."""
    if not extras:
        return b""
    h = hashlib.sha1()
    for name in sorted(extras):
        arr = np.asarray(extras[name])
        h.update(name.encode())
        h.update(str(arr.dtype).encode())
        h.update(str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.digest()


def prefix_buckets(n: int, lo: int = 16) -> List[int]:
    """Bucket-aligned prefix lengths to index a prompt of ``n`` tokens at:
    the power-of-two ladder up to n, plus n itself. Matches the prefill
    bucket ladder so stored prefixes line up with how prompts batch."""
    out = []
    b = lo
    while b < n:
        out.append(b)
        b *= 2
    if n >= lo:
        out.append(n)
    return out


def extension_suffix(cached: np.ndarray, tokens: np.ndarray
                     ) -> Optional[np.ndarray]:
    """The new tokens past ``cached`` when ``tokens`` strictly extends it
    (>= 1 new token), else None."""
    n = len(cached)
    if len(tokens) <= n:
        return None
    if not np.array_equal(np.asarray(tokens[:n]), np.asarray(cached)):
        return None
    return np.asarray(tokens[n:])


@dataclass
class PrefixEntry:
    tokens: np.ndarray  # the exact prefix tokens this entry covers
    extras_fp: bytes
    nbytes: float  # budget charge (live: real row bytes; analytic: priced)
    data: Any = None  # opaque to the store (cache rows / nothing)
    sliceable: bool = True  # rows positionally addressable (dense KV)


class _LRUBytes:
    """OrderedDict-backed LRU with a byte budget (0 disables the store)."""

    def __init__(self, budget_bytes: float):
        self.budget = float(budget_bytes)
        self._d: OrderedDict = OrderedDict()
        self.bytes = 0.0
        self.evictions = 0
        # fired with the entry on EVERY removal (evict / pop / overwrite):
        # the paged engine decrefs an entry's pool pages here, so dropping
        # a store reference and freeing physical pages can never diverge
        self.on_evict = None

    def __len__(self) -> int:
        return len(self._d)

    def get(self, key):
        e = self._d.get(key)
        if e is not None:
            self._d.move_to_end(key)
        return e

    def put(self, key, entry, nbytes: float) -> bool:
        if self.budget <= 0 or nbytes > self.budget:
            return False
        old = self._d.pop(key, None)
        if old is not None:
            self.bytes -= old.nbytes
            if self.on_evict is not None:
                self.on_evict(old)
        self._d[key] = entry
        self.bytes += nbytes
        while self.bytes > self.budget and len(self._d) > 1:
            _, ev = self._d.popitem(last=False)
            self.bytes -= ev.nbytes
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(ev)
        if self.bytes > self.budget:  # the sole entry is itself too big
            _, ev = self._d.popitem(last=False)
            self.bytes = 0.0
            self.evictions += 1
            if self.on_evict is not None:
                self.on_evict(ev)
            return False
        return True

    def pop(self, key):
        e = self._d.pop(key, None)
        if e is not None:
            self.bytes -= e.nbytes
            if self.on_evict is not None:
                self.on_evict(e)
        return e

    def contains(self, key) -> bool:
        """Membership probe WITHOUT touching recency."""
        return key in self._d

    def keys(self):
        return self._d.keys()


class PrefixStore:
    """Bounded, LRU-evicted store of token-prefix cache rows."""

    def __init__(self, budget_bytes: float, min_prefix: int = 16):
        self.lru = _LRUBytes(budget_bytes)
        self.min_prefix = int(min_prefix)
        self._lengths: Dict[int, int] = {}  # prefix length -> live entries

    @property
    def enabled(self) -> bool:
        return self.lru.budget > 0

    @property
    def evictions(self) -> int:
        return self.lru.evictions

    @staticmethod
    def _key(extras_fp: bytes, tokens: np.ndarray) -> Tuple[bytes, int, bytes]:
        t = np.ascontiguousarray(np.asarray(tokens, np.int64))
        return (extras_fp, len(t), hashlib.sha1(t.tobytes()).digest())

    def insert(self, tokens: np.ndarray, extras_fp: bytes, nbytes: float,
               data: Any = None, sliceable: bool = True) -> bool:
        """Store rows covering exactly ``tokens``. Returns False when the
        store is disabled, the entry exceeds the whole budget, or an entry
        for this prefix already exists (first writer wins: identical
        prefixes produce identical rows, so re-extraction is pure waste)."""
        if not self.enabled or len(tokens) < self.min_prefix:
            return False
        key = self._key(extras_fp, tokens)
        if self.lru.get(key) is not None:
            return False
        entry = PrefixEntry(tokens=np.asarray(tokens).copy(),
                            extras_fp=extras_fp, nbytes=float(nbytes),
                            data=data, sliceable=sliceable)
        before = set(self.lru.keys())
        if not self.lru.put(key, entry, float(nbytes)):
            return False
        self._recount(before)
        return True

    def _recount(self, before) -> None:
        after = set(self.lru.keys())
        for k in before - after:
            n = k[1]
            self._lengths[n] -= 1
            if not self._lengths[n]:
                del self._lengths[n]
        for k in after - before:
            self._lengths[k[1]] = self._lengths.get(k[1], 0) + 1

    def evict_oldest(self) -> Optional[PrefixEntry]:
        """Force out the least-recently-used entry (fires ``on_evict``).
        The paged engine calls this under page pressure: store-held pages
        are spare capacity, reclaimed before a request is ever blocked."""
        if not len(self.lru):
            return None
        before = set(self.lru.keys())
        key = next(iter(self.lru.keys()))
        e = self.lru.pop(key)
        self.lru.evictions += 1
        self._recount(before)
        return e

    def contains(self, tokens: np.ndarray, extras_fp: bytes) -> bool:
        """Exact-prefix membership probe (no recency touch)."""
        return self.lru.contains(self._key(extras_fp, tokens))

    def lookup(self, tokens: np.ndarray, extras_fp: bytes
               ) -> Optional[PrefixEntry]:
        """Longest stored prefix that ``tokens`` strictly extends (the hit
        must leave >= 1 suffix token to produce the next-token logits)."""
        tokens = np.asarray(tokens)
        for n in sorted(self._lengths, reverse=True):
            if n >= len(tokens) or n < self.min_prefix:
                continue
            key = self._key(extras_fp, tokens[:n])
            e = self.lru.get(key)
            if e is not None and np.array_equal(e.tokens, tokens[:n]):
                return e
        return None


@dataclass
class ParkedSession:
    """One parked turn: the tokens the cache rows cover (prompt + generated
    minus the final sampled-but-not-fed token) and an opaque payload."""

    tokens: np.ndarray
    extras_fp: bytes
    nbytes: float
    data: Any = None
    turns: int = 1
    meta: Dict[str, Any] = field(default_factory=dict)


class SessionStore:
    """LRU-bounded sid -> ParkedSession map (one payload per session)."""

    def __init__(self, budget_bytes: float):
        self.lru = _LRUBytes(budget_bytes)

    @property
    def enabled(self) -> bool:
        return self.lru.budget > 0

    @property
    def evictions(self) -> int:
        return self.lru.evictions

    def __len__(self) -> int:
        return len(self.lru)

    def __contains__(self, sid: str) -> bool:
        return self.lru.contains(sid)  # probe only: no recency touch

    def park(self, sid: str, parked: ParkedSession) -> bool:
        parked.nbytes = float(parked.nbytes)
        return self.lru.put(sid, parked, parked.nbytes)

    def ids(self) -> List[str]:
        """Parked session ids, LRU order (oldest first)."""
        return list(self.lru.keys())

    def peek(self, sid: str) -> Optional[ParkedSession]:
        return self.lru.get(sid)

    def resume(self, sid: str) -> Optional[ParkedSession]:
        """Pop the parked payload (its rows are consumed by the resume)."""
        return self.lru.pop(sid)
