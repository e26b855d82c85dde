"""Refcounted physical-page allocator for the paged KV pool.

The device side of paging is a physical-page leading axis on every big KV
leaf plus one int32 page table per slot (see ``TierEngine``); this module is
the HOST side: which physical pages are free, who holds references to each,
and the gauges the scheduler observes (``pages_total`` / ``pages_free`` /
``pages_shared`` / high-water mark).

Page 0 is the **null page**: every unmapped page-table entry points at it,
so device gathers and scatters never need bounds checks — null-page content
is garbage by construction and every read of it is masked out via the
per-slot absolute-position ``pos`` leaf (pos = -1 entries score ``-1e30``
and underflow to an exact 0 after the softmax exp).

Sharing is plain refcounting: a prefix-store entry or a second slot mapping
the same physical page increfs it; the page returns to the free list when
the LAST reference drops. Copy-on-write discipline is enforced by the
engine: a shared page is only ever mapped strictly BEHIND a slot's write
frontier (the partial boundary page is copied into a fresh private page at
warm admission), so no jitted step ever needs to fault a write.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

__all__ = ["PagePool", "pages_needed"]


def pages_needed(total_rows: int, page_size: int, max_seq: int) -> int:
    """Pages covering ``total_rows`` KV rows, capped at a full sequence."""
    rows = min(max(int(total_rows), 0), int(max_seq))
    return -(-rows // int(page_size))  # ceil


class PagePool:
    """Free-list + refcount bookkeeping over ``num_pages`` physical pages.

    Page ids run 0..num_pages; id 0 is the pinned null page and is never
    handed out. ``page_bytes`` is the per-page device footprint summed over
    every pooled cache leaf (used only for gauge reporting).
    """

    def __init__(self, num_pages: int, page_size: int,
                 page_bytes: float = 0.0):
        if num_pages < 1:
            raise ValueError(f"pool needs >= 1 page, got {num_pages}")
        self.num_pages = int(num_pages)  # excludes the null page
        self.page_size = int(page_size)
        self.page_bytes = float(page_bytes)
        # refcnt[0] is the null page, pinned forever
        self.refcnt = np.zeros((self.num_pages + 1,), np.int32)
        self.refcnt[0] = 1
        # LIFO free list: recently freed pages are re-used first (their
        # device lines are most likely still resident)
        self.free_list: List[int] = list(range(self.num_pages, 0, -1))
        self.high_water = 0

    # -- allocation --------------------------------------------------------

    @property
    def pages_free(self) -> int:
        return len(self.free_list)

    @property
    def pages_used(self) -> int:
        return self.num_pages - len(self.free_list)

    @property
    def pages_shared(self) -> int:
        """Physical pages mapped by more than one reader (CoW dedup wins)."""
        return int((self.refcnt[1:] > 1).sum())

    def can_alloc(self, n: int) -> bool:
        return n <= len(self.free_list)

    def alloc(self, n: int) -> Optional[List[int]]:
        """Pop ``n`` fresh pages (refcount 1 each); None if short."""
        if n > len(self.free_list):
            return None
        pages = [self.free_list.pop() for _ in range(n)]
        for p in pages:
            assert self.refcnt[p] == 0, (p, int(self.refcnt[p]))
            self.refcnt[p] = 1
        self.high_water = max(self.high_water, self.pages_used)
        return pages

    def incref(self, pages: Sequence[int]) -> None:
        for p in pages:
            p = int(p)
            if p == 0:
                continue
            assert self.refcnt[p] > 0, f"incref of free page {p}"
            self.refcnt[p] += 1

    def decref(self, pages: Sequence[int]) -> int:
        """Drop one reference per page; freed pages rejoin the free list.
        Returns how many pages were physically freed."""
        freed = 0
        for p in pages:
            p = int(p)
            if p == 0:
                continue
            assert self.refcnt[p] > 0, f"decref of free page {p}"
            self.refcnt[p] -= 1
            if self.refcnt[p] == 0:
                self.free_list.append(p)
                freed += 1
        return freed

    def reown(self, owners: Sequence[int]) -> None:
        """Rebuild allocator state from a flat list of page references (one
        entry PER REFERENCE — a page shared by two owners appears twice).
        Restore path: the snapshot records who owns what; refcounts and the
        free list are derived rather than trusted."""
        self.refcnt[:] = 0
        self.refcnt[0] = 1
        for p in owners:
            p = int(p)
            if p:
                self.refcnt[p] += 1
        self.free_list = [p for p in range(self.num_pages, 0, -1)
                          if self.refcnt[p] == 0]
        self.high_water = max(self.high_water, self.pages_used)

    # -- gauges / snapshot -------------------------------------------------

    def gauges(self) -> dict:
        return {
            "pages_total": self.num_pages,
            "pages_free": self.pages_free,
            "pages_shared": self.pages_shared,
            "pages_high_water": self.high_water,
            "page_bytes": self.page_bytes,
        }

    def snapshot(self) -> dict:
        return {"refcnt": self.refcnt.copy(),
                "free_list": list(self.free_list),
                "high_water": self.high_water}

    def restore(self, snap: dict) -> None:
        self.refcnt = snap["refcnt"].copy()
        self.free_list = list(snap["free_list"])
        self.high_water = snap["high_water"]

    def check(self) -> None:
        """Invariant check (tests): every page is free xor referenced."""
        free = set(self.free_list)
        assert len(free) == len(self.free_list), "duplicate free pages"
        for p in range(1, self.num_pages + 1):
            rc = int(self.refcnt[p])
            assert rc >= 0, (p, rc)
            assert (rc == 0) == (p in free), (p, rc, p in free)
        assert int(self.refcnt[0]) >= 1
