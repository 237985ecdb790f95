"""Paged KV-cache bookkeeping for the serving engine (MaxText idiom); a
copy of ``repro/serve/page_manager.py`` (numpy only).

The contiguous engine allocates every slot a full ``max_context`` cache up
front, so slot *memory* — not compute — caps concurrency. Paged mode carves
each KV leaf's sequence axis into fixed-size pages held in one shared pool
and gives every slot a small page *table* instead: logical page ``l`` of a
slot lives at physical pool page ``table[slot, l]``. A slot then holds
``ceil(tokens_written / page_size)`` pages — O(tokens generated) — and the
pool is shared across slots, so short requests no longer pay for the long
tail of the context window.

This module is the host-side half: a free-list allocator over physical page
indices plus the per-slot page tables (numpy, copied to the device each
tick). The device-side half — the gather view
that reconstructs a slot's logical cache and the scatter that writes one
decoded token through the table — lives in
``models/transformer.py:attn_block_decode_paged``.

Exactness contract (the reason the layout looks the way it does): with
``num_logical_pages * page_size == max_context`` the gathered logical view
is shape-identical to the contiguous cache, and every position the
attention mask admits (``kpos <= pos``) is backed by an allocated page with
identical contents. Unallocated logical pages are only ever read at masked
positions, where softmax turns them into exact zeros — so paged decode is
*bitwise* identical to contiguous decode (asserted in
``tests/test_torch_serve.py`` and on the card by ``chip_smoke.py``).

One extra physical page (index ``num_pages``) is reserved as a scratch
target so that inactive batch lanes — which still flow through the fused
decode step — scatter their dead writes somewhere harmless instead of
corrupting a live page.
"""
from __future__ import annotations

import numpy as np


class PageManager:
    """Free-list page allocator + per-slot page tables for one engine.

    ``num_pages`` physical pages of ``page_size`` token slots each are
    shared by ``slots`` decode lanes; every lane's logical address space is
    ``max_context`` tokens (``max_context // page_size`` logical pages).
    ``num_pages`` must cover at least one full lane so a sole runner can
    always finish (the engine's preemption loop relies on this floor).
    """

    def __init__(self, *, num_pages: int, page_size: int, slots: int,
                 max_context: int) -> None:
        """Validate the geometry and start with every page free."""
        if page_size <= 0 or max_context % page_size:
            raise ValueError(
                f"page_size {page_size} must divide max_context {max_context}")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.slots = int(slots)
        self.max_context = int(max_context)
        self.logical_pages = max_context // page_size
        if num_pages < self.logical_pages:
            raise ValueError(
                f"num_pages {num_pages} < {self.logical_pages} logical pages:"
                f" a single request filling max_context could never be"
                f" served")
        # Lowest-index-first allocation: deterministic, and page churn stays
        # observable (a leak shows up as a monotonically climbing index).
        self._free: list[int] = list(range(self.num_pages))
        # -1 = unallocated. The device side maps -1 reads to page 0 (masked
        # positions only) and -1 writes to the reserved scratch page.
        self.tables = np.full((slots, self.logical_pages), -1, np.int32)
        self.in_use = 0
        self.hwm_pages = 0

    # ---------------------------------------------------------- allocation --
    def _take(self, n: int) -> list[int] | None:
        if n > len(self._free):
            return None
        pages, self._free = self._free[:n], self._free[n:]
        self.in_use += n
        self.hwm_pages = max(self.hwm_pages, self.in_use)
        return pages

    def reserve_prefill(self, slot: int, length: int) -> bool:
        """Allocate and map pages covering positions ``[0, length)`` of
        ``slot`` (admission: the spliced prefill cache). False = pool dry,
        nothing changed."""
        n = max(1, -(-length // self.page_size))
        pages = self._take(n)
        if pages is None:
            return False
        self.tables[slot, :n] = pages
        return True

    def ensure(self, slot: int, pos: int) -> bool:
        """Ensure the page backing position ``pos`` of ``slot`` is mapped
        (one decode step writes exactly one position). False = pool dry."""
        lp = pos // self.page_size
        if lp >= self.logical_pages:
            return True  # engine retires at the context edge; nothing to map
        if self.tables[slot, lp] >= 0:
            return True
        pages = self._take(1)
        if pages is None:
            return False
        self.tables[slot, lp] = pages[0]
        return True

    def release(self, slot: int) -> int:
        """Free every page held by ``slot`` (retire / preempt); returns the
        number of pages returned to the free list."""
        held = [int(p) for p in self.tables[slot] if p >= 0]
        if held:
            self._free.extend(held)
            self._free.sort()
            self.in_use -= len(held)
        self.tables[slot, :] = -1
        return len(held)

    # ----------------------------------------------------------- reporting --
    def pages_of(self, slot: int) -> int:
        """Number of physical pages currently mapped for ``slot``."""
        return int((self.tables[slot] >= 0).sum())

    def occupancy(self) -> float:
        """Fraction of the pool currently allocated."""
        return self.in_use / self.num_pages if self.num_pages else 0.0

    def report(self) -> dict:
        """Allocator counters for telemetry and the engine's cache report."""
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "in_use": self.in_use,
            "free": len(self._free),
            "hwm_pages": self.hwm_pages,
            "occupancy": self.occupancy(),
        }
