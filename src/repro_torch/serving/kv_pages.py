"""Paged KV-cache bookkeeping: Attn-PIM bank-row allocator and block tables
— the port's own copy of `repro.serving.kv_pages` (host-side, numpy only).

PAPI's Attn-PIM units hold the KV cache in fixed-size DRAM banks; the
allocation quantum is one bank *row*, here called a page.  Instead of a
dense ``(slots, capacity, ...)`` slab per request, each request's KV is
mapped onto physical pages through a block table:

  logical token position  t  of slot  s
      -> logical block    t // page_size
      -> physical page    block_tables[s, t // page_size]
      -> bank row offset  t %  page_size

  * `PageAllocator` — a LIFO free list with admission reservations: a
    request is admitted only if its whole worst-case page budget is
    available, while pages are mapped as the sequence grows.  Reserved but
    unmapped pages are subtracted from the headroom every admission checks,
    so `grow()` cannot fail mid-flight, and `rewind()` keeps the
    reservation so returned pages stay claimable by their owner.
  * `BlockTables` — the host mirror of the device block tables; unmapped
    entries point at the garbage page, and the device tensor is rebuilt
    only after a row changed.
  * `PagedKVManager` — the engine-facing facade in token counts.

Physical page 0 is the garbage page: never allocated, the target of every
unmapped table entry, so the KV writes of idle slots land there and no live
request ever reads it (the paged kernel never reads an entry past a
request's length).

Invariants (tested in tests/test_torch_kv_pages.py): a page is never mapped
to two owners; free + mapped partitions the usable pool; reserved-unmapped
never exceeds the free count; a drained pool is all free again.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable

import numpy as np
import torch

GARBAGE_PAGE = 0


def pages_for(tokens: int, page_size: int) -> int:
    """Pages covering `tokens` KV entries (at least 1, so a mapped row
    always exists for the first write)."""
    return max(1, -(-int(tokens) // page_size))


@dataclasses.dataclass(frozen=True)
class PageStats:
    """Pool-level snapshot surfaced per iteration via `IterStats`."""
    num_pages: int            # usable pool size (garbage page excluded)
    page_size: int
    free: int                 # pages on the free list right now
    mapped: int               # pages currently holding live KV
    reserved_unmapped: int    # admission-reserved, not yet mapped
    watermark: int            # peak mapped page count over the pool lifetime
    fragmentation: float      # 1 - used_tokens / (mapped * page_size)


class PageAllocator:
    """Free-list page allocator with admission reservations over the pages
    ``[first_page, first_page + num_pages)``.  LIFO: recently freed pages
    are reused first.  `admit(owner, budget, initial)` maps `initial` pages
    and reserves the rest; the admission headroom is free minus reserved."""

    def __init__(self, num_pages: int, page_size: int, *, first_page: int = 0):
        assert num_pages >= 1 and page_size >= 1, (num_pages, page_size)
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.first_page = int(first_page)
        # LIFO: low page ids come off the stack first (reversed range)
        self._free: list[int] = list(
            range(first_page + num_pages - 1, first_page - 1, -1))
        self._mapped: dict[int, list[int]] = {}
        self._reserved: dict[int, int] = {}
        self.watermark = 0

    # ----------------------------------------------------------- accounting
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def mapped_count(self) -> int:
        return sum(len(p) for p in self._mapped.values())

    @property
    def reserved_unmapped(self) -> int:
        return sum(self._reserved.values())

    @property
    def available(self) -> int:
        """Pages an admission may still claim (free minus promised)."""
        return len(self._free) - self.reserved_unmapped

    def owners(self) -> list[int]:
        return list(self._mapped)

    def pages_of(self, owner: int) -> list[int]:
        return list(self._mapped.get(owner, ()))

    # ------------------------------------------------------------ lifecycle
    def can_admit(self, budget_pages: int) -> bool:
        return 0 < budget_pages <= self.available

    def admit(self, owner: int, budget_pages: int,
              initial_pages: int) -> list[int]:
        """Reserve `budget_pages` for `owner`, mapping `initial_pages` now."""
        assert owner not in self._mapped and owner not in self._reserved, owner
        assert 1 <= initial_pages <= budget_pages, (initial_pages, budget_pages)
        if not self.can_admit(budget_pages):
            raise MemoryError(
                f"admit({owner}): {budget_pages} pages > {self.available} "
                "available")
        pages = [self._free.pop() for _ in range(initial_pages)]
        self._mapped[owner] = pages
        self._reserved[owner] = budget_pages - initial_pages
        self.watermark = max(self.watermark, self.mapped_count)
        return list(pages)

    def grow(self, owner: int, n_pages: int) -> list[int]:
        """Map `n_pages` more for `owner`: from its reservation first
        (always there), beyond it from the uncommitted headroom, which is
        the only part that can fail."""
        if n_pages <= 0:
            return []
        assert owner in self._mapped, owner
        over = n_pages - self._reserved[owner]
        if over > 0 and over > self.available:
            raise MemoryError(
                f"grow({owner}, {n_pages}): {over} pages beyond the "
                f"reservation, {self.available} uncommitted available")
        pages = [self._free.pop() for _ in range(n_pages)]
        self._mapped[owner].extend(pages)
        self._reserved[owner] = max(0, self._reserved[owner] - n_pages)
        self.watermark = max(self.watermark, self.mapped_count)
        return list(pages)

    def reserve_more(self, owner: int, n_pages: int) -> None:
        """Adjust `owner`'s unmapped reservation by `n_pages`: widening
        draws on the uncommitted headroom and fails if it is not there;
        shrinking clamps at zero."""
        assert owner in self._mapped, owner
        if n_pages > 0:
            if n_pages > self.available:
                raise MemoryError(
                    f"reserve_more({owner}, {n_pages}): only "
                    f"{self.available} uncommitted pages available")
            self._reserved[owner] += n_pages
        else:
            self._reserved[owner] = max(0, self._reserved[owner] + n_pages)

    def rewind(self, owner: int, keep_pages: int) -> list[int]:
        """Return mapped pages beyond the first `keep_pages` to the free
        list, keeping the reservation (speculative rollback).  Returns the
        freed page ids."""
        assert owner in self._mapped, owner
        row = self._mapped[owner]
        keep_pages = max(1, keep_pages)       # never unmap the first page
        if keep_pages >= len(row):
            return []
        freed = row[keep_pages:]
        del row[keep_pages:]
        self._reserved[owner] += len(freed)
        self._free.extend(reversed(freed))    # LIFO: rewound pages reused next
        return list(freed)

    def finish(self, owner: int) -> list[int]:
        """Release everything `owner` holds — mapped pages and reservation."""
        pages = self._mapped.pop(owner, [])
        self._reserved.pop(owner, None)
        self._free.extend(reversed(pages))
        return list(pages)

    # -------------------------------------------------------------- queries
    def fragmentation(self, used_tokens: int) -> float:
        """Share of mapped bank rows holding no live token (tail-of-page
        waste); 0.0 when nothing is mapped."""
        cap = self.mapped_count * self.page_size
        if cap == 0:
            return 0.0
        return 1.0 - min(int(used_tokens), cap) / cap

    def stats(self, used_tokens: int = 0) -> PageStats:
        return PageStats(
            num_pages=self.num_pages,
            page_size=self.page_size,
            free=self.free_count,
            mapped=self.mapped_count,
            reserved_unmapped=self.reserved_unmapped,
            watermark=self.watermark,
            fragmentation=self.fragmentation(used_tokens),
        )

    def snapshot(self) -> dict:
        """Plain-dict state dump for diagnostics: who holds what."""
        return {
            "num_pages": self.num_pages,
            "page_size": self.page_size,
            "free": self.free_count,
            "mapped": {owner: list(row)
                       for owner, row in self._mapped.items()},
            "reserved": dict(self._reserved),
            "available": self.available,
            "watermark": self.watermark,
        }

    def check(self) -> None:
        """Assert the pool invariants."""
        mapped = [p for row in self._mapped.values() for p in row]
        assert len(mapped) == len(set(mapped)), "page double-mapped"
        assert not (set(mapped) & set(self._free)), "mapped page on free list"
        assert len(mapped) + len(self._free) == self.num_pages, (
            "pages leaked", len(mapped), len(self._free), self.num_pages)
        assert self.reserved_unmapped <= len(self._free), (
            "reservation exceeds free pool — grow() could fail")
        lo, hi = self.first_page, self.first_page + self.num_pages
        assert all(lo <= p < hi for p in mapped + self._free)


class BlockTables:
    """Host mirror of the device block tables: ``[max_slots, max_blocks]``
    int32 physical page ids, GARBAGE_PAGE where unmapped."""

    def __init__(self, max_slots: int, max_blocks: int):
        self.max_slots, self.max_blocks = int(max_slots), int(max_blocks)
        self.host = np.full((max_slots, max_blocks), GARBAGE_PAGE, np.int32)
        self._device: torch.Tensor | None = None

    def set_row(self, slot: int, pages: Iterable[int]) -> None:
        pages = list(pages)
        assert len(pages) <= self.max_blocks, (len(pages), self.max_blocks)
        self.host[slot, :len(pages)] = pages
        self.host[slot, len(pages):] = GARBAGE_PAGE
        self._device = None

    def clear_row(self, slot: int) -> None:
        self.host[slot, :] = GARBAGE_PAGE
        self._device = None

    def device(self, device: torch.device | str,
               rows: slice = slice(None)) -> torch.Tensor:
        """The int32 tensor the model steps consume (the slots `rows`: a
        data group's under a mesh), cached until a row changes: a
        host->device copy only after a mutation, never a device->host
        one."""
        dev = torch.device(device)
        if self._device is None or self._device.device.type != dev.type:
            self._device = torch.from_numpy(self.host[rows].copy()).to(dev)
        return self._device


class PagedKVManager:
    """Engine-facing facade: a token-count API over the allocator and the
    block tables.  Page 0 is the garbage page, so the usable pool is
    ``num_pages - 1`` pages, and the table width is clamped to it (a wider
    table would admit budgets the pool can never satisfy)."""

    def __init__(self, *, num_pages: int, page_size: int, max_slots: int,
                 max_blocks: int | None = None):
        usable = int(num_pages) - 1          # page 0 = garbage page
        if usable < 1 or int(page_size) < 1:
            raise ValueError(f"num_pages={num_pages}, page_size={page_size}: "
                             "need a usable page besides the garbage page "
                             "and at least one token per page")
        if max_blocks is None:
            max_blocks = usable
        # optional telemetry sink: the engine attaches its Tracer here
        # (under debug_invariants or a tracer with page_events) and every
        # map / unmap / reserve below emits a typed event; None costs nothing
        self.tracer = None
        self.page_size = int(page_size)
        self.max_blocks = min(int(max_blocks), usable)
        self.alloc = PageAllocator(usable, page_size, first_page=1)
        self.tables = BlockTables(max_slots, self.max_blocks)

    @property
    def max_context(self) -> int:
        """Longest sequence one request can hold (table width bound)."""
        return self.max_blocks * self.page_size

    def pages_for(self, tokens: int) -> int:
        return pages_for(tokens, self.page_size)

    def can_admit(self, budget_tokens: int) -> bool:
        need = self.pages_for(budget_tokens)
        return need <= self.max_blocks and self.alloc.can_admit(need)

    def admit(self, slot: int, budget_tokens: int,
              initial_tokens: int) -> None:
        budget = self.pages_for(budget_tokens)
        pages = self.alloc.admit(slot, budget, self.pages_for(initial_tokens))
        self.tables.set_row(slot, pages)
        if self.tracer is not None:
            self.tracer.emit("page_reserve", slot=slot, budget_pages=budget,
                             mapped_pages=len(pages))

    def coverage(self, slot: int) -> int:
        """Tokens the slot's mapped pages can hold right now."""
        return len(self.alloc.pages_of(slot)) * self.page_size

    def ensure(self, slot: int, tokens: int) -> int:
        """Grow slot coverage to `tokens`; returns pages newly mapped."""
        have = len(self.alloc.pages_of(slot))
        need = self.pages_for(tokens)
        if need <= have:
            return 0
        self.alloc.grow(slot, need - have)
        self.tables.set_row(slot, self.alloc.pages_of(slot))
        if self.tracer is not None:
            self.tracer.emit("page_map", slot=slot, pages=need - have)
        return need - have

    def rewind(self, slot: int, tokens: int) -> int:
        """Return pages past `tokens` coverage to the pool (speculative
        rollback); returns pages freed."""
        freed = self.alloc.rewind(slot, self.pages_for(tokens))
        if freed:
            self.tables.set_row(slot, self.alloc.pages_of(slot))
            if self.tracer is not None:
                self.tracer.emit("page_unmap", slot=slot, pages=len(freed),
                                 cause="rewind")
        return len(freed)

    def release(self, slot: int) -> int:
        """Drop everything `slot` holds — mapped pages and reservation — and
        scrub its table row back to the garbage page."""
        freed = self.alloc.finish(slot)
        self.tables.clear_row(slot)
        if self.tracer is not None and freed:
            self.tracer.emit("page_unmap", slot=slot, pages=len(freed),
                             cause="release")
        return len(freed)

    def stats(self, used_tokens: int = 0) -> PageStats:
        return self.alloc.stats(used_tokens)


__all__ = ["BlockTables", "GARBAGE_PAGE", "PageAllocator", "PageStats",
           "PagedKVManager", "pages_for"]
