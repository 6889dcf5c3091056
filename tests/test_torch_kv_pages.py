"""The port's paged-KV allocator (`repro_torch.serving.kv_pages`), its own
copy of `repro.serving.kv_pages`.

The invariants of tests/test_kv_pages.py under seeded random operation
sequences (admit / grow / rewind / release): no page mapped twice, free +
mapped partitions the pool, reservations never exceed the free list, the
table rows mirror the allocator, page 0 is never mapped, a drained pool is
a fresh one.  Then one operation sequence through both packages' managers
in lockstep: identical page ids, tables and stats at every step.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.serving import kv_pages as ref_pages  # noqa: E402
from repro_torch.serving.kv_pages import (GARBAGE_PAGE, BlockTables,  # noqa: E402
                                          PageAllocator, PagedKVManager,
                                          pages_for)

MAX_SLOTS = 4


def _ops(seed: int, n: int) -> list[tuple[int, int, int]]:
    """n seeded (op, slot, tokens) triples: op 0 admit, 1 grow coverage,
    2 speculative rewind, 3 release."""
    rng = np.random.default_rng(seed)
    return [(int(o), int(s), int(t)) for o, s, t in zip(
        rng.integers(0, 4, n), rng.integers(0, MAX_SLOTS, n),
        rng.integers(1, 121, n))]


def _apply(mgr, live: dict, op: int, slot: int, tokens: int) -> None:
    if op == 0 and slot not in live:                      # admit
        if mgr.can_admit(tokens):
            mgr.admit(slot, tokens, max(1, tokens // 2))
            live[slot] = tokens
    elif op == 1 and slot in live:                        # grow coverage
        mgr.ensure(slot, min(tokens, live[slot]))
    elif op == 2 and slot in live:                        # speculative rewind
        mgr.rewind(slot, tokens)
    elif op == 3 and slot in live:                        # finish
        mgr.release(slot)
        live.pop(slot)


def _check_tables(mgr: PagedKVManager, live: dict) -> None:
    for s in range(MAX_SLOTS):
        pages = mgr.alloc.pages_of(s)
        row = mgr.tables.host[s]
        assert list(row[:len(pages)]) == pages
        assert all(int(e) == GARBAGE_PAGE for e in row[len(pages):])
        if s not in live:
            assert not pages
    mapped = [p for s in live for p in mgr.alloc.pages_of(s)]
    assert GARBAGE_PAGE not in mapped, "garbage page must never be mapped"


def _drain(mgr: PagedKVManager, live: dict) -> None:
    for s in list(live):
        mgr.release(s)
    mgr.alloc.check()
    assert mgr.alloc.mapped_count == 0
    assert mgr.alloc.reserved_unmapped == 0
    assert mgr.alloc.free_count == mgr.alloc.num_pages
    assert (mgr.tables.host == GARBAGE_PAGE).all()


@pytest.mark.parametrize("seed", range(8))
def test_allocator_invariants_under_random_ops(seed):
    mgr = PagedKVManager(num_pages=25, page_size=8, max_slots=MAX_SLOTS)
    live: dict[int, int] = {}
    for op in _ops(seed, 60):
        _apply(mgr, live, *op)
        mgr.alloc.check()
        _check_tables(mgr, live)
    _drain(mgr, live)


@pytest.mark.parametrize("seed", range(6))
def test_allocator_invariants_across_geometries(seed):
    rng = np.random.default_rng(100 + seed)
    page_size, num_pages = int(rng.integers(1, 17)), int(rng.integers(6, 41))
    mgr = PagedKVManager(num_pages=num_pages, page_size=page_size,
                         max_slots=MAX_SLOTS)
    live: dict[int, int] = {}
    for op in _ops(seed + 50, 40):
        _apply(mgr, live, *op)
        mgr.alloc.check()
        _check_tables(mgr, live)
    _drain(mgr, live)


def test_pages_for():
    assert pages_for(0, 8) == 1     # an owner always holds >= 1 page
    assert pages_for(1, 8) == 1
    assert pages_for(8, 8) == 1
    assert pages_for(9, 8) == 2
    assert pages_for(17, 8) == 3


def test_admission_headroom_accounts_for_reservations():
    a = PageAllocator(10, 4)
    a.admit(0, budget_pages=8, initial_pages=2)   # 6 reserved unmapped
    assert a.free_count == 8 and a.available == 2
    assert a.can_admit(2) and not a.can_admit(3)
    a.grow(0, 6)                                  # the reservation lands
    assert a.free_count == 2 and a.reserved_unmapped == 0
    a.check()


def test_rewind_keeps_reservation_claimable():
    a = PageAllocator(8, 4)
    a.admit(0, budget_pages=6, initial_pages=6)
    freed = a.rewind(0, keep_pages=2)
    assert len(freed) == 4 and a.free_count == 6
    assert a.available == 2 and not a.can_admit(3)
    a.grow(0, 4)                                  # guaranteed to succeed
    a.check()


def test_grow_beyond_reservation_draws_uncommitted_headroom():
    a = PageAllocator(10, 4)
    a.admit(0, budget_pages=3, initial_pages=3)
    a.admit(1, budget_pages=5, initial_pages=1)   # 4 reserved
    a.grow(0, 2)                                  # free 6 - reserved 4
    with pytest.raises(MemoryError):
        a.grow(0, 1)
    a.check()


def test_reserve_more_widens_and_shrinks_reservations():
    a = PageAllocator(10, 4)
    a.admit(0, budget_pages=4, initial_pages=2)
    a.admit(1, budget_pages=4, initial_pages=4)
    assert a.available == 2
    a.reserve_more(0, 2)
    assert a.available == 0 and a.reserved_unmapped == 4
    with pytest.raises(MemoryError):
        a.reserve_more(1, 1)
    a.grow(0, 4)
    a.reserve_more(0, -3)                         # shrink clamps at zero
    assert a.reserved_unmapped == 0
    a.check()


def test_finish_releases_everything_and_admit_over_capacity_raises():
    a = PageAllocator(6, 4)
    a.admit(7, budget_pages=5, initial_pages=3)
    a.finish(7)
    assert a.free_count == 6 and a.reserved_unmapped == 0
    assert a.owners() == []
    a.check()
    with pytest.raises(MemoryError):
        PageAllocator(4, 4).admit(0, budget_pages=5, initial_pages=1)


def test_fragmentation_watermark_and_snapshot():
    a = PageAllocator(10, page_size=8)
    a.admit(0, budget_pages=4, initial_pages=3)   # 24 rows mapped
    assert a.stats(used_tokens=18).fragmentation == pytest.approx(0.25)
    assert a.stats(used_tokens=24).fragmentation == 0.0
    assert a.watermark == 3
    a.rewind(0, keep_pages=1)
    assert a.watermark == 3                       # a peak
    a.grow(0, 3)
    assert a.watermark == 4
    snap = a.snapshot()
    assert snap["mapped"] == {0: a.pages_of(0)} and snap["free"] == 6


def test_block_tables_device_tensor_is_cached_until_a_row_changes():
    t = BlockTables(2, 4)
    d0 = t.device("cpu")
    assert d0 is t.device("cpu") and d0.dtype == torch.int32
    t.set_row(1, [5, 6])
    d1 = t.device("cpu")
    assert d1 is not d0
    assert d1[1].tolist() == [5, 6, GARBAGE_PAGE, GARBAGE_PAGE]
    assert d0[1].tolist() == [GARBAGE_PAGE] * 4   # a copy, not a view
    t.clear_row(1)
    assert t.device("cpu")[1].tolist() == [GARBAGE_PAGE] * 4


def test_manager_clamps_table_width_and_reserves_garbage_page():
    m = PagedKVManager(num_pages=9, page_size=8, max_slots=2, max_blocks=100)
    assert m.max_blocks == m.tables.max_blocks == 8
    assert m.max_context == 64 and m.can_admit(m.max_context)
    mgr = PagedKVManager(num_pages=5, page_size=4, max_slots=2)
    assert mgr.alloc.num_pages == 4               # page 0 excluded
    mgr.admit(0, 16, 16)
    assert sorted(mgr.alloc.pages_of(0)) == [1, 2, 3, 4]
    assert mgr.coverage(0) == 16
    for num_pages, page_size in ((1, 8), (5, 0)):
        with pytest.raises(ValueError):
            PagedKVManager(num_pages=num_pages, page_size=page_size,
                           max_slots=2)


@pytest.mark.parametrize("seed", range(3))
def test_port_and_reference_managers_agree_step_by_step(seed):
    """One seeded operation sequence through the reference's manager and
    the port's: the same page ids, table rows and pool stats after every
    operation, and the same MemoryError where an allocator refuses."""
    ref = ref_pages.PagedKVManager(num_pages=21, page_size=4,
                                   max_slots=MAX_SLOTS)
    got = PagedKVManager(num_pages=21, page_size=4, max_slots=MAX_SLOTS)
    live_ref: dict[int, int] = {}
    live_got: dict[int, int] = {}
    rng = np.random.default_rng(seed)
    for op, slot, tokens in _ops(seed + 7, 80):
        if op == 2 and slot in live_got and rng.random() < 0.5:
            # the allocator-level calls a speculative engine makes
            n = int(rng.integers(-2, 4))
            outcomes = []
            for mgr in (ref, got):
                try:
                    mgr.alloc.reserve_more(slot, n)
                    mgr.alloc.grow(slot, max(n, 0))
                    outcomes.append("ok")
                except MemoryError:
                    outcomes.append("MemoryError")
            assert outcomes[0] == outcomes[1]
            for mgr in (ref, got):
                mgr.tables.set_row(slot, mgr.alloc.pages_of(slot))
        else:
            _apply(ref, live_ref, op, slot, tokens)
            _apply(got, live_got, op, slot, tokens)
        assert live_got == live_ref
        for s in range(MAX_SLOTS):
            assert got.alloc.pages_of(s) == ref.alloc.pages_of(s)
            assert got.coverage(s) == ref.coverage(s)
        np.testing.assert_array_equal(got.tables.host, ref.tables.host)
        used = sum(live_got.values())
        assert (dataclasses.astuple(got.stats(used))
                == dataclasses.astuple(ref.stats(used)))
        assert got.alloc.snapshot() == ref.alloc.snapshot()
        got.alloc.check()
