"""Fixed-capacity open-addressing voxel hash table (counterpart of
sps_tpu/ops/hash.py).

Linear probing over a power-of-two table. Insertion is sps_tpu's parallel
scheme: every pending key tries to claim its current probe slot with a
scatter-min of its row id; the winner installs its key, the losers either
find their own key there (a duplicate: resolved to that slot) or advance
their probe. The compact row order of every hash engine is this table's
slot order, so the schedule is sps_tpu's to the letter: two full-width
rounds, then (n > 256) the pending rows compacted to n // 4 with their
original row ids and probes, then an exact full-width cleanup; rows still
unresolved after `max_rounds` stay EMPTY. Keys and slots are bit-equal to
sps_tpu's.

sps_tpu's loops exit when nothing is pending. In eager PyTorch that test
reads a device value on the host (a host sync). A round with nothing
pending changes nothing, so the test runs every SYNC_EVERY rounds, and
the first two rounds of a build run without it. `SYNCS` counts the tests.
The tables' uint32 hash is computed in int64 with 16-bit partial products,
so no product wraps.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.profiler import record_function

# Sentinel for "no row" in table slots and failed lookups.
EMPTY = -1
# Key stored in vacant slots (ops.voxelize.PAD_COORD): a probe decides
# match / vacant / continue from the keys gather alone.
SENTINEL = 1 << 24
# Bound on probe rounds (the loops exit early once every row resolved).
MAX_ROUNDS = 128
# Rounds between two tests of "anything pending?" (each a host sync).
SYNC_EVERY = 4
# Host syncs taken by the probe loops' tests since the last reset.
SYNCS = {"hash": 0}

_U32 = 0xFFFFFFFF


def reset_syncs() -> None:
    SYNCS["hash"] = 0


class HashTable(NamedTuple):
    """Open-addressing table mapping int32 coordinate 4-tuples -> row ids.

    keys: (S, 4) int32 stored keys (SENTINEL where vacant);
    rows: (S,) int32 row id per slot, EMPTY where vacant."""

    keys: torch.Tensor
    rows: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.rows.shape[0]


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (static helper)."""
    p = 1
    while p < x:
        p *= 2
    return p


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 a in [0, 2^32) and a constant b < 2^32,
    from 16-bit halves of a (every partial product stays below 2^49)."""
    lo = (a & 0xFFFF) * b
    hi = ((a >> 16) * b) & 0xFFFF
    return (lo + (hi << 16)) & _U32


def _mix(coords: torch.Tensor) -> torch.Tensor:
    """Hash (N, 4) int32 coordinates to (N,) values in [0, 2^32) (int64):
    sps_tpu's uint32 mix."""
    c = coords.long() & _U32
    h = (_mul32(c[:, 0], 0x9E3779B1) ^ _mul32(c[:, 1], 0x85EBCA77)
         ^ _mul32(c[:, 2], 0xC2B2AE3D) ^ _mul32(c[:, 3], 0x27D4EB2F))
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    return h ^ (h >> 15)


def _slot0(coords: torch.Tensor, capacity: int) -> torch.Tensor:
    return _mix(coords) & (capacity - 1)


def _any(flags: torch.Tensor) -> bool:
    SYNCS["hash"] += 1
    return bool(flags.any())


def _rounds(step, pending, max_rounds: int, first_test: int):
    """Run step() while anything is pending, at most max_rounds times.
    pending() gives the current flags; the first test comes after
    first_test rounds, then one every SYNC_EVERY rounds."""
    rnd = 0
    next_test = first_test
    while rnd < max_rounds:
        if rnd == next_test:
            if not _any(pending()):
                return
            next_test = rnd + SYNC_EVERY
        step()
        rnd += 1


def _insert_loop(coords, rowid, h0, capacity, st, pending, probe, max_rounds, first_test):
    """sps_tpu's claim/resolve rounds. `st` holds rows (cap+1,), keys
    (cap+1, 4) with a dump slot at index cap, and slot_of (n+1,) with a dump
    row; pending/probe are updated in place. rowid carries the original row
    ids (the claims' tie-break and the stored values), so compacted subsets
    work too."""
    dev = coords.device
    big = torch.full((capacity + 1,), 2**30, dtype=torch.int32, device=dev)

    def step():
        slot = (h0 + probe) & (capacity - 1)
        want = pending & (st["rows"][slot] < 0)
        cand = torch.where(want, slot, capacity)
        claim = big.clone().scatter_reduce_(0, cand, rowid, "amin", include_self=True)
        won = want & (claim[slot] == rowid)
        wslot = torch.where(won, slot, capacity)
        st["rows"].index_put_((wslot,), rowid)
        st["keys"].index_put_((wslot,), coords)
        match = (st["rows"][slot] >= 0) & (st["keys"][slot] == coords).all(-1)
        resolved = pending & match
        st["slot_of"].copy_(torch.where(resolved, slot, st["slot_of"]))
        pending.logical_and_(~match)
        probe.add_(pending)

    _rounds(step, lambda: pending, max_rounds, first_test)


def build(coords: torch.Tensor, valid: torch.Tensor, capacity: int,
          max_rounds: int = MAX_ROUNDS) -> tuple[HashTable, torch.Tensor]:
    """Insert (possibly duplicated) (N, 4) int32 keys of the valid rows into a
    fresh table of `capacity` (a power of two, >= 2x the unique keys for
    short probe chains).

    Returns (table, slot_of): table.rows[s] is the lowest row id among the
    rows with the key stored at slot s; slot_of[i] (int32) is the slot of row
    i's key, EMPTY for invalid or unresolved rows."""
    assert capacity & (capacity - 1) == 0, "capacity must be a power of two"
    with record_function("sps.hash.build"):
        n = coords.shape[0]
        dev = coords.device
        coords = coords.to(torch.int32)
        h0 = _slot0(coords, capacity)
        rowid = torch.arange(n, dtype=torch.int32, device=dev)
        st = {"rows": torch.full((capacity + 1,), EMPTY, dtype=torch.int32, device=dev),
              "keys": torch.full((capacity + 1, 4), SENTINEL, dtype=torch.int32, device=dev),
              "slot_of": torch.full((n,), EMPTY, dtype=torch.int64, device=dev)}
        pending = valid.clone()
        probe = torch.zeros(n, dtype=torch.int64, device=dev)

        # Phase 1: two full-width rounds (no test: an idle round is a no-op).
        _insert_loop(coords, rowid, h0, capacity, st, pending, probe, 2, first_test=2)

        mn = max(n // 4, 1)
        if n > 256 and mn < n:
            # Phase 2: the pending rows compacted to mn, probed narrow.
            pos = torch.cumsum(pending, 0) - 1
            dest = torch.where(pending & (pos < mn), pos, mn)
            idx = torch.zeros(mn + 1, dtype=torch.int64, device=dev).scatter_(
                0, dest, rowid.long())[:mn]
            total = pending.sum()
            sel = torch.arange(mn, device=dev) < torch.clamp_max(total, mn)
            sub = {"rows": st["rows"], "keys": st["keys"],
                   "slot_of": torch.full((mn,), EMPTY, dtype=torch.int64, device=dev)}
            sub_pending = sel.clone()
            _insert_loop(coords[idx], torch.where(sel, idx, 2**30).to(torch.int32), h0[idx],
                         capacity, sub, sub_pending, probe[idx], max_rounds,
                         first_test=SYNC_EVERY)
            sidx = torch.where(sel & ~sub_pending, idx, n)
            slot_of = torch.cat([st["slot_of"], st["slot_of"].new_full((1,), EMPTY)])
            slot_of.index_put_((sidx,), sub["slot_of"])
            st["slot_of"] = slot_of[:n]
            handled = torch.zeros(n + 1, dtype=torch.bool, device=dev)
            handled.index_fill_(0, sidx, True)
            pending.logical_and_(~handled[:n])

        # Phase 3: exact cleanup of what compaction left (normally nothing).
        _insert_loop(coords, rowid, h0, capacity, st, pending, probe, max_rounds, first_test=0)
        table = HashTable(keys=st["keys"][:capacity], rows=st["rows"][:capacity])
        return table, st["slot_of"].to(torch.int32)


def _probe_loop(table, queries, h0, found, done, probe, max_rounds, first_test):
    """sps_tpu's probe rounds, one keys gather each (vacant slots hold
    SENTINEL keys); found/done/probe are updated in place."""
    capacity = table.capacity

    def step():
        slot = (h0 + probe) & (capacity - 1)
        k = table.keys[slot]
        match = (k == queries).all(-1)
        found.copy_(torch.where(~done & match, slot, found))
        done.logical_or_(match | (k[:, 0] >= SENTINEL))
        probe.add_(~done)

    _rounds(step, lambda: ~done, max_rounds, first_test)


def lookup(table: HashTable, queries: torch.Tensor, valid: torch.Tensor | None = None,
           max_rounds: int = MAX_ROUNDS, narrow_div: int = 4) -> torch.Tensor:
    """Look up (M, 4) int32 queries; returns (M,) int32 row ids or EMPTY.

    A query ends at the first vacant slot on its probe path (no deletions).
    sps_tpu's schedule: one full-width round, the unresolved rest compacted
    to M // narrow_div and probed narrow (M > 256), then an exact
    full-width cleanup of what compaction left."""
    with record_function("sps.hash.lookup"):
        capacity = table.capacity
        dev = queries.device
        queries = queries.to(torch.int32)
        m = queries.shape[0]
        h0 = _slot0(queries, capacity)
        if valid is None:
            valid = torch.ones(m, dtype=torch.bool, device=dev)

        # Phase 1: one round, full width.
        k = table.keys[h0]
        match = (k == queries).all(-1)
        found = torch.where(valid & match, h0, EMPTY)
        done = ~valid | match | (k[:, 0] >= SENTINEL)

        mn = max(m // narrow_div, 1)
        if m > 256 and mn < m:
            # Phase 2: the unresolved queries compacted to mn, probed narrow.
            pending = ~done
            pos = torch.cumsum(pending, 0) - 1
            dest = torch.where(pending & (pos < mn), pos, mn)
            idx = torch.zeros(mn + 1, dtype=torch.int64, device=dev).scatter_(
                0, dest, torch.arange(m, device=dev))[:mn]
            total = pending.sum()
            sel = torch.arange(mn, device=dev) < torch.clamp_max(total, mn)
            sub_found = torch.full((mn,), EMPTY, dtype=torch.int64, device=dev)
            _probe_loop(table, queries[idx], h0[idx], sub_found, ~sel,
                        torch.ones(mn, dtype=torch.int64, device=dev), max_rounds,
                        first_test=SYNC_EVERY)
            sidx = torch.where(sel, idx, m)
            found = torch.cat([found, found.new_full((1,), EMPTY)])
            found.index_put_((sidx,), sub_found)
            found = found[:m]
            handled = torch.zeros(m + 1, dtype=torch.bool, device=dev)
            handled.index_put_((sidx,), sel)
            done = done | handled[:m]

        # Phase 3: exact cleanup of compaction overflow (normally nothing).
        _probe_loop(table, queries, h0, found, done,
                    torch.ones(m, dtype=torch.int64, device=dev), max_rounds, first_test=0)
        return torch.where(found >= 0, table.rows[found.clamp(min=0)], EMPTY)
