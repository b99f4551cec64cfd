"""DeviceHashTable, the stateful build/probe surface, and the hash-join
candidate index.

The port of ``auron_tpu.hashtable.table``. ``DeviceHashTable`` is the
key → slot map alone (no accumulators): build inserts key columns and
returns stable slot ids, probe is lookup-only.

``build_join_index`` indexes a build side already sorted by 64-bit key
hash: one slot per distinct hash, keyed on the hash itself (equality is
one compare, no words), with the run bounds as payload. A probe returns
the exact (lo, count) pairs a searchsorted over the sorted hashes would.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.hashtable import core
from auron_tpu_torch.hashtable.agg import (_MAX_CAPACITY, HashTableOverflow,
                                           _hashes, _unify_widths)
from auron_tpu_torch.utils.shapes import next_pow2


def _build_kernel(key_meta: tuple, rounds: int, th, tw, store, keys, live):
    """Insert one batch's keys: the new (th, tw, store), each row's slot
    and is-new flag, the count of new keys and the overflow flag."""
    n = live.shape[0]
    h = _hashes(keys, n, live.device)
    w = core.key_words(keys, key_meta)
    claims, slot, resolved = core.insert_loop(th, tw, h, w, live, rounds)
    th2, tw2 = core.table_install(th, tw, h, w, claims)
    store2 = core.store_install(store, keys, key_meta, claims)
    rid = torch.arange(n, dtype=torch.int32, device=live.device)
    is_new = resolved & (claims[slot] == rid)
    n_new = core.batch_owned(claims).sum()
    return (th2, tw2, store2, slot, is_new, n_new,
            (live & ~resolved).any())


def _probe_kernel(key_meta: tuple, rounds: int, th, tw, keys, live):
    h = _hashes(keys, live.shape[0], live.device)
    w = core.key_words(keys, key_meta)
    return core.probe_loop(th, tw, h, w, live, rounds)


def _table_grow_kernel(key_meta: tuple, new_cap: int, rounds: int, th,
                       store):
    dev = th.device
    occupied = th != core.EMPTY
    cols = core.store_columns(store, key_meta)
    w = core.key_words(cols, key_meta)
    nth = torch.full((new_cap,), core.EMPTY, dtype=torch.int64, device=dev)
    ntw = torch.zeros((core.total_words(key_meta), new_cap),
                      dtype=torch.int64, device=dev)
    claims, slot, resolved = core.insert_loop(nth, ntw, th, w, occupied,
                                              rounds)
    nth, ntw = core.table_install(nth, ntw, th, w, claims)
    nstore = core.store_install(core.empty_store(key_meta, new_cap, dev),
                                cols, key_meta, claims)
    return nth, ntw, nstore, slot, (occupied & ~resolved).any()


class DeviceHashTable:
    """Key → slot-id map over canonical-word key equality (null == null,
    NaN == NaN, -0.0 == 0.0). ``insert`` returns per-row slot ids and an
    is-new mask; slot ids are stable until a growth re-bucket, which
    reports the old→new slot remap to the caller."""

    def __init__(self, initial_capacity: int = 4096,
                 load_factor: float = 0.5, max_probe_rounds: int = 64):
        self.cap = max(16, next_pow2(initial_capacity))
        self.load_factor = float(load_factor)
        self.rounds = int(max_probe_rounds)
        self.count = 0
        self.key_meta = None
        self.th = self.tw = self.store = None
        #: (old_cap, new_slot_of_old[old_cap], occupied[old_cap]) of the
        #: most recent growth: callers with slot-indexed side state
        #: consume and clear it
        self.last_remap = None

    def _init_arrays(self, keys, dev: torch.device) -> None:
        self.key_meta = core.key_meta(keys)
        self.th = torch.full((self.cap,), core.EMPTY, dtype=torch.int64,
                             device=dev)
        self.tw = torch.zeros((core.total_words(self.key_meta), self.cap),
                              dtype=torch.int64, device=dev)
        self.store = core.empty_store(self.key_meta, self.cap, dev)

    def _grow(self) -> None:
        new_cap = self.cap * 2
        while True:
            if new_cap > _MAX_CAPACITY:
                raise HashTableOverflow(
                    f"hash table stuck at {self.count} keys at capacity "
                    f"{new_cap}")
            nth, ntw, nstore, slot, ovf = _table_grow_kernel(
                self.key_meta, new_cap, self.rounds, self.th, self.store)
            if bool(ovf):
                new_cap *= 2
                continue
            self.last_remap = (self.cap, slot, self.th != core.EMPTY)
            self.th, self.tw, self.store = nth, ntw, nstore
            self.cap = new_cap
            return

    def insert(self, keys, live):
        """Insert live rows' keys; returns (slot[n], is_new[n])."""
        keys = tuple(keys)
        if self.key_meta is None:
            self._init_arrays(keys, live.device)
        keys = _unify_widths(self, keys)
        while True:
            th, tw, store, slot, is_new, n_new, ovf = _build_kernel(
                self.key_meta, self.rounds, self.th, self.tw, self.store,
                keys, live)
            n_new_h, ovf_h = torch.stack(
                [n_new, ovf.to(torch.int64)]).tolist()
            if not ovf_h:
                self.th, self.tw, self.store = th, tw, store
                self.count += n_new_h
                if self.count > self.load_factor * self.cap:
                    self._grow()
                return slot, is_new
            self._grow()

    def probe(self, keys, live):
        """Lookup-only: (slot[n], found[n]); probe keys wider than the
        store's width bucket widen it first (a wider probe key can still
        equal a stored narrower one)."""
        n = int(live.shape[0])
        if self.key_meta is None:
            return (torch.zeros(n, dtype=torch.int32, device=live.device),
                    torch.zeros(n, dtype=torch.bool, device=live.device))
        keys = _unify_widths(self, tuple(keys))
        return _probe_kernel(self.key_meta, self.rounds, self.th, self.tw,
                             keys, live)

    def keys_columns(self) -> tuple:
        """Slot-indexed original key values (emit side)."""
        return core.store_columns(self.store, self.key_meta)


# ---------------------------------------------------------------------------
# hash-join candidate index
# ---------------------------------------------------------------------------

def _join_index_kernel(cap: int, table_cap: int, rounds: int, h_sorted):
    """Hash-run index over a hash-sorted build column: one slot per
    distinct 64-bit hash, payload = (run start, run length)."""
    dev = h_sorted.device
    idx = torch.arange(cap, dtype=torch.int32, device=dev)
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                       h_sorted[1:] != h_sorted[:-1]])
    run_id = torch.cumsum(first, 0) - 1
    i32 = torch.iinfo(torch.int32)
    run_lo = torch.full((cap,), i32.max, dtype=torch.int32,
                        device=dev).scatter_reduce_(0, run_id, idx, "amin")
    run_hi = torch.full((cap,), i32.min, dtype=torch.int32,
                        device=dev).scatter_reduce_(0, run_id, idx, "amax")
    lo_row = run_lo[run_id]
    cnt_row = (run_hi - run_lo + 1)[run_id]
    th = torch.full((table_cap,), core.EMPTY, dtype=torch.int64, device=dev)
    tw = th.new_zeros((0, table_cap))
    w = th.new_zeros((0, cap))               # the hash is the key
    claims, _slot, resolved = core.insert_loop(th, tw, h_sorted, w, first,
                                               rounds)
    won = core.batch_owned(claims)
    cw = claims.clamp(0, cap - 1)
    th = torch.where(won, h_sorted[cw], th)
    lo_arr = torch.where(won, lo_row[cw], 0)
    cnt_arr = torch.where(won, cnt_row[cw], 0)
    # a real build hash equal to the empty sentinel would be
    # indistinguishable from an empty slot: the host disables the index
    # for that build side (searchsorted handles it exactly)
    bad = (h_sorted == core.EMPTY).any() | (first & ~resolved).any()
    return th, lo_arr, cnt_arr, bad


#: build sides larger than this keep the searchsorted candidate search
#: (the index would double their device footprint for a log-factor win
#: that large builds don't feel)
MAX_INDEX_BUILD_ROWS = 1 << 22


class JoinHashIndex:
    """Immutable probe-side index: hash → (lo, count) into the sorted
    build table."""

    __slots__ = ("th", "lo", "cnt", "rounds", "capacity")

    def __init__(self, th, lo, cnt, rounds: int):
        self.th = th
        self.lo = lo
        self.cnt = cnt
        self.rounds = rounds
        self.capacity = int(th.shape[0])

    def lookup(self, h: torch.Tensor):
        """(lo[n], counts[n]) for probe hashes: the searchsorted
        contract, count 0 (lo 0) where the hash is absent."""
        live = h != core.EMPTY     # null/dead probe rows never match
        slot, found = core.probe_hash_index(self.th, h, live, self.rounds)
        lo = torch.where(found, self.lo[slot], 0)
        counts = torch.where(found, self.cnt[slot], 0)
        return lo, counts


def build_join_index(h_sorted: torch.Tensor, max_probe_rounds: int = 64):
    """Index a hash-sorted build column; returns a JoinHashIndex, or None
    when the build side is too large or its hashes collide with the empty
    sentinel (callers keep the exact searchsorted path)."""
    cap = int(h_sorted.shape[0])
    if cap > MAX_INDEX_BUILD_ROWS:
        return None
    table_cap = max(16, next_pow2(cap) * 2)
    th, lo, cnt, bad = _join_index_kernel(cap, table_cap, max_probe_rounds,
                                          h_sorted)
    if bool(bad):
        return None
    return JoinHashIndex(th, lo, cnt, max_probe_rounds)
