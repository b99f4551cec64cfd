"""Hash-table-backed group state for the general aggregation path.

The port of ``auron_tpu.hashtable.agg``. ``HashAggState`` is the
open-addressing replacement for the sort path's incremental state: every
batch hashes its keys, inserts them (hashtable/core's lock-step claim
rounds) and scatters its accumulator contributions into the owning
slots; the table is the state, and nothing re-sorts per batch.

Growth keeps the power-of-two re-bucketing discipline: when an insert
overflows its probe-round budget or occupancy crosses
``auron.hashtable.load_factor``, the table doubles and re-inserts itself
(keys re-place, accumulators follow their slots). Repeat overflow at
``_MAX_CAPACITY`` raises ``HashTableOverflow``.

``to_sorted_table()`` exports the slots as the agg path's hash-sorted
5-tuple ``(keys, accs, num_groups, cap, hashes)``: occupied slots sorted
by hash ascending as uint64, dead slots under the sentinel last, in the
reference's order.

The reference compiles each step below once per shape as a cached XLA
program; here each is a plain function over tensors, run eagerly.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import gather_column, pad_string_width
from auron_tpu_torch.hashtable import core
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.utils.shapes import next_pow2

#: absolute slot-capacity ceiling: growth fixes load-bound and
#: tail-bound overflow (doubling halves chain lengths), so only
#: collision-pathological inputs keep overflowing; they hit this wall
_MAX_CAPACITY = 1 << 26

#: flips the sign bit: int64 order of ``h ^ _SIGN`` is uint64 order of h
_SIGN = torch.iinfo(torch.int64).min


class HashTableOverflow(Exception):
    """Insert could not place every key within the probe-round budget at
    any sane capacity; the caller falls back to the sort path."""


def _hashes(keys, n: int, device=None) -> torch.Tensor:
    return core.remap_hashes(hashing.xxhash64_columns(list(keys), n,
                                                      device=device))


def _agg_step_kernel(key_meta: tuple, acc_meta: tuple, rounds: int,
                     th, tw, store, accs, auxs, keys, contribs, live,
                     ord_base: int):
    """One batch: hash + insert + store winners + scatter accumulator
    contributions. Returns the new state and (n_new, overflow) as device
    scalars; the state passed in is not changed."""
    h = _hashes(keys, live.shape[0], live.device)
    w = core.key_words(keys, key_meta)
    claims, slot, resolved = core.insert_loop(th, tw, h, w, live, rounds)
    th2, tw2 = core.table_install(th, tw, h, w, claims)
    store2 = core.store_install(store, keys, key_meta, claims)
    accs2, auxs2 = core.agg_update(accs, auxs, acc_meta, slot, resolved,
                                   contribs, ord_base)
    n_new = core.batch_owned(claims).sum()
    overflow = (live & ~resolved).any()
    return th2, tw2, store2, accs2, auxs2, n_new, overflow


def _grow_kernel(key_meta: tuple, acc_meta: tuple, old_cap: int,
                 new_cap: int, rounds: int, th, store, accs, auxs):
    """Re-bucket: re-insert every occupied slot into an empty table of
    ``new_cap`` (stored hashes reused; equality words recomputed from the
    stored original values) and move accumulators to their new slots."""
    dev = th.device
    occupied = th != core.EMPTY
    cols = core.store_columns(store, key_meta)
    w = core.key_words(cols, key_meta)
    nth = torch.full((new_cap,), core.EMPTY, dtype=torch.int64, device=dev)
    ntw = torch.zeros((core.total_words(key_meta), new_cap),
                      dtype=torch.int64, device=dev)
    claims, _slot, resolved = core.insert_loop(nth, ntw, th, w, occupied,
                                               rounds)
    nth, ntw = core.table_install(nth, ntw, th, w, claims)
    nstore = core.store_install(core.empty_store(key_meta, new_cap, dev),
                                cols, key_meta, claims)
    # accumulators follow their keys: each batch-won new slot gathers the
    # old slot's acc through claims (claims[new] = old slot id)
    won = core.batch_owned(claims)
    cw = claims.clamp(0, old_cap - 1)
    naccs, nauxs = [], []
    for (kind, dt), acc, aux in zip(acc_meta, accs, auxs):
        neutral = core.neutral_like(kind, getattr(torch, dt)).item()
        naccs.append(torch.where(won, acc[cw], neutral))
        nauxs.append(torch.where(won, aux[cw], core.ORD_NONE)
                     if kind == "first" else None)
    return (nth, ntw, nstore, tuple(naccs), tuple(nauxs),
            (occupied & ~resolved).any())


def _export_kernel(key_meta: tuple, cap: int, th, store, accs):
    """Slots → the hash-sorted group-table layout (dead slots last under
    the sentinel), in the reference's order: a stable sort by the hash as
    uint64."""
    ng = (th != core.EMPTY).sum(dtype=torch.int32)
    perm = torch.argsort(th ^ _SIGN, stable=True)
    out_valid = torch.arange(cap, dtype=torch.int32, device=th.device) < ng
    cols = tuple(gather_column(c, perm, out_valid)
                 for c in core.store_columns(store, key_meta))
    return cols, tuple(a[perm] for a in accs), ng, th[perm]


def _pad_string_keys(keys, target_meta: tuple) -> tuple:
    """Pad narrower batch string columns up to the store's width bucket
    (zero padding keeps words and hashes unchanged)."""
    return tuple(pad_string_width(c, m[1]) if m[0] == "str" else c
                 for c, m in zip(keys, target_meta))


def _unify_widths(state, keys) -> tuple:
    """Reconcile a batch's string width buckets with ``state``'s store
    (a ``HashAggState`` or ``DeviceHashTable``): a wider batch widens the
    store (``core.widen_string_store``), a narrower one is padded."""
    meta = core.key_meta(keys)
    if meta != state.key_meta:
        widen = core.string_width_drift(meta, state.key_meta)
        if widen:
            state.tw, state.store, state.key_meta = \
                core.widen_string_store(state.tw, state.store,
                                        state.key_meta, widen)
    return _pad_string_keys(keys, state.key_meta)


class HashAggState:
    """Mutable per-execution group state: the device table and
    slot-indexed accumulators, with host-driven growth. ``kinds`` is the
    flat device-reduce-kind list. The state lives on the device of the
    first batch's key columns."""

    def __init__(self, kinds, initial_capacity: int = 4096,
                 load_factor: float = 0.5, max_probe_rounds: int = 64):
        self.kinds = tuple(kinds)
        self.cap = max(16, next_pow2(initial_capacity))
        self.load_factor = float(load_factor)
        self.rounds = int(max_probe_rounds)
        self.count = 0          # occupied slots (host mirror)
        self.rows_seen = 0      # global row ordinal base for 'first'
        self.key_meta = None    # set lazily on the first update
        self.acc_meta = None
        self.th = self.tw = self.store = self.accs = self.auxs = None

    # -- sizing --------------------------------------------------------------

    @property
    def built(self) -> bool:
        return self.key_meta is not None

    def nbytes(self) -> int:
        if not self.built:
            return 0
        total = self.th.nbytes + self.tw.nbytes
        for s in self.store:
            total += sum(a.nbytes for a in s)
        total += sum(a.nbytes for a in self.accs)
        total += sum(a.nbytes for a in self.auxs if a is not None)
        return total

    # -- state transitions ---------------------------------------------------

    def _init_arrays(self, keys, contribs, dev: torch.device) -> None:
        self.key_meta = core.key_meta(keys)
        self.acc_meta = tuple(
            (kind, core.dtype_name(v.dtype))
            for kind, v in zip(self.kinds, contribs))
        self.th = torch.full((self.cap,), core.EMPTY, dtype=torch.int64,
                             device=dev)
        self.tw = torch.zeros((core.total_words(self.key_meta), self.cap),
                              dtype=torch.int64, device=dev)
        self.store = core.empty_store(self.key_meta, self.cap, dev)
        self.accs, self.auxs = core.init_accs(self.acc_meta, self.cap, dev)

    def _grow(self) -> None:
        new_cap = self.cap * 2
        while True:
            if new_cap > _MAX_CAPACITY:
                raise HashTableOverflow(
                    f"hash table stuck at {self.count} keys despite "
                    f"capacity {new_cap} (probe rounds {self.rounds})")
            nth, ntw, nstore, naccs, nauxs, ovf = _grow_kernel(
                self.key_meta, self.acc_meta, self.cap, new_cap,
                self.rounds, self.th, self.store, self.accs, self.auxs)
            if bool(ovf):
                new_cap *= 2
                continue
            self.th, self.tw, self.store = nth, ntw, nstore
            self.accs, self.auxs = naccs, nauxs
            self.cap = new_cap
            return

    def update(self, keys, contribs, live) -> None:
        """Fold one batch (group-key columns + per-row accumulator
        contributions + live mask) into the table: one step and one
        readback of (new keys, overflow) per attempt."""
        keys = tuple(keys)
        contribs = tuple(contribs)
        if not self.built:
            self._init_arrays(keys, contribs, live.device)
        keys = _unify_widths(self, keys)
        n = int(live.shape[0])
        while True:
            th, tw, store, accs, auxs, n_new, overflow = _agg_step_kernel(
                self.key_meta, self.acc_meta, self.rounds, self.th,
                self.tw, self.store, self.accs, self.auxs, keys, contribs,
                live, self.rows_seen)
            # the per-batch sync point
            n_new_h, ovf = torch.stack(
                [n_new, overflow.to(torch.int64)]).tolist()
            if not ovf:
                self.th, self.tw, self.store = th, tw, store
                self.accs, self.auxs = accs, auxs
                self.count += n_new_h
                self.rows_seen += n
                if self.count > self.load_factor * self.cap:
                    try:
                        self._grow()
                    except HashTableOverflow:
                        # the batch is already committed: raising here
                        # would double-count it when the caller falls
                        # back and re-merges. Results stay correct at
                        # high load; a later insert that genuinely cannot
                        # place surfaces the overflow before it commits.
                        pass
                return
            # round budget exhausted: discard this attempt (the committed
            # state is untouched), re-bucket, retry the whole batch
            self._grow()

    def to_sorted_table(self):
        """The hash-sorted 5-tuple (keys, accs, num_groups, cap, hashes),
        or None when nothing was ever inserted."""
        if not self.built:
            return None
        cols, accs, ng, h = _export_kernel(self.key_meta, self.cap,
                                           self.th, self.store, self.accs)
        return (cols, accs, ng, self.cap, h)


# ---------------------------------------------------------------------------
# single-shot form (the flagship's hash twin)
# ---------------------------------------------------------------------------

def grouped_agg_once(keys, contribs, kinds, live, capacity: int,
                     max_rounds: int = 128, full_rounds: int = 1):
    """One-batch hash aggregation: build + update, no growth (callers
    size ``capacity`` at >= 2x the possible distinct-key count). Returns
    (key_cols, accs, num_groups, group_valid) in slot order; rows the
    round budget could not place are dropped."""
    keys = tuple(keys)
    meta = core.key_meta(keys)
    dev = live.device
    h = _hashes(keys, live.shape[0], live.device)
    w = core.key_words(keys, meta)
    th = torch.full((capacity,), core.EMPTY, dtype=torch.int64, device=dev)
    tw = torch.zeros((core.total_words(meta), capacity), dtype=torch.int64,
                     device=dev)
    claims, slot, resolved = core.insert_loop(th, tw, h, w, live,
                                              max_rounds, full_rounds,
                                              tail_frac=8)
    store = core.store_install(core.empty_store(meta, capacity, dev), keys,
                               meta, claims)
    acc_meta = tuple((k, core.dtype_name(v.dtype))
                     for k, v in zip(kinds, contribs))
    accs, auxs = core.init_accs(acc_meta, capacity, dev)
    accs, _auxs = core.agg_update(accs, auxs, acc_meta, slot, resolved,
                                  contribs, 0)
    won = core.batch_owned(claims)
    ng = won.sum(dtype=torch.int32)
    return core.store_columns(store, meta), accs, ng, won
