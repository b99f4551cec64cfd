"""Equi-joins on primitive and string keys: the hash join.

The port of ``auron_tpu.ops.joins``' ``HashJoinOp``. The build side is
collected, concatenated and sorted once by the xxhash64 of its keys;
each probe batch finds every row's candidate run in the sorted build
table, expands the runs into (probe row, build row) pairs in an output
batch sized from the exact candidate count, and keeps the pairs whose
keys are equal (hash collisions drop out in the compaction). Inner,
left, right, full, semi, anti and existence joins; right and full joins
or-accumulate a matched mask over the build rows across probe batches
and emit the unmatched build rows after the last probe batch.

Two candidate searches give the same (lo, count) per probe row: two
binary searches of the sorted hashes ("sorted"), or one probe of the
hash-run index (``hashtable.build_join_index``, "ht"), used when
``auron.hashtable.enabled`` is on, the backend is not ``sort`` and the
build side fits the index. The choice is counted as
``dispatch_ht_index`` or ``dispatch_searchsorted``.

**uint64 order in int64.** The reference sorts and searches the hashes
as uint64. Here a hash is its int64 bits, as in ``ops/hashing.py``; the
build side is sorted and searched on ``h ^ int64.min``, whose signed
order is the unsigned order, so the build rows, and the joined pairs,
come out in the reference's order. The null sentinels are the
reference's: a null or dead probe row hashes to ``0xFFFF...FFFF`` (-1,
the hash table's empty slot, which the "ht" lookup treats as dead) and
a null build row to ``0xFFFF...FFFE`` (-2), which sorts last.

What the reference compiles into cached XLA programs (the probe count,
the probe chain folded into it, the gather folded into the consumer's
chain) runs here as eager ops on the batches' device; the probe side is
executed as it is planned, a ``FusedStageOp`` running its members, with
the same rows. A context with a memory manager raises: the build side's
spill and its sort-merge fallback wait for the memory manager and
``SortMergeJoinOp`` (both ROADMAP item 18). A string key hashes its bytes
and matches byte for byte at either side's width; string payloads ride
the gathers, and a left or full join pads the build side with null
strings of the build's width, as the reference does. A decimal key
hashes and matches as its int64 (precision <= 18) or its two limbs. A
struct key hashes and matches fieldwise, a null field equal to a null
field; list and map keys raise, as in the reference.

Host syncs per probe batch: one readback of the candidate total, which
sizes the output (``host_readback``), plus the "ht" lookup's one read
per probe round (``hashtable.core.probe_loop``). Per build side: the
"ht" index's one check.
"""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch.columnar.batch import (Decimal128Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn,
                                            compact, gather_batch,
                                            gather_column)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (EvalContext, evaluate, infer_dtype,
                                        null_column_for_field)
from auron_tpu_torch.hashtable import build_join_index
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback, timer)
from auron_tpu_torch.ops.sort import _concat_all
from auron_tpu_torch.utils.shapes import bucket_rows

#: sentinel hashes that keep null keys from matching, as int64 bits:
#: 0xFFFF_FFFF_FFFF_FFFF (probe) and 0xFFFF_FFFF_FFFF_FFFE (build)
_NULL_PROBE = -1
_NULL_BUILD = -2

#: flips the sign bit: int64 order of ``h ^ _SIGN`` is uint64 order of h
_SIGN = torch.iinfo(torch.int64).min

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti", "existence")

#: key types the port hashes and compares
_KEY_TYPES = frozenset({DataType.BOOL, DataType.INT8, DataType.INT16,
                        DataType.INT32, DataType.INT64, DataType.FLOAT32,
                        DataType.FLOAT64, DataType.DATE32,
                        DataType.TIMESTAMP_US, DataType.STRING,
                        DataType.DECIMAL, DataType.STRUCT})


def _key_hashes(cols, cap: int, live: torch.Tensor,
                null_sentinel: int) -> torch.Tensor:
    """xxhash64 of the key columns (int64 bits); ``null_sentinel`` where
    any key is null or the row is dead."""
    h = hashing.xxhash64_columns(list(cols), cap, device=live.device)
    any_null = ~live
    for c in cols:
        any_null = any_null | ~c.validity
    return torch.where(any_null, null_sentinel, h)


def _take_cols(cols, idx: torch.Tensor) -> tuple:
    valid = torch.ones(idx.shape[0], dtype=torch.bool, device=idx.device)
    return tuple(gather_column(c, idx, valid) for c in cols)


def _scatter_true(idx: torch.Tensor, keep: torch.Tensor,
                  size: int) -> torch.Tensor:
    """bool[size]: True at ``idx`` where ``keep`` (the reference's
    ``.at[where(keep, idx, size)].set(True, mode="drop")``). Every write
    stores True, so their order does not matter."""
    out = torch.zeros(size + 1, dtype=torch.bool, device=idx.device)
    out.index_fill_(0, torch.where(keep, idx, size), True)
    return out[:size]


def _expand(lo: torch.Tensor, counts: torch.Tensor, total: int,
            out_cap: int):
    """Candidate runs → (probe_idx, build_idx, in_range) over ``out_cap``
    slots: slot t belongs to the last probe row whose exclusive prefix
    sum of counts is <= t, so a row with no candidates owns no slot."""
    cap = counts.shape[0]
    starts = torch.cumsum(counts, 0) - counts
    slots = torch.arange(out_cap, dtype=torch.int64, device=counts.device)
    probe_idx = (torch.searchsorted(starts, slots, right=True) - 1).clamp(
        0, cap - 1)
    build_idx = lo[probe_idx] + (slots - starts[probe_idx])
    in_range = slots < total
    return probe_idx, torch.where(in_range, build_idx, 0), in_range


def _keys_match(probe_keys, probe_idx, build_keys, build_idx) -> torch.Tensor:
    """Exact key equality per candidate pair (NaN == NaN, -0.0 == 0.0);
    a null key never matches (SQL equi-join)."""
    ok = torch.ones(probe_idx.shape[0], dtype=torch.bool,
                    device=probe_idx.device)
    for pc, bc in zip(probe_keys, build_keys):
        ok = ok & pc.validity[probe_idx] & bc.validity[build_idx] \
            & hashing.pairwise_eq(pc, probe_idx, bc, build_idx)
    return ok


class _BuildSide:
    """The build side sorted by key hash in uint64 order, and (when
    enabled and it fits) the hash-run candidate index over it."""

    def __init__(self, batch: DeviceBatch, schema: Schema, key_exprs,
                 metrics, conf):
        cap = batch.capacity
        keys = [evaluate(e, batch, schema, EvalContext()).col
                for e in key_exprs]
        h = _key_hashes(keys, cap, batch.row_mask(), _NULL_BUILD)
        perm = torch.argsort(h ^ _SIGN, stable=True)
        self.batch = gather_batch(batch, perm, batch.num_rows)
        self.hashes = h[perm]
        #: the sorted hashes as uint64-ordered int64 words (searchsorted)
        self.words = self.hashes ^ _SIGN
        ones = torch.ones(cap, dtype=torch.bool, device=h.device)
        self.keys = tuple(gather_column(c, perm, ones) for c in keys)
        self.capacity = cap
        #: matched build rows of right/full joins, or-accumulated
        self.matched = torch.zeros(cap, dtype=torch.bool, device=h.device)
        self.index = None
        if conf.get(cfg.HASHTABLE_ENABLED) \
                and conf.get(cfg.HASHTABLE_BACKEND) != "sort":
            rounds = max(1, conf.get(cfg.HASHTABLE_MAX_PROBE_ROUNDS))
            self.index = build_join_index(self.hashes, rounds)
        metrics.counter("dispatch_ht_index" if self.index is not None
                        else "dispatch_searchsorted").add(1)

    def lookup(self, h: torch.Tensor):
        """(lo, counts), int64, of each probe hash's run in the sorted
        table; count 0 where the hash is absent. Both searches give the
        same pairs."""
        if self.index is not None:
            lo, counts = self.index.lookup(h)
            return lo.to(torch.int64), counts.to(torch.int64)
        q = h ^ _SIGN
        lo = torch.searchsorted(self.words, q)
        return lo, torch.searchsorted(self.words, q, right=True) - lo


class HashJoinOp(PhysicalOp):
    """Equi-join with the build side fully collected. ``join_type`` is
    one of ``JOIN_TYPES``; the probe side is the left one."""

    name = "hash_join"

    def __init__(self, probe: PhysicalOp, build: PhysicalOp,
                 probe_keys: list[ir.Expr], build_keys: list[ir.Expr],
                 join_type: str = "inner"):
        if join_type not in JOIN_TYPES:
            raise ValueError(f"join type {join_type!r}")
        self.probe = probe
        self.build = build
        self.probe_keys = tuple(probe_keys)
        self.build_keys = tuple(build_keys)
        self.join_type = join_type
        ps, bs = probe.schema(), build.schema()
        for exprs, schema in ((self.probe_keys, ps), (self.build_keys, bs)):
            for e in exprs:
                dt = infer_dtype(e, schema)[0]
                if dt not in _KEY_TYPES:
                    raise NotImplementedError(
                        f"join keys of {dt.value} type are not supported")
        if join_type in ("semi", "anti"):
            self._schema = ps
        elif join_type == "existence":
            self._schema = Schema(tuple(ps.fields)
                                  + (Field("exists", DataType.BOOL, False),))
        else:
            self._schema = Schema(tuple(ps.fields) + tuple(bs.fields))

    @property
    def children(self):
        return [self.probe, self.build]

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        if ctx.mem_manager is not None:
            raise NotImplementedError(
                "HashJoinOp with a memory manager: the build side's spill "
                "and its sort-merge fallback are not ported (ROADMAP item "
                "18)")
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")
        build_time = metrics.counter("build_hash_map_time")
        probe_schema = self.probe.schema()

        def stream():
            build_batches = []
            with timer(build_time):
                for b in self.build.execute(partition, ctx):
                    ctx.check_cancelled()
                    build_batches.append(b)
                merged = None
                if build_batches:
                    merged = _concat_all(build_batches) \
                        if len(build_batches) > 1 else build_batches[0]
            if merged is None:
                yield from self._empty_build_stream(partition, ctx)
                return
            side = _BuildSide(merged, self.build.schema(), self.build_keys,
                              metrics, ctx.conf)
            for probe in self.probe.execute(partition, ctx):
                ctx.check_cancelled()
                yield from self._probe_one(probe, probe_schema, side,
                                           elapsed, ctx.device_sync)
            if self.join_type in ("right", "full"):
                yield self._unmatched_build(side, probe_schema)

        return count_output(stream(), metrics)

    def _probe_one(self, probe: DeviceBatch, probe_schema: Schema,
                   side: _BuildSide, elapsed, sync: bool):
        cap = probe.capacity
        dev = probe.device
        live = probe.row_mask()
        probe_keys = [evaluate(e, probe, probe_schema, EvalContext()).col
                      for e in self.probe_keys]
        with timer(elapsed, sync=sync):
            h = _key_hashes(probe_keys, cap, live, _NULL_PROBE)
            lo, counts = side.lookup(h)
            # the candidate total sizes the output: the probe's sync
            (total,) = host_readback([counts.sum()])

        ok = None
        if self.join_type in ("semi", "anti", "existence", "left", "full") \
                or total > 0:
            with timer(elapsed, sync=sync) as t:
                probe_idx, build_idx, in_range = _expand(
                    lo, counts, total, bucket_rows(max(total, 1)))
                ok = t.track(_keys_match(probe_keys, probe_idx, side.keys,
                                         build_idx) & in_range)

        if self.join_type in ("right", "full") and ok is not None:
            side.matched = side.matched | _scatter_true(build_idx, ok,
                                                        side.capacity)

        if self.join_type in ("semi", "anti", "existence"):
            matched_probe = _scatter_true(probe_idx, ok, cap)
            if self.join_type == "semi":
                yield compact(probe, matched_probe)
            elif self.join_type == "anti":
                yield compact(probe, ~matched_probe & live)
            else:
                flag = PrimitiveColumn(matched_probe, torch.ones(
                    cap, dtype=torch.bool, device=dev))
                yield DeviceBatch(probe.columns + (flag,), probe.num_rows)
            return

        outputs = []
        if total > 0:
            pairs = DeviceBatch(
                _take_cols(probe.columns, probe_idx)
                + _take_cols(side.batch.columns, build_idx),
                torch.full((), ok.shape[0], dtype=torch.int32, device=dev))
            outputs.append(compact(pairs, ok))
        if self.join_type in ("left", "full"):
            # unmatched probe rows, with nulls on the build side
            matched_probe = _scatter_true(probe_idx, ok, cap)
            left = compact(probe, ~matched_probe & live)
            null_build = tuple(_null_column_like(c, cap)
                               for c in side.batch.columns)
            outputs.append(DeviceBatch(left.columns + null_build,
                                       left.num_rows))
        yield from outputs

    def _null_build(self, cap: int, dev) -> tuple:
        """All-null build-side columns: an outer join's padding."""
        return tuple(null_column_for_field(f, cap, dev)
                     for f in self.build.schema())

    def _unmatched_build(self, side: _BuildSide,
                         probe_schema: Schema) -> DeviceBatch:
        """The build rows no probe row matched, with nulls on the probe
        side."""
        unmatched = ~side.matched & side.batch.row_mask()
        build_out = compact(side.batch, unmatched)
        null_probe = tuple(null_column_for_field(f, side.capacity,
                                                 side.batch.device)
                           for f in probe_schema)
        return DeviceBatch(null_probe + build_out.columns,
                           build_out.num_rows)

    def _empty_build_stream(self, partition: int, ctx: ExecContext):
        """A build side with no batch: anti keeps every probe row, semi
        none, existence flags none, left and full pad the build side
        with nulls, inner and right emit nothing."""
        for probe in self.probe.execute(partition, ctx):
            cap, dev = probe.capacity, probe.device
            if self.join_type == "anti":
                yield probe
            elif self.join_type == "semi":
                yield DeviceBatch(probe.columns, torch.zeros(
                    (), dtype=torch.int32, device=dev))
            elif self.join_type == "existence":
                flag = PrimitiveColumn(
                    torch.zeros(cap, dtype=torch.bool, device=dev),
                    torch.ones(cap, dtype=torch.bool, device=dev))
                yield DeviceBatch(probe.columns + (flag,), probe.num_rows)
            elif self.join_type in ("left", "full"):
                yield DeviceBatch(probe.columns + self._null_build(cap, dev),
                                  probe.num_rows)

    def __repr__(self):
        return f"HashJoinOp[{self.join_type}, {len(self.probe_keys)} keys]"


def _null_column_like(col, cap: int):
    """An all-null column of ``cap`` rows shaped like ``col`` (a string
    keeps its width)."""
    dev = col.validity.device
    if isinstance(col, StringColumn):
        return StringColumn(
            torch.zeros((cap, col.width), dtype=torch.uint8, device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev))
    if isinstance(col, Decimal128Column):
        return Decimal128Column(
            torch.zeros(cap, dtype=torch.int64, device=dev),
            torch.zeros(cap, dtype=torch.int64, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev))
    return PrimitiveColumn(torch.zeros(cap, dtype=col.data.dtype, device=dev),
                           torch.zeros(cap, dtype=torch.bool, device=dev))

