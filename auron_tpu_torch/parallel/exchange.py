"""Stage exchange: the hash shuffle on the host route.

The port of ``auron_tpu.parallel.exchange``'s ``ShuffleExchangeOp`` on
its host ("device_buffer") route. The map side runs the child once per
input partition; each batch is split by ONE stable sort by partition id
(dead rows last), and the sorted batch stays on the device with a host
offset index per partition. A reducer partition then reads its row range
from every entry as a gather into a batch of its own bucketed capacity,
never touching other partitions' rows. The exchange is materialized on
the first ``execute`` and memoized.

A range exchange whose plan carries no bounds samples them from the
leading input batches of the same pass, up to ``_RANGE_SAMPLE_ROWS``
rows (``partitioning.compute_range_bounds``, with each key's word
count, so a string key whose width grows later still meets its bounds
word for word); the child runs once, and the sampled batches go first
into the split. The split and the reducers' reads gather every column,
string columns included.

Host syncs: one readback of the per-partition counts per input batch;
a range exchange also reads each sampled batch's row count and copies
the sampled rows' sort words to the host once.

``BroadcastExchangeOp`` collects its child once, over every input
partition, and replays the same batch objects to every consumer
partition (the build side of a join whose sides are not
co-partitioned); it makes no host sync. Spill to host storage, the mesh
(all-to-all) route, map-side combine, the RSS exchange and the
broadcast's subplan cache wait for later slices.
"""

from __future__ import annotations

import itertools
import threading
from typing import Iterator, Optional

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (DeviceBatch, batch_nbytes,
                                            gather_batch)
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback, timer)
from auron_tpu_torch.parallel.partitioning import (RangePartitioning,
                                                   RoundRobinPartitioning,
                                                   compute_range_bounds,
                                                   key_word_counts)
from auron_tpu_torch.utils.shapes import bucket_rows

#: rows sampled for range bounds, as in the reference, which samples
#: on the host as Spark's range partitioner does
_RANGE_SAMPLE_ROWS = 10_000


def _split_body(batch: DeviceBatch, pids: torch.Tensor, num_partitions: int):
    """Stable sort of the rows by target partition id (dead rows to the
    end) and the rows per partition. The counts come from a binary
    search of the sorted ids, not from atomics on num_partitions
    addresses."""
    live = batch.row_mask()
    key = torch.where(live, pids.to(torch.int32), num_partitions)
    perm = torch.argsort(key, stable=True)
    sorted_batch = gather_batch(batch, perm, batch.num_rows)
    bounds = torch.searchsorted(
        key[perm], torch.arange(num_partitions + 1, dtype=torch.int32,
                                device=key.device))
    return sorted_batch, bounds[1:] - bounds[:-1]


class _ExchangeBuffer:
    """The sorted shuffle entries of one exchange: each entry is one
    input batch sorted by partition id plus its host offset index."""

    def __init__(self):
        self.entries: list = []
        self._lock = threading.RLock()

    def add(self, sorted_batch: DeviceBatch, offsets: np.ndarray) -> None:
        with self._lock:
            self.entries.append((sorted_batch, offsets))

    def _entry_partition(self, e, p: int) -> Optional[DeviceBatch]:
        """Partition ``p``'s rows of ONE entry, or None when it has
        none."""
        batch, offsets = e
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        n_p = hi - lo
        if n_p <= 0:
            return None
        cap = bucket_rows(n_p)
        idx = (lo + torch.arange(cap, device=batch.device)).clamp(
            max=batch.capacity - 1)
        return gather_batch(batch, idx, torch.full(
            (), n_p, dtype=torch.int32, device=batch.device))

    def partition_batches(self, p: int) -> Iterator[DeviceBatch]:
        with self._lock:
            entries = list(self.entries)
        for e in entries:
            out = self._entry_partition(e, p)
            if out is not None:
                yield out

    def close(self) -> None:
        with self._lock:
            self.entries = []


def _map_batches(child: PhysicalOp, input_partitions: int,
                 ctx: ExecContext) -> Iterator[DeviceBatch]:
    """Every batch of ``child`` over its input partitions, each map task
    in a context of its own."""
    for in_p in range(input_partitions):
        map_ctx = ctx.child(partition_id=in_p,
                            num_partitions=input_partitions)
        for b in child.execute(in_p, map_ctx):
            map_ctx.check_cancelled()
            yield b


def _refuse_memory_manager(ctx: ExecContext, op: str) -> None:
    if ctx.mem_manager is not None:
        raise NotImplementedError(
            f"{op} with a memory manager: the exchange's spill is not "
            "ported")


class ShuffleExchangeOp(PhysicalOp):
    name = "shuffle_exchange"

    def __init__(self, child: PhysicalOp, partitioning,
                 input_partitions: int = 1):
        self.child = child
        self.partitioning = partitioning
        self.input_partitions = input_partitions
        self._lock = threading.Lock()
        self._buffer: Optional[_ExchangeBuffer] = None

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    @property
    def num_partitions(self) -> int:
        return self.partitioning.num_partitions

    # -- map side -----------------------------------------------------------

    def _materialize(self, ctx: ExecContext) -> _ExchangeBuffer:
        """Run all map tasks; ONE sort-by-pid compaction per batch."""
        metrics = ctx.metrics_for(self)
        write_time = metrics.counter("shuffle_write_total_time")
        _refuse_memory_manager(ctx, "ShuffleExchangeOp")
        buffer = _ExchangeBuffer()
        try:
            self._fill_buffer(ctx, buffer, write_time)
        except BaseException:
            buffer.close()
            raise
        # the routing decision, recorded as the reference records it; the
        # mesh route is not ported, so every exchange takes the host one
        metrics.counter("exchange_route_device_buffer").add(1)
        return buffer

    def _fill_buffer(self, ctx: ExecContext, buffer: _ExchangeBuffer,
                     write_time) -> _ExchangeBuffer:
        schema = self.child.schema()
        n_out = self.num_partitions
        partitioning = self.partitioning
        if not hasattr(partitioning, "partition_ids"):
            raise NotImplementedError(
                f"{type(partitioning).__name__}: not ported")
        sync = ctx.device_sync
        live_bytes = ctx.metrics_for(self).counter("shuffle_bytes_live")
        batches = _map_batches(self.child, self.input_partitions, ctx)
        pending: list[DeviceBatch] = []
        if isinstance(partitioning, RangePartitioning) \
                and not partitioning.bounds:
            # bounds from the LEADING batches of this same pass: the
            # child is never executed twice
            sampled = 0
            for batch in batches:
                pending.append(batch)
                (n,) = host_readback([batch.num_rows])
                sampled += n
                if sampled >= _RANGE_SAMPLE_ROWS:
                    break
            orders = partitioning.sort_orders
            partitioning = RangePartitioning(
                orders, n_out,
                compute_range_bounds(pending, orders, schema, n_out),
                key_word_counts(pending, orders, schema))
            self.partitioning = partitioning
        row_offset = 0
        for batch in itertools.chain(pending, batches):
            with timer(write_time, sync=sync) as t:
                if isinstance(partitioning, RoundRobinPartitioning):
                    part = RoundRobinPartitioning(n_out, row_offset)
                    pids = part.partition_ids(batch, schema)
                else:
                    pids = partitioning.partition_ids(batch, schema)
                sorted_batch, counts = t.track(
                    _split_body(batch, pids, n_out))
                # the counts readback is the map side's sync point
                (counts_h,) = host_readback([counts])
            live_rows = sum(counts_h)
            row_offset += live_rows
            live_bytes.add(batch_nbytes(sorted_batch) * live_rows
                           // max(sorted_batch.capacity, 1))
            offsets = np.concatenate([np.zeros(1, np.int64),
                                      np.cumsum(counts_h, dtype=np.int64)])
            buffer.add(sorted_batch, offsets)
        return buffer

    # -- reduce side --------------------------------------------------------

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        with self._lock:
            if self._buffer is None:
                self._buffer = self._materialize(ctx)
        metrics = ctx.metrics_for(self, "_read")
        read_time = metrics.counter("shuffle_read_total_time")
        buf = self._buffer

        def stream():
            it = buf.partition_batches(partition)
            while True:
                ctx.check_cancelled()
                with timer(read_time, sync=False):
                    b = next(it, None)
                if b is None:
                    return
                yield b

        return count_output(stream(), metrics, timed=True)

    def __repr__(self):
        return (f"ShuffleExchangeOp[{type(self.partitioning).__name__} "
                f"{self.input_partitions}->{self.num_partitions}]")


class BroadcastExchangeOp(PhysicalOp):
    """Collect the child once, over all ``input_partitions``, and replay
    the same batches to every consumer partition. A consumer must not
    write into them: ``owns_output`` is False."""

    name = "broadcast_exchange"
    owns_output = False

    def __init__(self, child: PhysicalOp, input_partitions: int = 1):
        self.child = child
        self.input_partitions = input_partitions
        self._lock = threading.Lock()
        self._batches: Optional[list[DeviceBatch]] = None

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        _refuse_memory_manager(ctx, "BroadcastExchangeOp")
        metrics = ctx.metrics_for(self)
        with self._lock:
            if self._batches is None:
                self._batches = list(_map_batches(
                    self.child, self.input_partitions, ctx))
        return count_output(iter(self._batches), metrics, timed=True)
