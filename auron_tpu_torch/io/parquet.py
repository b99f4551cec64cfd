"""Scans: parquet files, in-memory Arrow batches, device batches.

The port of ``auron_tpu.io.parquet``. ``ParquetScanOp`` reads the
columns it is asked for (all by default) with pyarrow and hands padded
``DeviceBatch``es to the device through the pinned host → device copy
of ``columnar/arrow_bridge.py``, synchronously on the query thread: the
reference's serial mode. Predicate pushdown and the background
prefetcher (``ScanPrefetcher``) wait for a later slice.

A parquet scan learns each string column's width bucket from the first
batch it reads (``_widths_for``, as the reference's) and pins it, so the
batches of a scan share one width; it widens only when a later batch
holds a longer value. A memory scan buckets each batch on its own.

The Arrow scans run on ``cuda`` unless they are given another device,
and raise without CUDA (``auron_tpu_torch.resolve_device``).

pyarrow is imported inside the functions that read Arrow data, so
``DeviceBatchScanOp`` — a scan over batches already on the device —
runs without it.
"""

from __future__ import annotations

from typing import Iterator, Optional

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow, to_device
from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      timer)
from auron_tpu_torch.utils.shapes import (DEFAULT_BATCH_CAPACITY, bucket_rows,
                                          bucket_string_width)


class ParquetScanOp(PhysicalOp):
    name = "parquet_scan"

    def __init__(self, files: list[str], schema: Optional[Schema] = None,
                 columns: Optional[list[str]] = None,
                 batch_rows: int = DEFAULT_BATCH_CAPACITY, device=None,
                 string_widths: Optional[dict[str, int]] = None):
        import pyarrow as pa
        import pyarrow.dataset as pa_ds
        self.files = list(files)
        self.columns = list(columns) if columns else None
        self.batch_rows = batch_rows
        self.device = resolve_device(device)
        arrow_schema = pa_ds.dataset(self.files, format="parquet").schema
        if self.columns:
            arrow_schema = pa.schema([arrow_schema.field(c)
                                      for c in self.columns])
        self._schema = schema or schema_from_arrow(arrow_schema)
        self._cap_cache: dict[int, int] = {}
        #: string column → width bucket, learned from the first batch
        #: read and then pinned (widened by a longer value)
        self.string_widths = dict(string_widths or {})

    @property
    def children(self):
        return []

    def schema(self) -> Schema:
        return self._schema

    def _partition_files(self, partition: int,
                         num_partitions: int) -> list[str]:
        return [f for i, f in enumerate(self.files)
                if i % num_partitions == partition]

    def _capacity_for(self, partition: int, files: list[str]) -> int:
        """Conversion capacity for one partition's files: batch_rows,
        clamped to the partition's row-count bucket (from the parquet
        footers, cached per partition) so a small file never pads to the
        full batch size."""
        cap = self._cap_cache.get(partition)
        if cap is not None:
            return cap
        import pyarrow.dataset as pa_ds
        cap = self.batch_rows
        total = pa_ds.dataset(files, format="parquet").count_rows()
        if total:
            cap = min(self.batch_rows, bucket_rows(int(total)))
        self._cap_cache[partition] = cap
        return cap

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)
        io_time = metrics.counter("io_time")
        files = self._partition_files(partition, max(ctx.num_partitions, 1))
        capacity = (self._capacity_for(partition, files)
                    if files else self.batch_rows)

        def host_batches():
            if not files:
                return
            import pyarrow.dataset as pa_ds
            scanner = pa_ds.dataset(files, format="parquet").scanner(
                columns=self.columns, batch_size=self.batch_rows)
            for rb in scanner.to_batches():
                if rb.num_rows == 0:
                    continue
                # the scanner's batch_size is a hint: split oversized
                # batches
                rows = self.batch_rows
                for off in range(0, rb.num_rows, rows):
                    yield rb.slice(off, min(rows, rb.num_rows - off))

        def stream():
            for rb in host_batches():
                ctx.check_cancelled()
                with timer(io_time):
                    yield to_device(rb, capacity=capacity,
                                    device=self.device,
                                    string_widths=self._widths_for(rb))[0]

        return count_output(stream(), metrics, timed=True)

    def _widths_for(self, rb) -> dict[str, int]:
        """Stable width buckets per string column, learned once per scan
        from the first batch and then pinned; a longer value widens its
        column's bucket. Dictionary columns are not pinned."""
        import pyarrow as pa
        import pyarrow.compute as pc
        widths = self.string_widths
        for i, f in enumerate(rb.schema):
            if not (pa.types.is_string(f.type)
                    or pa.types.is_large_string(f.type)):
                continue
            col = rb.column(i)
            if f.name not in widths:
                max_len = pc.max(pc.binary_length(col)).as_py() or 1
                widths[f.name] = bucket_string_width(max(max_len, 1))
            else:
                max_len = pc.max(pc.binary_length(col)).as_py() or 0
                if max_len > widths[f.name]:
                    widths[f.name] = bucket_string_width(max_len)
        return widths

    def __repr__(self):
        return f"{type(self).__name__}[{len(self.files)} files]"


class MemoryScanOp(PhysicalOp):
    """In-memory source over pyarrow RecordBatches, one list per
    partition (tests and small inputs)."""

    name = "memory_scan"

    def __init__(self, partitions: list, schema: Schema,
                 capacity: int = DEFAULT_BATCH_CAPACITY, device=None):
        self.partitions = partitions
        self._schema = schema
        self.capacity = capacity
        self.device = resolve_device(device)

    @property
    def children(self):
        return []

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)

        def stream():
            for rb in self.partitions[partition]:
                if rb.num_rows:
                    yield to_device(rb, capacity=self.capacity,
                                    device=self.device)[0]

        return count_output(stream(), metrics, timed=True)


class DeviceBatchScanOp(PhysicalOp):
    """Source over batches already on the device: ``partitions`` is a
    list of per-partition lists of ``DeviceBatch``es, or a callable
    from the partition to such a list. ``device`` is where they live:
    by default the first batch's (a callable source must name it). A
    batch on another device fails the scan, since the operators above
    choose their kernels from the scan's device."""

    name = "device_scan"
    #: replays stored batches that later readers share
    owns_output = False

    def __init__(self, partitions, schema: Schema, device=None):
        if device is None:
            if callable(partitions):
                raise ValueError("DeviceBatchScanOp over a callable needs "
                                 "its device")
            first = next((b for part in partitions for b in part), None)
            if first is None:
                raise ValueError("DeviceBatchScanOp with no batches needs "
                                 "its device")
            device = first.device
        self.partitions = partitions
        self._schema = schema
        self.device = resolve_device(device)

    @property
    def children(self):
        return []

    def schema(self) -> Schema:
        return self._schema

    def _on_device(self, batch: DeviceBatch) -> DeviceBatch:
        dev = batch.device
        if dev.type != self.device.type or (
                self.device.index is not None
                and dev.index != self.device.index):
            raise ValueError(f"DeviceBatchScanOp on {self.device} got a "
                             f"batch on {dev}")
        return batch

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        parts = self.partitions(partition) if callable(self.partitions) \
            else self.partitions[partition]
        metrics = ctx.metrics_for(self)
        return count_output(map(self._on_device, parts), metrics,
                            timed=True)
