"""Session: catalog, config and plan execution for the DataFrame DSL.

The port of ``auron_tpu.frontend.session``: it owns the table catalog
and the planner context, serializes each DataFrame's plan to
``TaskDefinition`` bytes, plans them (``ir.planner.plan_from_bytes``)
and runs every partition through ``runtime.executor.collect``. The
session runs on ``cuda`` unless it is given another device, and raises
without CUDA.

The reference Session's query scheduler, crash-safe journal, result
cache, ahead-of-time warmer, watchdog, ops server, per-query deadlines
and host functions (``map_batches``) have no counterpart yet.

pyarrow is imported inside the functions that read Arrow data.
"""

from __future__ import annotations

import itertools
from typing import Optional

from auron_tpu_torch import resolve_device
from auron_tpu_torch.frontend.dataframe import DataFrame
from auron_tpu_torch.ir import auron_pb2 as pb
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.runtime.executor import collect as _collect


class Session:
    def __init__(self, batch_capacity: Optional[int] = None, config=None,
                 device=None):
        from auron_tpu_torch.config import get_config
        self.config = config or get_config()
        self.device = resolve_device(device)
        self.ctx = PlannerContext(batch_capacity=batch_capacity,
                                  config=self.config, device=self.device)
        self._ids = itertools.count()
        self._closed = False

    # -- sources ------------------------------------------------------------

    def register(self, name: str, table) -> None:
        self.ctx.catalog[name] = table

    def table(self, name: str) -> DataFrame:
        from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow
        table = self.ctx.catalog[name]
        node = pb.PlanNode(memory_scan=pb.MemoryScanNode(table_name=name))
        return DataFrame(self, node, schema_from_arrow(table.schema))

    def from_arrow(self, table, name: Optional[str] = None) -> DataFrame:
        name = name or f"__mem_{next(self._ids)}"
        self.register(name, table)
        return self.table(name)

    def read_parquet(self, files, columns=None,
                     partitions: Optional[int] = None) -> DataFrame:
        """``partitions`` sets the scan parallelism (files are split
        round-robin across partitions, like Spark input splits); default
        1. With ``columns`` only those are read, in the order asked for,
        so a file may hold columns of types the port does not carry."""
        import pyarrow as pa
        import pyarrow.parquet as pq
        from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow
        files = [files] if isinstance(files, str) else list(files)
        node = pb.PlanNode(parquet_scan=pb.ParquetScanNode(
            files=files, columns=columns or []))
        arrow = pq.read_schema(files[0])
        if columns:
            # pruned before conversion: the other columns' types are
            # never asked about
            arrow = pa.schema([arrow.field(c) for c in columns])
        return DataFrame(self, node, schema_from_arrow(arrow),
                         num_partitions=partitions or 1)

    # -- execution ----------------------------------------------------------

    def plan_physical(self, df: DataFrame):
        return plan_from_bytes(df.task_bytes(), self.ctx)

    def execute(self, df: DataFrame, metrics: Optional[dict] = None):
        """Plan ``df`` and run every partition: a pyarrow Table."""
        if self._closed:
            raise RuntimeError("the session is closed")
        return _collect(self.plan_physical(df),
                        num_partitions=df.num_partitions,
                        config=self.config, metrics=metrics)

    def close(self) -> None:
        """End the session: drop its catalog."""
        self._closed = True
        self.ctx.catalog.clear()

    def __enter__(self) -> "Session":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
