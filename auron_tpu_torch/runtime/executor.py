"""Driver-side execution of a plan.

The port of ``auron_tpu.runtime.executor.collect``: every partition of
the plan runs in order, each with its own ``ExecContext``, and the
results are concatenated. ``collect`` returns a pyarrow Table, as the
reference does; ``collect_numpy`` returns per-column numpy arrays and
validity masks and needs no pyarrow, so a plan runs on a machine
without it. Task retries, the scheduler's turns, the stall watchdog and
the query journal wait for later slices.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from auron_tpu_torch.columnar.arrow_bridge import (fetch_numpy,
                                                   strings_to_python)
from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import DataType, Schema
from auron_tpu_torch.ops.base import ExecContext, PhysicalOp, host_readback


def run_partition(plan: PhysicalOp, partition: int, num_partitions: int,
                  config=None, metrics: Optional[dict] = None
                  ) -> Iterator[DeviceBatch]:
    """The non-empty output batches of one partition of ``plan``.
    ``metrics``, when given, is the name-keyed metrics dict the task's
    context records into, shared across calls."""
    ctx = ExecContext(partition_id=partition, num_partitions=num_partitions,
                      config=config)
    if metrics is not None:
        ctx.metrics = metrics
    for batch in plan.execute(partition, ctx):
        (n,) = host_readback([batch.num_rows])
        if n > 0:
            yield batch


def collect(plan: PhysicalOp, num_partitions: int = 1, config=None,
            metrics: Optional[dict] = None):
    """Run every partition of a plan and concatenate: a pyarrow Table."""
    import pyarrow as pa
    from auron_tpu_torch.columnar.arrow_bridge import (schema_to_arrow,
                                                       to_arrow)
    schema = plan.schema()
    batches = [to_arrow(b, schema)
               for p in range(num_partitions)
               for b in run_partition(plan, p, num_partitions, config,
                                      metrics)]
    if not batches:
        return schema_to_arrow(schema).empty_table()
    return pa.Table.from_batches(batches, schema=schema_to_arrow(schema))


def collect_numpy(plan: PhysicalOp, num_partitions: int = 1, config=None,
                  metrics: Optional[dict] = None
                  ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """Run every partition of a plan and concatenate, without pyarrow:
    ``{column name: (values, validity)}`` in row order. Null rows hold
    whatever the device held (the reference's Arrow output masks them);
    a string column's values are an object array of ``str``, None where
    null."""
    schema: Schema = plan.schema()
    parts: list[list[tuple[np.ndarray, np.ndarray]]] = [
        [] for _ in schema]
    for p in range(num_partitions):
        for b in run_partition(plan, p, num_partitions, config, metrics):
            cols, _n = fetch_numpy(b)
            for i, c in enumerate(cols):
                if len(c) == 3:
                    c = (strings_to_python(*c), c[2])
                parts[i].append(c)
    out = {}
    for f, cols in zip(schema, parts):
        dt = np.dtype(object) if f.dtype == DataType.STRING else \
            torch.empty(0, dtype=f.dtype.to_torch()).numpy().dtype
        data = np.concatenate([c[0] for c in cols]) if cols \
            else np.zeros(0, dt)
        valid = np.concatenate([c[1] for c in cols]) if cols \
            else np.zeros(0, np.bool_)
        out[f.name] = (data, valid)
    return out
