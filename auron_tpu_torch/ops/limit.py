"""Limit / union / coalesce-batches / empty / rename operators.

The port of ``auron_tpu.ops.limit``. A limit and a coalesce read each
batch's row count on the host (``host_readback``), as the reference's
do with ``int(batch.num_rows)``; union, empty partitions and rename
read nothing.
"""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch.columnar.batch import (DeviceBatch, concat_batches,
                                            resize)
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback)
from auron_tpu_torch.utils.shapes import bucket_rows


def _truncated(batch: DeviceBatch, rows: int) -> DeviceBatch:
    return DeviceBatch(batch.columns, torch.full(
        (), rows, dtype=torch.int32, device=batch.device))


class LimitOp(PhysicalOp):
    name = "limit"
    fusable = True
    owns_output = "inherit"   # yields the child's batches (truncated)

    def __init__(self, child: PhysicalOp, limit: int):
        self.child = child
        self.limit = limit

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    def build_kernel_fragment(self):
        """Limit within a batch as a carry: the carry is the remaining
        row budget, truncation rewrites ``num_rows`` (no data moves),
        and the stage stops pulling its input once the budget is spent
        (``FusedStageOp.execute``)."""
        from auron_tpu_torch.ops.fused import KernelFragment

        def apply(batch, partition_id, carry):
            (n,) = host_readback([batch.num_rows])
            take = min(n, max(carry, 0))
            out = batch if take == n else _truncated(batch, take)
            return (out,), carry - take

        return KernelFragment(apply=apply, init_carry=self.limit,
                              is_limit=True)

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)

        def stream():
            remaining = self.limit
            for batch in self.child.execute(partition, ctx):
                if remaining <= 0:
                    break
                (n,) = host_readback([batch.num_rows])
                if n <= remaining:
                    remaining -= n
                    yield batch
                else:
                    yield _truncated(batch, remaining)
                    remaining = 0
                    break

        return count_output(stream(), metrics, timed=True)

    def __repr__(self):
        return f"LimitOp[{self.limit}]"


class UnionOp(PhysicalOp):
    """UNION ALL: chains the children's streams of the same partition."""

    name = "union"
    owns_output = "inherit"

    def __init__(self, inputs: list[PhysicalOp]):
        self.inputs = inputs

    @property
    def children(self):
        return list(self.inputs)

    def schema(self) -> Schema:
        return self.inputs[0].schema()

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)

        def stream():
            for child in self.inputs:
                yield from child.execute(partition, ctx)

        return count_output(stream(), metrics, timed=True)


class CoalesceBatchesOp(PhysicalOp):
    """Merge small batches up to a target row count so the operators
    above run on full batches."""

    name = "coalesce_batches"
    owns_output = "inherit"   # big batches pass through unchanged

    def __init__(self, child: PhysicalOp, target_rows: int):
        self.child = child
        self.target_rows = target_rows

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)
        target_cap = bucket_rows(self.target_rows)

        def stream():
            acc = None
            acc_rows = 0
            for batch in self.child.execute(partition, ctx):
                (n,) = host_readback([batch.num_rows])
                if n == 0:
                    continue
                if n >= self.target_rows and acc is None:
                    yield batch
                    continue
                if acc is None:
                    acc = resize(batch, target_cap)
                    acc_rows = n
                else:
                    grown = concat_batches(acc, batch)
                    acc = resize(grown, max(target_cap, grown.capacity)) \
                        if grown.capacity > target_cap else grown
                    acc_rows += n
                if acc_rows >= self.target_rows:
                    yield acc
                    acc = None
                    acc_rows = 0
            if acc is not None and acc_rows > 0:
                yield acc

        return count_output(stream(), metrics, timed=True)


class EmptyPartitionsOp(PhysicalOp):
    """Produces N empty partitions."""

    name = "empty_partitions"

    def __init__(self, schema: Schema, num_partitions: int):
        self._schema = schema
        self.num_partitions = num_partitions

    @property
    def children(self):
        return []

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        return iter(())


class RenameColumnsOp(PhysicalOp):
    """Schema-only rename."""

    name = "rename_columns"
    fusable = True
    owns_output = "inherit"

    def __init__(self, child: PhysicalOp, names: list[str]):
        self.child = child
        self.names = list(names)
        base = child.schema()
        self._schema = Schema(tuple(f.with_name(n)
                                    for f, n in zip(base, self.names)))

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def build_kernel_fragment(self):
        """Identity fragment: fusion chains cross renames for free."""
        from auron_tpu_torch.ops.fused import KernelFragment
        return KernelFragment(apply=lambda batch, pid, carry:
                              ((batch,), carry))

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        return self.child.execute(partition, ctx)
