"""Projection and filter operators, and the two fused.

The port of ``auron_tpu.ops.project``: each batch is evaluated with the
port's expression evaluator; a filter compacts the surviving rows to
the front of a batch of the same capacity (``columnar.batch.compact``),
so nothing leaves the device and no row count is read on the host.
"""

from __future__ import annotations

from typing import Iterator

import torch

from auron_tpu_torch.columnar.batch import DeviceBatch, compact
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import EvalContext, evaluate, infer_field
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      timer)


def project_schema(exprs: tuple, names: tuple[str, ...],
                   in_schema: Schema) -> Schema:
    return Schema(tuple(infer_field(e, in_schema, name=n)
                        for e, n in zip(exprs, names)))


def _keep(predicates: tuple, batch: DeviceBatch, in_schema: Schema,
          ectx: EvalContext) -> torch.Tensor:
    """Live rows on which every predicate is true (null drops)."""
    keep = batch.row_mask()
    for p in predicates:
        v = evaluate(p, batch, in_schema, ectx)
        keep = keep & v.data.bool() & v.validity
    return keep


def _project(exprs: tuple, batch: DeviceBatch, in_schema: Schema,
             ectx: EvalContext) -> DeviceBatch:
    return DeviceBatch(tuple(evaluate(e, batch, in_schema, ectx).col
                             for e in exprs), batch.num_rows)


def _fragment(step):
    """The fragment of an operator whose batch step is ``step(batch,
    ectx)``: each batch gets a fresh common-subexpression memo; the carry
    (the row offset of row-numbering expressions, which the port's
    evaluator does not have) passes through."""
    from auron_tpu_torch.ops.fused import KernelFragment

    def apply(batch, partition_id, carry):
        return (step(batch, EvalContext(partition_id=partition_id,
                                        memo={})),), carry

    return KernelFragment(apply=apply)


def _stream(op, partition: int, ctx: ExecContext, step):
    """Run ``step(batch, ectx)`` over the child's batches, timed; each
    batch gets a fresh common-subexpression memo, which a filter and its
    projection share."""
    metrics = ctx.metrics_for(op)
    elapsed = metrics.counter("elapsed_compute")
    sync = ctx.device_sync

    def stream():
        for batch in op.child.execute(partition, ctx):
            ctx.check_cancelled()
            ectx = EvalContext(partition_id=partition, memo={})
            with timer(elapsed, sync=sync) as t:
                out = t.track(step(batch, ectx))
            yield out

    return count_output(stream(), metrics)


class ProjectOp(PhysicalOp):
    name = "project"
    fusable = True
    fragment_computes = True

    def __init__(self, child: PhysicalOp, exprs: list[ir.Expr],
                 names: list[str]):
        self.child = child
        self.exprs = tuple(exprs)
        self.names = tuple(names)
        self._schema = project_schema(self.exprs, self.names,
                                      child.schema())

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def _step(self, batch: DeviceBatch, ectx: EvalContext) -> DeviceBatch:
        return _project(self.exprs, batch, self.child.schema(), ectx)

    def build_kernel_fragment(self):
        return _fragment(self._step)

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        return _stream(self, partition, ctx, self._step)

    def __repr__(self):
        return f"ProjectOp[{', '.join(self.names)}]"


class FilterOp(PhysicalOp):
    name = "filter"
    fusable = True
    fragment_computes = True

    def __init__(self, child: PhysicalOp, predicates: list[ir.Expr]):
        self.child = child
        self.predicates = tuple(predicates)

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    def _step(self, batch: DeviceBatch, ectx: EvalContext) -> DeviceBatch:
        return compact(batch, _keep(self.predicates, batch,
                                    self.child.schema(), ectx))

    def build_kernel_fragment(self):
        return _fragment(self._step)

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        return _stream(self, partition, ctx, self._step)

    def __repr__(self):
        return f"FilterOp[{len(self.predicates)} predicates]"


class FilterProjectOp(PhysicalOp):
    """Filter, then project the surviving rows."""

    name = "filter_project"

    def __init__(self, child: PhysicalOp, predicates: list[ir.Expr],
                 exprs: list[ir.Expr], names: list[str]):
        self.child = child
        self.predicates = tuple(predicates)
        self.exprs = tuple(exprs)
        self.names = tuple(names)
        self._schema = project_schema(self.exprs, self.names,
                                      child.schema())

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        in_schema = self.child.schema()

        def step(b, ectx):
            filtered = compact(b, _keep(self.predicates, b, in_schema, ectx))
            return _project(self.exprs, filtered, in_schema, ectx)

        return _stream(self, partition, ctx, step)

    def __repr__(self):
        return (f"FilterProjectOp[{len(self.predicates)} predicates -> "
                f"{', '.join(self.names)}]")
