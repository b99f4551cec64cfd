"""Expand operator: N projections per input row (the lowering of
GROUPING SETS, ROLLUP and CUBE).

The port of ``auron_tpu.ops.expand``. Each projection is evaluated as a
``ProjectOp`` would evaluate it; the outputs are one batch per
projection per input batch rather than interleaved rows: downstream is
an aggregate, which does not depend on row order, and whole batches
keep every step dense.

The reference hands each projection the row offset of its input batch
for row-numbering expressions; the port's evaluator has none yet
(ROADMAP item 17b-b), so the fragment's carry passes through, as
``ProjectOp``'s does.
"""

from __future__ import annotations

from typing import Iterator, Optional

from auron_tpu_torch.columnar.schema import Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import EvalContext, infer_dtype
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      timer)
from auron_tpu_torch.ops.project import _project


class ExpandOp(PhysicalOp):
    name = "expand"
    fusable = True
    fragment_computes = True

    def __init__(self, child: PhysicalOp, projections: list[list[ir.Expr]],
                 names: Optional[list[str]] = None):
        assert projections and all(
            len(p) == len(projections[0]) for p in projections), \
            "expand projections must agree on arity"
        self.child = child
        self.projections = tuple(tuple(p) for p in projections)
        self.fusion_fanout = len(self.projections)
        in_schema = child.schema()
        n_out = len(self.projections[0])
        self.names = list(names or [f"c{i}" for i in range(n_out)])
        # the first projection types the output (the others must agree,
        # as the host's converter guarantees)
        fields = []
        for i in range(n_out):
            dt, p, s = infer_dtype(self.projections[0][i], in_schema)
            fields.append(Field(self.names[i], dt, True, p, s))
        self._schema = Schema(tuple(fields))

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def _expand(self, batch, partition_id) -> list:
        """One batch per projection, each with its own expression memo,
        as the reference's per-projection programs."""
        in_schema = self.child.schema()
        return [_project(proj, batch, in_schema,
                         EvalContext(partition_id=partition_id, memo={}))
                for proj in self.projections]

    def build_kernel_fragment(self):
        from auron_tpu_torch.ops.fused import KernelFragment

        def apply(batch, partition_id, carry):
            return tuple(self._expand(batch, partition_id)), carry

        return KernelFragment(apply=apply)

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator:
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")

        def stream():
            for batch in self.child.execute(partition, ctx):
                ctx.check_cancelled()
                with timer(elapsed, sync=ctx.device_sync) as t:
                    outs = t.track(self._expand(batch, partition))
                yield from outs

        return count_output(stream(), metrics)

    def __repr__(self):
        return f"ExpandOp[{len(self.projections)} projections]"
