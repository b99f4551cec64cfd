"""Uncorrelated scalar subquery resolution.

The port of ``auron_tpu.ops.subquery`` (reference:
datafusion-ext-exprs/src/spark_scalar_subquery_wrapper.rs, where the
host engine evaluates the subquery; here the engine runs the embedded
child plan itself). ``ScalarSubqueryBinderOp`` wraps a plan that holds
scalar_subquery expressions: at its first ``execute`` it runs each
subquery plan to one value (0 rows give NULL, more than one row raises,
as Spark's "more than one row returned by a subquery used as an
expression"), then re-plans the tree with the values substituted as
literals, so every operator below sees plain constants. Resolution
happens once per task, not per partition: the resolved plan is kept.

The subquery runs on the planner context's device; its one row comes
back through ``to_arrow``, which counts its reads in
``host_readback.syncs``.
"""

from __future__ import annotations

import datetime
import decimal
import threading
import time
from typing import Iterator, Optional

from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import DataType, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ir import auron_pb2 as pb
from auron_tpu_torch.ops.base import ExecContext, PhysicalOp, host_readback


class ScalarSubqueryError(RuntimeError):
    """A scalar subquery returned more than one row."""


class ScalarSubqueryBinderOp(PhysicalOp):
    name = "scalar_subquery_binder"

    #: subqueries resolved and the wall nanoseconds spent resolving them,
    #: over every binder of the process (a harness resets and reads them)
    resolved = 0
    resolve_ns = 0

    def __init__(self, node: pb.PlanNode, planner_ctx):
        self._node = node
        self._planner_ctx = planner_ctx
        self._lock = threading.Lock()
        self._inner: Optional[PhysicalOp] = None
        self._schema_op: Optional[PhysicalOp] = None

    def _literals(self, value_of) -> pb.PlanNode:
        """The plan with every subquery replaced by the literal of
        ``value_of(q)``, each distinct ``subquery_key`` asked once."""
        from auron_tpu_torch.ir.planner import (_collect_subqueries,
                                                substitute_subqueries,
                                                subquery_key)
        from auron_tpu_torch.ir.serde import _P_TO_DT, expr_to_proto
        values = {}
        for q in _collect_subqueries(self._node):
            key = subquery_key(q)
            if key not in values:
                values[key] = expr_to_proto(ir.Literal(
                    value_of(q), _P_TO_DT[q.dtype], q.precision, q.scale))
        return substitute_subqueries(self._node, values)

    # -- schema before resolution: typed NULLs in place of the values -------

    def schema(self) -> Schema:
        if self._inner is not None:
            return self._inner.schema()
        if self._schema_op is None:
            from auron_tpu_torch.ir.planner import PhysicalPlanner
            self._schema_op = PhysicalPlanner(self._planner_ctx).create_plan(
                self._literals(lambda q: None))
        return self._schema_op.schema()

    @property
    def children(self):
        inner = self._inner or self._schema_op
        return [inner] if inner is not None else []

    # -- resolution ---------------------------------------------------------

    def _resolve_one(self, q: pb.ScalarSubqueryE, ctx: ExecContext):
        """Run one subquery plan to its end as one partition."""
        from auron_tpu_torch.columnar.arrow_bridge import to_arrow
        from auron_tpu_torch.ir.planner import PhysicalPlanner
        t0 = time.perf_counter_ns()
        # plan_task, not create_plan: the subquery's own plan may hold
        # further subqueries, which a nested binder resolves
        op = PhysicalPlanner(self._planner_ctx).plan_task(
            pb.TaskDefinition(plan=q.plan))
        # ctx.child keeps the cancellation flag: cancelling the task also
        # stops a subquery in flight
        sub_ctx = ctx.child(partition_id=0, num_partitions=1, metrics={})
        rows, value = 0, None
        for batch in op.execute(0, sub_ctx):
            sub_ctx.check_cancelled()
            (n,) = host_readback([batch.num_rows])
            if n == 0:
                continue
            rb = to_arrow(batch, op.schema())
            rows += rb.num_rows
            if rows > 1:
                raise ScalarSubqueryError(
                    "more than one row returned by a subquery used as "
                    "an expression")
            value = rb.column(0)[0].as_py()
        cls = type(self)
        cls.resolved += 1
        cls.resolve_ns += time.perf_counter_ns() - t0
        return self._normalize(value, q)

    @staticmethod
    def _normalize(value, q: pb.ScalarSubqueryE):
        """An Arrow python scalar as the engine's Literal value: decimals
        as unscaled ints, dates as epoch days, timestamps as epoch
        microseconds."""
        if value is None:
            return None
        from auron_tpu_torch.ir.serde import _P_TO_DT
        dt = _P_TO_DT[q.dtype]
        if dt == DataType.DECIMAL and isinstance(value, decimal.Decimal):
            return int(value.scaleb(q.scale).to_integral_value())
        if dt == DataType.DATE32 and isinstance(value, datetime.date):
            return (value - datetime.date(1970, 1, 1)).days
        if dt == DataType.TIMESTAMP_US \
                and isinstance(value, datetime.datetime):
            if value.tzinfo is None:
                value = value.replace(tzinfo=datetime.timezone.utc)
            # integer arithmetic: float .timestamp() has ~0.24 us ulp at
            # the current epoch and can be off by one microsecond
            epoch = datetime.datetime(1970, 1, 1,
                                      tzinfo=datetime.timezone.utc)
            return (value - epoch) // datetime.timedelta(microseconds=1)
        return value

    def _resolved_inner(self, ctx: ExecContext) -> PhysicalOp:
        with self._lock:
            if self._inner is None:
                from auron_tpu_torch.ir.planner import PhysicalPlanner
                node = self._literals(lambda q: self._resolve_one(q, ctx))
                planner = PhysicalPlanner(self._planner_ctx)
                # finalize_plan: the substituted plan is fused as a plan
                # without subqueries would be
                self._inner = planner.finalize_plan(planner.create_plan(node))
            return self._inner

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        yield from self._resolved_inner(ctx).execute(partition, ctx)

    def __repr__(self):
        return "ScalarSubqueryBinderOp"
