"""Physical planner: proto PlanNode → PhysicalOp tree.

The port of ``auron_tpu.ir.planner`` for the nodes the port has
operators for: the parquet, memory and empty-partitions scans, filter,
project, agg, sort, limit, union, coalesce, rename, window, expand, the
hash join, the broadcast exchange and the shuffle writer (hash,
round-robin, single and range) on its host route. The sort-merge and broadcast joins raise
``NotImplementedError`` naming the items that bring them, and so does a
broadcast exchange that publishes its output as a resource; every other
node raises naming itself. Scans run on the context's device.

A task whose plan holds uncorrelated scalar subqueries plans to
``ops/subquery.py``'s ``ScalarSubqueryBinderOp``, which runs each
subquery once, substitutes its value as a literal and plans the rest
(``_collect_subqueries``, ``subquery_key``, ``substitute_subqueries``).

After planning, ``fuse_stages`` chains row-local operators into
``FusedStageOp``s as the reference's pass does, a chain stopping
where the product of its members' fan-outs would pass 16. Two of the
reference's post-planning passes wait: the map-side combine fold
(``_fold_combine``, with ``AggOp.build_combine_stage``), so every
exchange stays unfolded, which gives the same rows; and the mesh
annotation (``annotate_mesh``), with the mesh. Where the reference
would fold a combine, the partial agg's lone computing child is wrapped
in a stage of its own, as the fold wraps it, so the trees stay the
reference's.

pyarrow is imported inside the functions that read Arrow data.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Any, Optional

from auron_tpu_torch import config as cfg
from auron_tpu_torch import resolve_device
from auron_tpu_torch.exprs import ir as eir
from auron_tpu_torch.ir import auron_pb2 as pb
from auron_tpu_torch.ir import serde
from auron_tpu_torch.ops.base import PhysicalOp


@dataclass
class PlannerContext:
    """Host-side environment plans resolve against.

    catalog: table name → pyarrow.Table (or a list of per-partition
      RecordBatch lists) for MemoryScanNode.
    device: where the plan's scans put their batches: ``cuda`` unless
      another is named (``resolve_device``).

    The reference's resource map (the inputs of IPC-reader and
    broadcast-join nodes) and plan fingerprint (the key of ir/cost.py's
    history) come with the nodes and the cost model that read them.
    """

    catalog: dict[str, Any] = field(default_factory=dict)
    # None = resolve from the config (auron.batch.capacity)
    batch_capacity: Optional[int] = None
    config: Optional[Any] = None
    device: Any = None
    #: (table name, column index) -> (table, (min, max)): the key-column
    #: stats scan of the dense-domain derivation, paid once per
    #: registered table; hits only on the same table object (``is``)
    _col_stats: dict = field(default_factory=dict)

    def __post_init__(self):
        if self.config is None:
            self.config = cfg.get_config()
        if self.batch_capacity is None:
            self.batch_capacity = self.config.get(cfg.BATCH_CAPACITY)
        self.device = resolve_device(self.device)


class PhysicalPlanner:
    def __init__(self, ctx: Optional[PlannerContext] = None):
        self.ctx = ctx or PlannerContext()

    # -- entry points -------------------------------------------------------

    def plan_task(self, task: pb.TaskDefinition) -> PhysicalOp:
        if _collect_subqueries(task.plan):
            # every uncorrelated scalar subquery of the tree resolves once
            # at task start; the binder re-plans with the values as
            # literals and applies the fusion pass after substitution
            from auron_tpu_torch.ops.subquery import ScalarSubqueryBinderOp
            return ScalarSubqueryBinderOp(task.plan, self.ctx)
        return self.finalize_plan(self.create_plan(task.plan))

    def finalize_plan(self, op: PhysicalOp) -> PhysicalOp:
        """Post-planning passes over the operator tree: whole-stage
        fusion."""
        return fuse_stages(op, self.ctx.config)

    def create_plan(self, node: pb.PlanNode) -> PhysicalOp:
        kind = node.WhichOneof("node")
        if kind is None:
            raise ValueError("empty PlanNode")
        handler = getattr(self, f"_plan_{kind}", None)
        if handler is None:
            raise NotImplementedError(f"plan node {kind!r} not supported yet")
        return handler(getattr(node, kind))

    # -- sources ------------------------------------------------------------

    def _file_scan_batch_rows(self) -> int:
        return cfg.file_scan_batch_rows(self.ctx.config, self.ctx.device)

    def _plan_parquet_scan(self, n: pb.ParquetScanNode) -> PhysicalOp:
        from auron_tpu_torch.io.parquet import ParquetScanOp
        if n.predicates:
            raise NotImplementedError("parquet scan predicate pushdown")
        return ParquetScanOp(
            files=list(n.files),
            schema=serde.parse_schema(n.schema) if n.schema.fields else None,
            columns=list(n.columns) or None,
            batch_rows=n.batch_rows or self._file_scan_batch_rows(),
            device=self.ctx.device,
        )

    def _plan_memory_scan(self, n: pb.MemoryScanNode) -> PhysicalOp:
        import pyarrow as pa
        from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow
        from auron_tpu_torch.io.parquet import MemoryScanOp
        if n.table_name not in self.ctx.catalog:
            raise KeyError(
                f"table {n.table_name!r} not in planner catalog "
                f"(known: {sorted(self.ctx.catalog)})")
        table = self.ctx.catalog[n.table_name]
        if isinstance(table, pa.Table):
            partitions = [table.to_batches(
                max_chunksize=n.batch_rows or self.ctx.batch_capacity)]
            schema = schema_from_arrow(table.schema)
        else:  # pre-partitioned: list[list[RecordBatch]]
            partitions = table
            schema = schema_from_arrow(partitions[0][0].schema)
        return MemoryScanOp(partitions, schema,
                            capacity=n.batch_rows or self.ctx.batch_capacity,
                            device=self.ctx.device)

    def _plan_empty_partitions(self, n: pb.EmptyPartitionsNode
                               ) -> PhysicalOp:
        from auron_tpu_torch.ops.limit import EmptyPartitionsOp
        return EmptyPartitionsOp(serde.parse_schema(n.schema),
                                 n.num_partitions)

    # -- row transforms -----------------------------------------------------

    def _plan_filter(self, n: pb.FilterNode) -> PhysicalOp:
        from auron_tpu_torch.ops.project import FilterOp
        return FilterOp(self.create_plan(n.child),
                        [serde.parse_expr(p) for p in n.predicates])

    def _plan_project(self, n: pb.ProjectNode) -> PhysicalOp:
        from auron_tpu_torch.ops.project import ProjectOp
        return ProjectOp(self.create_plan(n.child),
                         [serde.parse_expr(e) for e in n.exprs],
                         list(n.names))

    def _plan_agg(self, n: pb.AggNode) -> PhysicalOp:
        from auron_tpu_torch.ops.agg import AggOp
        child = self.create_plan(n.child)
        group_exprs = [serde.parse_expr(e) for e in n.group_exprs]
        aggs = [serde.parse_agg(a) for a in n.aggs]
        return AggOp(
            child, group_exprs, aggs,
            mode=n.mode or "complete",
            group_names=list(n.group_names) or None,
            agg_names=list(n.agg_names) or None,
            initial_capacity=self.ctx.config.get(cfg.AGG_INITIAL_CAPACITY),
            key_domain=self._agg_key_domain(n, child, group_exprs, aggs),
        )

    def _agg_key_domain(self, n: pb.AggNode, child: PhysicalOp,
                        group_exprs, aggs) -> Optional[int]:
        """Table-stats key-domain bound for the dense grouped-agg path:
        proven, not guessed. A bound is derived only when the single
        group key is a direct ColumnRef reaching a catalog memory table
        through schema-preserving nodes, the key column is integer,
        null-free and non-negative, and every aggregate is exact under
        the dense formulation (count/min/max, and sum/avg over integers;
        float sums are left to the general path, as in the reference).
        The operator re-checks the bound at run time."""
        import pyarrow as pa
        from auron_tpu_torch.columnar.schema import DataType
        from auron_tpu_torch.exprs.eval import infer_dtype
        from auron_tpu_torch.kernels.dispatch import DENSE_VALUE_DTYPES
        conf = self.ctx.config
        try:
            if not conf.get(cfg.KERNELS_ENABLED):
                return None
            if (n.mode or "complete") not in ("partial", "complete"):
                return None
            if len(group_exprs) != 1 or not isinstance(group_exprs[0],
                                                       eir.ColumnRef):
                return None
            schema = child.schema()
            ints = (DataType.INT8, DataType.INT16, DataType.INT32,
                    DataType.INT64)
            for a in aggs:
                if a.distinct and a.fn not in ("min", "max"):
                    return None
                # mirror the runtime dispatch's value-dtype filter, so
                # the stats scan is never paid for a plan that falls back
                if a.arg is not None and \
                        infer_dtype(a.arg, schema)[0] not in \
                        DENSE_VALUE_DTYPES:
                    return None
                if a.fn in ("count", "count_star", "min", "max"):
                    continue
                if a.fn in ("sum", "avg") and a.arg is not None \
                        and infer_dtype(a.arg, schema)[0] in ints:
                    continue
                return None
            # walk to a memory scan through schema-preserving nodes
            node = n.child
            while True:
                kind = node.WhichOneof("node")
                if kind == "filter":
                    node = node.filter.child
                elif kind == "coalesce_batches":
                    node = node.coalesce_batches.child
                elif kind == "memory_scan":
                    break
                else:
                    return None
            table = self.ctx.catalog.get(node.memory_scan.table_name)
            if not isinstance(table, pa.Table):
                return None
            idx = group_exprs[0].index
            if not 0 <= idx < table.num_columns:
                return None
            col = table.column(idx)
            if not pa.types.is_integer(col.type) or col.null_count \
                    or table.num_rows == 0:
                return None
            ckey = (node.memory_scan.table_name, idx)
            cached = self.ctx._col_stats.get(ckey)
            if cached is not None and cached[0] is table:
                stats = cached[1]
            else:
                import pyarrow.compute as pc
                mm = pc.min_max(col)
                stats = (mm["min"].as_py(), mm["max"].as_py())
                self.ctx._col_stats[ckey] = (table, stats)
            lo, hi = stats
            if lo is None or lo < 0:
                return None
            if hi + 1 > conf.get(cfg.KERNELS_MAX_KEY_DOMAIN):
                return None
            return int(hi) + 1
        except Exception:
            # stats derivation is advisory: a failure here never fails
            # planning, since the general path is always correct
            return None

    def _plan_sort(self, n: pb.SortNode) -> PhysicalOp:
        from auron_tpu_torch.ops.sort import SortOp
        # proto3 leaves an unset fetch at 0; a 0-row top-k is
        # meaningless, so any fetch <= 0 means "no limit"
        return SortOp(self.create_plan(n.child),
                      [serde.parse_sort_order(o) for o in n.sort_orders],
                      fetch=None if n.fetch <= 0 else n.fetch)

    def _plan_limit(self, n: pb.LimitNode) -> PhysicalOp:
        from auron_tpu_torch.ops.limit import LimitOp
        return LimitOp(self.create_plan(n.child), n.limit)

    def _plan_union(self, n: pb.UnionNode) -> PhysicalOp:
        from auron_tpu_torch.ops.limit import UnionOp
        return UnionOp([self.create_plan(c) for c in n.children])

    def _plan_coalesce_batches(self, n: pb.CoalesceBatchesNode
                               ) -> PhysicalOp:
        from auron_tpu_torch.ops.limit import CoalesceBatchesOp
        return CoalesceBatchesOp(self.create_plan(n.child), n.target_rows)

    def _plan_rename_columns(self, n: pb.RenameColumnsNode) -> PhysicalOp:
        from auron_tpu_torch.ops.limit import RenameColumnsOp
        return RenameColumnsOp(self.create_plan(n.child), list(n.names))

    def _plan_window(self, n: pb.WindowNode) -> PhysicalOp:
        from auron_tpu_torch.ops.window import WindowFunctionSpec, WindowOp
        fns = []
        for f in n.functions:
            default = None
            if f.HasField("default_value"):
                default = serde._parse_literal(f.default_value).value
            fns.append(WindowFunctionSpec(
                kind=f.kind, fn=f.fn,
                arg=serde.parse_expr(f.arg) if f.HasField("arg") else None,
                offset=f.offset if f.HasField("offset") else 1,
                default=default,
                frame=((f.frame_lo, f.frame_hi)
                       if (f.HasField("frame_lo")
                           or f.HasField("frame_hi")) else None)))
        return WindowOp(
            self.create_plan(n.child),
            partition_by=[serde.parse_expr(e) for e in n.partition_by],
            order_by=[serde.parse_sort_order(o) for o in n.order_by],
            functions=fns,
            output_names=list(n.output_names) or None,
            group_limit=None if n.group_limit < 0 else (n.group_limit or None),
        )

    def _plan_expand(self, n: pb.ExpandNode) -> PhysicalOp:
        from auron_tpu_torch.ops.expand import ExpandOp
        return ExpandOp(
            self.create_plan(n.child),
            [[serde.parse_expr(e) for e in proj.exprs]
             for proj in n.projections],
            list(n.names) or None,
        )

    # -- joins --------------------------------------------------------------

    def _plan_hash_join(self, n: pb.HashJoinNode) -> PhysicalOp:
        from auron_tpu_torch.ops.joins import HashJoinOp
        return HashJoinOp(
            self.create_plan(n.probe), self.create_plan(n.build),
            [serde.parse_expr(e) for e in n.probe_keys],
            [serde.parse_expr(e) for e in n.build_keys],
            join_type=n.join_type or "inner")

    def _plan_sort_merge_join(self, n: pb.SortMergeJoinNode) -> PhysicalOp:
        raise NotImplementedError(
            "plan node 'sort_merge_join': SortMergeJoinOp comes with ROADMAP "
            "item 16f")

    def _plan_broadcast_join(self, n: pb.BroadcastJoinNode) -> PhysicalOp:
        raise NotImplementedError(
            "plan node 'broadcast_join': its build side is a planner "
            "resource, and the resource map comes with ROADMAP item 20")

    # -- exchange -----------------------------------------------------------

    def _plan_broadcast_exchange(self, n: pb.BroadcastExchangeNode
                                 ) -> PhysicalOp:
        from auron_tpu_torch.parallel.exchange import BroadcastExchangeOp
        if n.output_resource_id:
            raise NotImplementedError(
                "broadcast_exchange with an output_resource_id: the "
                "planner's resource map comes with ROADMAP item 20")
        return BroadcastExchangeOp(self.create_plan(n.child),
                                   input_partitions=n.input_partitions or 1)

    def _parse_partitioning(self, p: pb.PartitioningP):
        from auron_tpu_torch.parallel.partitioning import (
            HashPartitioning, RangePartitioning, RoundRobinPartitioning,
            SinglePartitioning)
        if p.kind == "hash":
            return HashPartitioning(
                tuple(serde.parse_expr(e) for e in p.hash_keys),
                p.num_partitions)
        if p.kind == "round_robin":
            return RoundRobinPartitioning(p.num_partitions)
        if p.kind == "single":
            return SinglePartitioning()
        if p.kind == "range":
            # bounds are sampled at execution time by the exchange
            return RangePartitioning(
                tuple(serde.parse_sort_order(o) for o in p.range_orders),
                p.num_partitions, bounds=())
        raise NotImplementedError(f"partitioning {p.kind!r}")

    def _plan_shuffle_writer(self, n: pb.ShuffleWriterNode) -> PhysicalOp:
        from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp
        if n.rss_root:
            raise NotImplementedError("shuffle writer to an RSS root")
        return ShuffleExchangeOp(self.create_plan(n.child),
                                 self._parse_partitioning(n.partitioning),
                                 input_partitions=n.input_partitions or 1)


def plan_from_bytes(data: bytes,
                    ctx: Optional[PlannerContext] = None) -> PhysicalOp:
    """Decode a serialized TaskDefinition and build its plan."""
    return PhysicalPlanner(ctx).plan_task(pb.TaskDefinition.FromString(data))


def _collect_subqueries(msg) -> list:
    """Every ScalarSubqueryE reachable from ``msg`` (any proto message),
    outermost occurrences only: a subquery's own plan is scanned again
    when it is planned."""
    found = []
    for fd, val in msg.ListFields():
        if fd.type != fd.TYPE_MESSAGE:
            continue
        for v in (val if fd.is_repeated else [val]):
            if isinstance(v, pb.ExprNode) \
                    and v.WhichOneof("expr") == "scalar_subquery":
                found.append(v.scalar_subquery)
            elif not isinstance(v, pb.ScalarSubqueryE):
                found.extend(_collect_subqueries(v))
    return found


def subquery_key(q) -> bytes:
    """Resolution key of a ScalarSubqueryE: its plan and result type
    without the ``sid``, so that two equal subqueries built separately
    share one resolution."""
    k = pb.ScalarSubqueryE()
    k.CopyFrom(q)
    k.sid = 0
    return k.SerializeToString()


def substitute_subqueries(node: pb.PlanNode,
                          values: dict[bytes, pb.ExprNode]) -> pb.PlanNode:
    """A copy of ``node`` with every scalar_subquery ExprNode replaced by
    the literal ExprNode ``values`` holds under its ``subquery_key``."""
    out = pb.PlanNode()
    out.CopyFrom(node)

    def walk(msg):
        for fd, val in msg.ListFields():
            if fd.type != fd.TYPE_MESSAGE:
                continue
            for v in (val if fd.is_repeated else [val]):
                if isinstance(v, pb.ExprNode) \
                        and v.WhichOneof("expr") == "scalar_subquery":
                    v.CopyFrom(values[subquery_key(v.scalar_subquery)])
                else:
                    walk(v)

    walk(out)
    return out


# ---------------------------------------------------------------------------
# whole-stage fusion pass
# ---------------------------------------------------------------------------

#: bound on the product of the fan-outs (an expand's projections
#: multiply the batches of one input batch) that one fused stage unrolls
_MAX_STAGE_FANOUT = 16


def fuse_stages(op: PhysicalOp, config=None) -> PhysicalOp:
    """Whole-stage fusion (ops/fused.py): greedily group maximal chains
    of fusable row-local operators into FusedStageOp nodes, and push the
    key/value projection of partial/complete aggregations below the agg
    so its expression evaluation joins the chain. Stage breakers (agg,
    sort, exchange, scans) have no fragment, so a chain cannot cross
    them.
    Gated on ``auron.fusion.enabled``; chain length is bounded by
    ``auron.fusion.max_stage_ops``. The projection normalization runs
    under both settings, so the two give the same plan below the aggs."""
    conf = config if config is not None else cfg.get_config()
    op = _normalize(op)
    if not conf.get(cfg.FUSION_ENABLED):
        return op
    op = _fuse(op, max(2, conf.get(cfg.FUSION_MAX_STAGE_OPS)))
    _wrap_combine_children(op)
    return op


def _combine_foldable(exchange, agg) -> bool:
    """The reference folds ``agg`` into ``exchange``'s split program: the
    agg can combine map-side and the exchange partitions on its group-key
    refs (or sends everything to one partition)."""
    from auron_tpu_torch.parallel.partitioning import (HashPartitioning,
                                                       SinglePartitioning)
    if agg.combine_fold_reason() is not None:
        return False
    part = exchange.partitioning
    if isinstance(part, SinglePartitioning):
        return True
    return isinstance(part, HashPartitioning) and all(
        isinstance(e, eir.ColumnRef) and e.index < len(agg.group_exprs)
        for e in part.exprs)


def _wrap_combine_children(op: PhysicalOp) -> None:
    """Wrap the lone computing child of each partial agg under an
    exchange where the reference folds a map-side combine."""
    from auron_tpu_torch.ops.agg import AggOp
    from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp
    if isinstance(op, ShuffleExchangeOp) and isinstance(op.child, AggOp) \
            and _combine_foldable(op, op.child):
        op.child.child = _wrap_single(op.child.child)
    for c in op.children:
        _wrap_combine_children(c)


def _normalize(op: PhysicalOp) -> PhysicalOp:
    op = _elide_agg_child_projection(op)
    op = _push_agg_projection(op)
    _replace_children(op, _normalize)
    return op


def _wrap_single(child: PhysicalOp) -> PhysicalOp:
    """Wrap a lone computing fusable op under an exchange or as a hash
    join's probe in a stage of its own, as the reference does for its
    split and probe programs. Pass-through ops (limit/rename) stay
    bare."""
    from auron_tpu_torch.ops.fused import FusedStageOp
    if child.fusable and child.fragment_computes \
            and not isinstance(child, FusedStageOp):
        return FusedStageOp([child])
    return child


def _fuse(op: PhysicalOp, max_ops: int) -> PhysicalOp:
    from auron_tpu_torch.ops.fused import FusedStageOp
    from auron_tpu_torch.ops.joins import HashJoinOp
    from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp
    if isinstance(op, (ShuffleExchangeOp, HashJoinOp)):
        _replace_children(op, lambda c: _fuse(c, max_ops))
        if isinstance(op, ShuffleExchangeOp):
            op.child = _wrap_single(op.child)
        else:
            op.probe = _wrap_single(op.probe)
        return op
    if op.fusable:
        # the maximal chain op → … → deepest fusable descendant, whose
        # product of fan-outs stays within _MAX_STAGE_FANOUT
        chain = [op]
        fanout = op.fusion_fanout
        while len(chain) < max_ops:
            child = chain[-1].children[0]
            if not child.fusable \
                    or fanout * child.fusion_fanout > _MAX_STAGE_FANOUT:
                break
            chain.append(child)
            fanout *= child.fusion_fanout
        # recurse below the stage input, keeping the member links intact
        _replace_children(chain[-1], lambda c: _fuse(c, max_ops))
        if len(chain) >= 2 and any(m.fragment_computes for m in chain):
            # a chain of pure pass-throughs (limit → rename) stays as is
            return FusedStageOp(list(reversed(chain)))
        return op
    _replace_children(op, lambda c: _fuse(c, max_ops))
    return op


def _replace_children(op: PhysicalOp, fn) -> None:
    """Apply ``fn`` to every direct child and swap the rewritten ops back
    into the parent's attributes (operators hold children as plain
    attributes: ``child``, ``inputs`` lists)."""
    for name, val in list(vars(op).items()):
        if isinstance(val, PhysicalOp):
            setattr(op, name, fn(val))
        elif isinstance(val, list) and val \
                and all(isinstance(v, PhysicalOp) for v in val):
            setattr(op, name, [fn(v) for v in val])


def _elide_agg_child_projection(op: PhysicalOp) -> PhysicalOp:
    """Drop a pure column-pick ProjectOp feeding a partial/complete
    aggregation: when the agg's group/arg expressions are plain
    ColumnRefs into a projection whose referenced outputs are plain
    ColumnRefs themselves, the refs are remapped to the projection's
    input. Values are untouched."""
    from auron_tpu_torch.ops.agg import AggOp
    from auron_tpu_torch.ops.project import ProjectOp
    if not isinstance(op, AggOp) or op.mode not in ("partial", "complete"):
        return op
    child = op.children[0]
    if not isinstance(child, ProjectOp):
        return op
    used = list(op.group_exprs) + [a.arg for a in op.aggs
                                   if a.arg is not None]
    if not used or not all(isinstance(e, eir.ColumnRef) for e in used):
        return op
    refs = {e.index for e in used}
    if not all(0 <= i < len(child.exprs)
               and isinstance(child.exprs[i], eir.ColumnRef)
               for i in refs):
        return op
    remap = {i: child.exprs[i].index for i in refs}
    new_groups = [eir.ColumnRef(remap[e.index]) for e in op.group_exprs]
    new_aggs = [a if a.arg is None
                else replace(a, arg=eir.ColumnRef(remap[a.arg.index]))
                for a in op.aggs]
    rewritten = AggOp(child.children[0], new_groups, new_aggs, mode=op.mode,
                      group_names=op.group_names, agg_names=op.agg_names,
                      initial_capacity=op.initial_capacity,
                      key_domain=op.key_domain)
    if rewritten.schema() != op.schema():
        return op
    # the child's child may itself be a pure projection: elide again
    return _elide_agg_child_projection(rewritten)


def _push_agg_projection(op: PhysicalOp) -> PhysicalOp:
    """Pre-agg key/value projection: rewrite AggOp(group_exprs, aggs)
    over arbitrary expressions into AggOp(ColumnRefs) over a ProjectOp
    evaluating those expressions, so the projection fuses with the
    chain below the agg. Only for partial/complete aggregations over a
    fusable child; the rewrite is expression for expression."""
    from auron_tpu_torch.ops.agg import AggOp
    from auron_tpu_torch.ops.project import ProjectOp
    if not isinstance(op, AggOp) or op.mode not in ("partial", "complete"):
        return op
    if not op.children[0].fusable:
        # nothing below to fuse the projection into
        return op
    used = list(op.group_exprs) + [a.arg for a in op.aggs
                                   if a.arg is not None]
    if not used or all(isinstance(e, eir.ColumnRef) for e in used):
        return op   # nothing to push down

    proj_exprs: list = []
    index_of: dict = {}

    def col(e):
        if e not in index_of:
            index_of[e] = len(proj_exprs)
            proj_exprs.append(e)
        return eir.ColumnRef(index_of[e])

    new_groups = [col(e) for e in op.group_exprs]
    new_aggs = [a if a.arg is None else replace(a, arg=col(a.arg))
                for a in op.aggs]
    proj = ProjectOp(op.children[0], proj_exprs,
                     [f"_pre{i}" for i in range(len(proj_exprs))])
    rewritten = AggOp(proj, new_groups, new_aggs, mode=op.mode,
                      group_names=op.group_names, agg_names=op.agg_names,
                      initial_capacity=op.initial_capacity,
                      key_domain=op.key_domain)
    if rewritten.schema() != op.schema():
        return op
    return rewritten
