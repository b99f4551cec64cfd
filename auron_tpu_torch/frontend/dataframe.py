"""DataFrame DSL → protobuf plan builder.

The port of ``auron_tpu.frontend.dataframe`` for the expressions and
transforms the port can run. Unresolved column names resolve against
the child's schema when a transform is built. A DataFrame serializes to
the same ``TaskDefinition`` bytes as the reference's for the same
query; what the port cannot plan yet (DISTINCT aggregates, host
functions, the scalar functions of ROADMAP items 16f and 17b) raises
``NotImplementedError`` or is absent. Uncorrelated scalar subqueries
(``scalar_subquery``) resolve once per task in ``ops/subquery.py``'s
binder. Window functions
(``DataFrame.window`` with the builders on ``functions``) and grouping
sets (``expand``, ``grouping_sets``, ``rollup``, ``cube``) build the
reference's nodes.

Each DataFrame carries the reference's ``partitioning`` provenance, the
layout its partitions are known to have. It never enters the task
bytes, but ``join`` reads it to choose between a co-partitioned hash
join and a broadcast build side, so it follows the reference's through
every transform.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, replace
from typing import Any, Callable, Optional, Sequence, Union

from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import infer_dtype
from auron_tpu_torch.ir import auron_pb2 as pb
from auron_tpu_torch.ir import serde

# ---------------------------------------------------------------------------
# column expressions (unresolved)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Col:
    """Unresolved expression + optional alias."""

    node: Any             # column name | ir.Expr | tagged tuple of Cols
    name: Optional[str] = None

    def _bin(self, op, other) -> "Col":
        return Col(("bin", op, self, _wrap(other)))

    def __add__(self, o): return self._bin("+", o)
    def __radd__(self, o): return _wrap(o)._bin("+", self)
    def __sub__(self, o): return self._bin("-", o)
    def __rsub__(self, o): return _wrap(o)._bin("-", self)
    def __mul__(self, o): return self._bin("*", o)
    def __rmul__(self, o): return _wrap(o)._bin("*", self)
    def __truediv__(self, o): return self._bin("/", o)
    def __mod__(self, o): return self._bin("%", o)
    def __eq__(self, o): return self._bin("==", o)      # type: ignore
    def __ne__(self, o): return self._bin("!=", o)      # type: ignore
    def __lt__(self, o): return self._bin("<", o)
    def __le__(self, o): return self._bin("<=", o)
    def __gt__(self, o): return self._bin(">", o)
    def __ge__(self, o): return self._bin(">=", o)
    def __and__(self, o): return self._bin("and", o)
    def __or__(self, o): return self._bin("or", o)
    def __invert__(self): return Col(("not", self))

    def __hash__(self):
        return id(self)

    def alias(self, name: str) -> "Col":
        return Col(self.node, name)

    def cast(self, dtype: DataType, precision: int = 0,
             scale: int = 0) -> "Col":
        return Col(("cast", self, dtype, precision, scale), self.name)

    def is_null(self) -> "Col":
        return Col(("is_null", self))

    def is_not_null(self) -> "Col":
        return Col(("is_not_null", self))

    def isin(self, *values) -> "Col":
        vals = values[0] if len(values) == 1 and isinstance(
            values[0], (list, tuple)) else values
        return Col(("in", self, tuple(vals)))

    def like(self, pattern: str) -> "Col":
        return Col(("like", self, pattern))

    def startswith(self, prefix: str) -> "Col":
        return Col(("startswith", self, prefix))

    def endswith(self, suffix: str) -> "Col":
        return Col(("endswith", self, suffix))

    def contains(self, infix: str) -> "Col":
        return Col(("contains", self, infix))

    def getitem(self, ordinal: int) -> "Col":
        return Col(("index", self, ordinal))

    def asc(self, nulls_first: bool = True) -> "SortCol":
        return SortCol(self, True, nulls_first)

    def desc(self, nulls_first: bool = False) -> "SortCol":
        return SortCol(self, False, nulls_first)

    def out_name(self, default: str = "col") -> str:
        if self.name:
            return self.name
        if isinstance(self.node, str):
            return self.node
        return default


@dataclass(frozen=True)
class SortCol:
    col: Col
    ascending: bool = True
    nulls_first: bool = True


@dataclass(frozen=True)
class AggCol:
    fn: str
    arg: Optional[Col]
    name: Optional[str] = None
    distinct: bool = False

    def alias(self, name: str) -> "AggCol":
        return AggCol(self.fn, self.arg, name, self.distinct)

    def out_name(self, i: int) -> str:
        if self.name:
            return self.name
        argname = self.arg.out_name() if self.arg is not None else ""
        return f"{self.fn}({argname})" if argname else self.fn


@dataclass
class WinFn:
    """One window function for ``DataFrame.window``: the DSL's face of
    ``WindowFunctionP`` and ``ops.window.WindowFunctionSpec``."""

    kind: str                   # rank_like | offset | agg
    fn: str
    arg: Optional[Col] = None
    offset: int = 1
    default: Any = None
    name: Optional[str] = None
    #: ROWS BETWEEN (lo, hi) for agg functions; None = the default frame
    frame: Optional[tuple] = None

    def alias(self, name: str) -> "WinFn":
        return replace(self, name=name)

    def out_name(self, i: int) -> str:
        return self.name or f"{self.fn}_{i}"


def col(name: str) -> Col:
    return Col(name)


def lit(value, dtype: Optional[DataType] = None) -> Col:
    return Col(("lit", value, dtype))


def _wrap(v) -> Col:
    return v if isinstance(v, Col) else lit(v)


def _py_dtype(v) -> DataType:
    if isinstance(v, bool):
        return DataType.BOOL
    if isinstance(v, int):
        return DataType.INT64
    if isinstance(v, float):
        return DataType.FLOAT64
    if isinstance(v, str):
        return DataType.STRING
    raise TypeError(f"cannot infer literal type for {type(v).__name__}")


_UNARY = {"not": ir.Not, "is_null": ir.IsNull, "is_not_null": ir.IsNotNull}
_STRING_PRED = {"like": ir.Like, "startswith": ir.StringStartsWith,
                "endswith": ir.StringEndsWith, "contains": ir.StringContains}


def resolve(c: Col, schema: Schema) -> ir.Expr:
    """Resolve a Col tree to a bound ir.Expr against ``schema``."""
    n = c.node
    if isinstance(n, str):
        return ir.ColumnRef(schema.index_of(n), n)
    if isinstance(n, ir.Expr):
        return n
    tag = n[0]
    if tag == "lit":
        _, value, dtype = n
        if value is None:
            return ir.Literal(None, dtype or DataType.NULL)
        return ir.Literal(value, dtype or _py_dtype(value))
    if tag == "bin":
        _, op, left, right = n
        return ir.BinaryExpr(op, resolve(left, schema), resolve(right, schema))
    if tag in _UNARY:
        return _UNARY[tag](resolve(n[1], schema))
    if tag == "cast":
        _, child, dtype, p, s = n
        return ir.Cast(resolve(child, schema), dtype, p, s)
    if tag == "in":
        return ir.InList(resolve(n[1], schema), tuple(n[2]))
    if tag in _STRING_PRED:
        return _STRING_PRED[tag](resolve(n[1], schema), n[2])
    if tag == "index":
        return ir.GetIndexedField(resolve(n[1], schema), n[2])
    if tag == "fn":
        _, fname, args = n
        return ir.ScalarFunction(
            fname, tuple(resolve(a, schema) for a in args))
    if tag == "subquery":
        _, plan_bytes, dtype, p, s, sid = n
        return ir.ScalarSubquery(plan_bytes, dtype, p, s, sid)
    raise NotImplementedError(f"cannot resolve column node {tag!r}")


_SUBQUERY_IDS = iter(range(1, 1 << 30))


def scalar_subquery(df) -> Col:
    """An uncorrelated scalar subquery over a one-column DataFrame: its
    plan runs once per task and its one value becomes a literal (Spark's
    ScalarSubquery; 0 rows give NULL, more than one row raises).
    Correlated subqueries are written as joins, as Spark's optimizer
    rewrites them before the physical plan exists."""
    if len(df.schema) != 1:
        raise ValueError(
            f"scalar subquery must produce exactly one column, got "
            f"{[f.name for f in df.schema]}")
    f = df.schema[0]
    return Col(("subquery", df.plan.SerializeToString(), f.dtype,
                f.precision, f.scale, next(_SUBQUERY_IDS)))


class _Functions:
    """``functions.upper(col)`` / ``functions.sum(col)`` / ...: scalar
    function and aggregate builders. A name that is not an aggregate
    builds a ``ScalarFunction`` of that name, a trailing ``_`` stripped
    (``if_`` → ``if``); the planner raises for a name the port does not
    register."""

    _AGGS = {"sum", "count", "avg", "min", "max", "first",
             "first_ignores_null", "collect_list", "collect_set"}

    def __getattr__(self, name: str) -> Callable[..., Any]:
        fname = name.rstrip("_")
        if fname in self._AGGS:
            def agg_builder(c: Optional[Col] = None, distinct=False):
                return AggCol(fname, _wrap(c) if c is not None else None,
                              distinct=distinct)
            return agg_builder

        def builder(*args):
            return Col(("fn", fname, tuple(_wrap(a) for a in args)))
        return builder

    def count_star(self) -> AggCol:
        return AggCol("count_star", None)

    # -- window functions (DataFrame.window) --------------------------------

    def row_number(self) -> WinFn:
        return WinFn("rank_like", "row_number")

    def rank(self) -> WinFn:
        return WinFn("rank_like", "rank")

    def dense_rank(self) -> WinFn:
        return WinFn("rank_like", "dense_rank")

    def percent_rank(self) -> WinFn:
        return WinFn("rank_like", "percent_rank")

    def cume_dist(self) -> WinFn:
        return WinFn("rank_like", "cume_dist")

    def ntile(self, n: int) -> WinFn:
        return WinFn("rank_like", "ntile", offset=n)

    def lead(self, c, offset: int = 1, default=None) -> WinFn:
        return WinFn("offset", "lead", _wrap(c), offset, default)

    def lag(self, c, offset: int = 1, default=None) -> WinFn:
        return WinFn("offset", "lag", _wrap(c), offset, default)

    def nth_value(self, c, n: int) -> WinFn:
        return WinFn("offset", "nth_value", _wrap(c), n)

    def first_value(self, c) -> WinFn:
        return WinFn("offset", "first_value", _wrap(c))

    def last_value(self, c) -> WinFn:
        return WinFn("offset", "last_value", _wrap(c))

    def win_agg(self, fn: str, c=None, frame=None) -> WinFn:
        """An aggregate over the window: ``win_agg("sum", col)``,
        ``win_agg("count_star")``. The default frame is Spark's
        (UNBOUNDED PRECEDING..CURRENT ROW with ORDER BY, else the whole
        partition); ``frame=(lo, hi)`` is ROWS BETWEEN lo..hi in
        relative rows, negative preceding: ``(-1, 1)`` is a centred
        moving window."""
        return WinFn("agg", fn, _wrap(c) if c is not None else None,
                     frame=tuple(frame) if frame is not None else None)


functions = _Functions()


# ---------------------------------------------------------------------------
# DataFrame
# ---------------------------------------------------------------------------

class GroupedData:
    def __init__(self, df: "DataFrame", keys: Sequence[Col]):
        self.df = df
        self.keys = [_wrap(k) for k in keys]

    def agg(self, *aggs: AggCol) -> "DataFrame":
        """The reference's plan: over several partitions a partial agg on
        every map partition → exchange (hash on the keys; single for a
        global agg) → final agg; over one partition a complete agg."""
        from auron_tpu_torch.ops.agg import make_acc_spec
        distinct = [a.fn for a in aggs if a.distinct]
        if distinct:
            raise NotImplementedError(
                f"DISTINCT aggregates ({', '.join(distinct)}): their "
                "collect_set state needs the list columns of ROADMAP item "
                "16f-c")
        schema = self.df.schema
        group_exprs = [resolve(k, schema) for k in self.keys]
        group_names = [k.out_name(f"k{i}") for i, k in enumerate(self.keys)]
        agg_fns = [ir.AggFunction(
            a.fn, resolve(a.arg, schema) if a.arg is not None else None)
            for a in aggs]
        agg_names = [a.out_name(i) for i, a in enumerate(aggs)]
        n_keys = len(group_exprs)
        n_part = self.df.num_partitions

        out_partitions = n_part
        out_prov = self.df.partitioning
        if n_part > 1:
            partial = pb.PlanNode(agg=pb.AggNode(
                child=self.df.plan,
                group_exprs=[serde.expr_to_proto(e) for e in group_exprs],
                aggs=[serde.agg_to_proto(a) for a in agg_fns],
                mode="partial", group_names=group_names,
                agg_names=agg_names))
            if n_keys > 0:
                part = pb.PartitioningP(
                    kind="hash", num_partitions=n_part,
                    hash_keys=[serde.expr_to_proto(ir.ColumnRef(i))
                               for i in range(n_keys)])
                out_prov = ("hash", tuple(group_names), n_part)
            else:
                part = pb.PartitioningP(kind="single", num_partitions=1)
                out_partitions = 1
                out_prov = ("single",)
            shuffle = pb.PlanNode(shuffle_writer=pb.ShuffleWriterNode(
                child=partial, partitioning=part, input_partitions=n_part))
            node = pb.PlanNode(agg=pb.AggNode(
                child=shuffle,
                group_exprs=[serde.expr_to_proto(ir.ColumnRef(i))
                             for i in range(n_keys)],
                aggs=[serde.agg_to_proto(ir.AggFunction(a.fn))
                      for a in agg_fns],
                mode="final", group_names=group_names,
                agg_names=agg_names))
        else:
            node = pb.PlanNode(agg=pb.AggNode(
                child=self.df.plan,
                group_exprs=[serde.expr_to_proto(e) for e in group_exprs],
                aggs=[serde.agg_to_proto(a) for a in agg_fns],
                mode="complete", group_names=group_names,
                agg_names=agg_names))

        fields = []
        for e, nm in zip(group_exprs, group_names):
            dt, p, s = infer_dtype(e, schema)
            fields.append(Field(nm, dt, True, p, s))
        for a, nm in zip(agg_fns, agg_names):
            dt, p, s = make_acc_spec(a, schema, "complete").result
            fields.append(Field(nm, dt, True, p, s))
        return DataFrame(self.df.session, node, Schema(tuple(fields)),
                         out_partitions, out_prov)


class DataFrame:
    def __init__(self, session, plan: pb.PlanNode, schema: Schema,
                 num_partitions: int = 1, partitioning=None):
        self.session = session
        self.plan = plan
        self.schema = schema
        self.num_partitions = num_partitions
        #: output-partitioning provenance: ("hash", (key names...), n)
        #: after a hash exchange on those keys, ("single",) after a
        #: coalescing one, else None (layout unknown)
        self.partitioning = partitioning

    # -- transforms ---------------------------------------------------------

    def filter(self, cond: Col) -> "DataFrame":
        e = resolve(cond, self.schema)
        node = pb.PlanNode(filter=pb.FilterNode(
            child=self.plan, predicates=[serde.expr_to_proto(e)]))
        # row-preserving: the partition layout survives a filter
        return DataFrame(self.session, node, self.schema,
                         self.num_partitions, self.partitioning)

    def _project_provenance(self, exprs, names):
        """Hash provenance survives a projection when every key column
        passes through as a column reference; a renamed key carries its
        new name."""
        prov = self.partitioning
        if not prov or prov[0] != "hash":
            return None
        renames = {}
        for e, nm in zip(exprs, names):
            if isinstance(e, ir.ColumnRef):
                renames.setdefault(self.schema[e.index].name, nm)
        try:
            return ("hash", tuple(renames[k] for k in prov[1]), prov[2])
        except KeyError:
            return None

    def select(self, *cols: Union[str, Col]) -> "DataFrame":
        cs = [col(c) if isinstance(c, str) else c for c in cols]
        exprs = [resolve(c, self.schema) for c in cs]
        names = [c.out_name(f"c{i}") for i, c in enumerate(cs)]
        node = pb.PlanNode(project=pb.ProjectNode(
            child=self.plan, exprs=[serde.expr_to_proto(e) for e in exprs],
            names=names))
        fields = []
        for e, nm in zip(exprs, names):
            dt, p, s = infer_dtype(e, self.schema)
            fields.append(Field(nm, dt, True, p, s))
        return DataFrame(self.session, node, Schema(tuple(fields)),
                         self.num_partitions,
                         self._project_provenance(exprs, names))

    def with_column(self, name: str, c: Col) -> "DataFrame":
        existing = [col(f.name) for f in self.schema]
        return self.select(*existing, c.alias(name))

    def expand(self, projections: Sequence[Sequence[Col]],
               names: Sequence[str]) -> "DataFrame":
        """Emit every projection once per input row (Spark's ExpandExec,
        which rollup, cube and grouping sets lower to). The first
        projection types the output, so the most-typed one goes first."""
        schema = self.schema
        projs = [[resolve(_wrap(c), schema) for c in p]
                 for p in projections]
        node = pb.PlanNode(expand=pb.ExpandNode(
            child=self.plan,
            projections=[pb.ExpandNode.Projection(
                exprs=[serde.expr_to_proto(e) for e in p])
                for p in projs],
            names=list(names)))
        fields = []
        for e, nm in zip(projs[0], names):
            dt, p, s = infer_dtype(e, schema)
            fields.append(Field(nm, dt, True, p, s))
        return DataFrame(self.session, node, Schema(tuple(fields)),
                         self.num_partitions, None)

    def grouping_sets(self, keys: Sequence[Union[str, Col]],
                      sets: Sequence[Sequence[int]]) -> GroupedData:
        """GROUP BY GROUPING SETS: one copy of the input per set, its
        grouped-out keys null, tagged with ``spark_grouping_id`` (INT32;
        bit i set = key i rolled up, the leftmost key the highest bit,
        Spark's encoding). The id is a group key too, so a natural null
        key stays apart from a rolled-up one."""
        kcols = [col(k) if isinstance(k, str) else k for k in keys]
        schema = self.schema
        key_names = [k.out_name(f"k{i}") for i, k in enumerate(kcols)]
        n = len(kcols)
        pass_names = list(schema.names)
        out_names = pass_names + [f"{kn}#g" for kn in key_names] \
            + ["spark_grouping_id"]
        null_keys = []
        for k in kcols:
            dt, p, s = infer_dtype(resolve(k, schema), schema)
            null_keys.append(Col(ir.Literal(None, dt, p, s)))
        projections = []
        for st in sets:
            inc = set(st)
            gid = sum(1 << (n - 1 - i) for i in range(n) if i not in inc)
            projections.append(
                [col(c) for c in pass_names]
                + [kcols[i] if i in inc else null_keys[i]
                   for i in range(n)]
                + [lit(gid, DataType.INT32)])
        # the full set goes first: it types the expanded columns
        projections.sort(key=lambda p: sum(
            1 for c in p if isinstance(c.node, ir.Literal)
            and c.node.value is None))
        expanded = self.expand(projections, out_names)
        gkeys = [col(f"{kn}#g").alias(kn) for kn in key_names] \
            + [col("spark_grouping_id")]
        return GroupedData(expanded, gkeys)

    def rollup(self, *keys: Union[str, Col]) -> GroupedData:
        """GROUP BY ROLLUP(k1..kn): the n + 1 prefix grouping sets."""
        n = len(keys)
        return self.grouping_sets(
            keys, [list(range(i)) for i in range(n, -1, -1)])

    def cube(self, *keys: Union[str, Col]) -> GroupedData:
        """GROUP BY CUBE(k1..kn): all 2^n grouping sets."""
        n = len(keys)
        sets = []
        for r in range(n, -1, -1):
            sets.extend(list(c) for c in itertools.combinations(range(n), r))
        return self.grouping_sets(keys, sets)

    def group_by(self, *keys: Union[str, Col]) -> GroupedData:
        return GroupedData(self, [col(k) if isinstance(k, str) else k
                                  for k in keys])

    def _to_sort_orders(self, orders) -> list[ir.SortOrder]:
        """str/Col/SortCol → resolved ir.SortOrder (shared by sort and
        window); a bare column sorts ascending, nulls first."""
        sos = []
        for o in orders:
            if isinstance(o, str):
                o = col(o).asc()
            elif isinstance(o, Col):
                o = o.asc()
            sos.append(ir.SortOrder(resolve(o.col, self.schema),
                                    o.ascending, o.nulls_first))
        return sos

    def window(self, funcs: list, partition_by=(), order_by=(),
               group_limit: Optional[int] = None) -> "DataFrame":
        """Append one column per window function (WindowNode →
        ``ops/window.py``). Over several partitions the input is first
        hash-exchanged on the partition keys (Spark's required
        distribution for a window); with no partition keys it goes to a
        single partition."""
        from auron_tpu_torch.ops.window import (WindowFunctionSpec,
                                                _result_field)
        if group_limit is not None and group_limit < 1:
            raise ValueError(f"group_limit must be >= 1, got {group_limit}")
        pbs = [col(k) if isinstance(k, str) else k for k in partition_by]
        sos = self._to_sort_orders(order_by)
        pb_exprs = [resolve(c, self.schema) for c in pbs]
        child = self.plan
        out_partitions = self.num_partitions
        prov = None
        if self.num_partitions > 1:
            if pb_exprs:
                part = pb.PartitioningP(
                    kind="hash", num_partitions=self.num_partitions,
                    hash_keys=[serde.expr_to_proto(e) for e in pb_exprs])
                prov = ("hash", tuple(c.out_name() for c in pbs),
                        self.num_partitions)
            else:
                part = pb.PartitioningP(kind="single", num_partitions=1)
                out_partitions = 1
                prov = ("single",)
            child = pb.PlanNode(shuffle_writer=pb.ShuffleWriterNode(
                child=child, partitioning=part,
                input_partitions=self.num_partitions))
        # one spec per function: its validation runs before the protos
        # and the schema are built from it
        names = [f.out_name(i) for i, f in enumerate(funcs)]
        specs = []
        for f in funcs:
            default = None
            if f.default is not None:
                default = resolve(_wrap(f.default), self.schema)
                if not isinstance(default, ir.Literal):
                    raise TypeError(
                        f"{f.fn} default must be a literal, got "
                        f"{type(default).__name__}")
            specs.append((WindowFunctionSpec(
                kind=f.kind, fn=f.fn,
                arg=resolve(f.arg, self.schema) if f.arg is not None
                else None, offset=f.offset,
                default=None if default is None else default.value,
                frame=f.frame), default))
        fprotos = []
        for spec, default in specs:
            wp = pb.WindowFunctionP(kind=spec.kind, fn=spec.fn)
            if spec.arg is not None:
                wp.arg.CopyFrom(serde.expr_to_proto(spec.arg))
            wp.offset = spec.offset
            if default is not None:
                wp.default_value.CopyFrom(
                    serde.expr_to_proto(default).literal)
            if spec.frame is not None:
                wp.frame_lo, wp.frame_hi = spec.frame
            fprotos.append(wp)
        node = pb.PlanNode(window=pb.WindowNode(
            child=child,
            partition_by=[serde.expr_to_proto(e) for e in pb_exprs],
            order_by=[serde.sort_order_to_proto(s) for s in sos],
            functions=fprotos, output_names=names,
            group_limit=-1 if group_limit is None else group_limit))
        extra = [_result_field(spec, nm, self.schema)
                 for (spec, _d), nm in zip(specs, names)]
        out_schema = Schema(tuple(self.schema.fields) + tuple(extra))
        return DataFrame(self.session, node, out_schema, out_partitions,
                         prov)

    def sort(self, *orders: Union[str, Col, SortCol],
             limit: Optional[int] = None) -> "DataFrame":
        """A global sort, or its first ``limit`` rows. Over several
        partitions a top-k runs a map-side SortNode(fetch=limit) on every
        partition, so only n_part * limit rows cross the single-partition
        exchange, then the final top-k; a full sort range-exchanges first,
        so the partitions' sorted runs concatenate in global order."""
        so_protos = [serde.sort_order_to_proto(s)
                     for s in self._to_sort_orders(orders)]
        child = self.plan
        out_partitions = self.num_partitions
        prov = None
        if self.num_partitions > 1:
            if limit is not None:
                child = pb.PlanNode(sort=pb.SortNode(
                    child=child, sort_orders=so_protos, fetch=limit))
                part = pb.PartitioningP(kind="single", num_partitions=1)
                out_partitions = 1
                prov = ("single",)
            else:
                part = pb.PartitioningP(kind="range",
                                        num_partitions=self.num_partitions,
                                        range_orders=so_protos)
            child = pb.PlanNode(shuffle_writer=pb.ShuffleWriterNode(
                child=child, partitioning=part,
                input_partitions=self.num_partitions))
        node = pb.PlanNode(sort=pb.SortNode(
            child=child, sort_orders=so_protos,
            fetch=-1 if limit is None else limit))
        return DataFrame(self.session, node, self.schema, out_partitions,
                         prov)

    order_by = sort

    def limit(self, n: int) -> "DataFrame":
        child = self.plan
        out_partitions = self.num_partitions
        prov = self.partitioning
        if self.num_partitions > 1:
            # LIMIT is global: a map-side limit caps each partition at n
            # rows, a coalescing exchange gathers them, and the global
            # limit truncates
            child = pb.PlanNode(limit=pb.LimitNode(child=child, limit=n))
            child = pb.PlanNode(shuffle_writer=pb.ShuffleWriterNode(
                child=child,
                partitioning=pb.PartitioningP(kind="single",
                                              num_partitions=1),
                input_partitions=self.num_partitions))
            out_partitions = 1
            prov = ("single",)
        node = pb.PlanNode(limit=pb.LimitNode(child=child, limit=n))
        return DataFrame(self.session, node, self.schema, out_partitions,
                         prov)

    def union(self, other: "DataFrame") -> "DataFrame":
        if other.num_partitions != self.num_partitions:
            raise ValueError(
                "union requires equal partition counts "
                f"({self.num_partitions} vs {other.num_partitions}); "
                "repartition one side first")
        node = pb.PlanNode(union=pb.UnionNode(
            children=[self.plan, other.plan]))
        # the layout of a union is unknown: no provenance
        return DataFrame(self.session, node, self.schema,
                         self.num_partitions)

    def _co_partitioned_with(self, other: "DataFrame", keys: list) -> bool:
        """True when probe partition p needs only build partition p: both
        sides single-partition, or both hash-partitioned on exactly the
        join keys into the same number of partitions."""
        if self.num_partitions == 1 and other.num_partitions == 1:
            return True
        a, b = self.partitioning, other.partitioning
        return (a is not None and b is not None
                and a[0] == "hash" and b[0] == "hash"
                and a[1] == b[1] == tuple(keys)
                and a[2] == b[2] == self.num_partitions
                == other.num_partitions)

    def join(self, other: "DataFrame", on: Union[str, Sequence[str]],
             how: str = "inner") -> "DataFrame":
        """An equi-join on the columns ``on`` (named alike on both
        sides); ``how`` is inner, left, right, full, semi, anti or
        existence. Sides that are not co-partitioned get a broadcast
        build side: ``other`` is collected once and replayed to every
        partition of this one. Inner and outer joins keep one copy of
        each key, this side's (SQL ``USING``); an unmatched row of
        ``other`` gets a null key there, as in the reference."""
        keys = [on] if isinstance(on, str) else list(on)
        pk = [serde.expr_to_proto(resolve(col(k), self.schema))
              for k in keys]
        bk = [serde.expr_to_proto(resolve(col(k), other.schema))
              for k in keys]
        build_plan = other.plan
        if not self._co_partitioned_with(other, keys):
            build_plan = pb.PlanNode(
                broadcast_exchange=pb.BroadcastExchangeNode(
                    child=other.plan,
                    input_partitions=other.num_partitions))
        node = pb.PlanNode(hash_join=pb.HashJoinNode(
            probe=self.plan, build=build_plan, probe_keys=pk,
            build_keys=bk, join_type=how))
        if how in ("semi", "anti"):
            return DataFrame(self.session, node, self.schema,
                             self.num_partitions, self.partitioning)
        if how == "existence":
            out = Schema(tuple(self.schema.fields)
                         + (Field("exists", DataType.BOOL, False),))
            return DataFrame(self.session, node, out, self.num_partitions,
                             self.partitioning)
        # USING-style: the build side's key columns are dropped
        raw = Schema(tuple(self.schema.fields) + tuple(other.schema.fields))
        p = len(self.schema)
        keep = list(range(p)) + [p + i for i, f in enumerate(other.schema)
                                 if f.name not in keys]
        joined = DataFrame(self.session, node, raw, self.num_partitions,
                           self.partitioning)
        return joined.select(*[Col(ir.ColumnRef(i, raw[i].name),
                                   raw[i].name) for i in keep])

    def repartition(self, n: int, *keys: Union[str, Col]) -> "DataFrame":
        if keys:
            ks = [col(k) if isinstance(k, str) else k for k in keys]
            part = pb.PartitioningP(
                kind="hash", num_partitions=n,
                hash_keys=[serde.expr_to_proto(resolve(k, self.schema))
                           for k in ks])
            prov = ("hash", tuple(k.out_name() for k in ks), n)
        else:
            part = pb.PartitioningP(kind="round_robin", num_partitions=n)
            prov = ("single",) if n == 1 else None
        node = pb.PlanNode(shuffle_writer=pb.ShuffleWriterNode(
            child=self.plan, partitioning=part,
            input_partitions=self.num_partitions))
        return DataFrame(self.session, node, self.schema, n, prov)

    # -- actions ------------------------------------------------------------

    def task_bytes(self, partition_id: int = 0) -> bytes:
        return pb.TaskDefinition(
            partition_id=partition_id, num_partitions=self.num_partitions,
            plan=self.plan).SerializeToString()

    def collect(self, metrics: Optional[dict] = None):
        """Plan, run every partition and return a pyarrow Table.
        ``metrics``, when given, receives the operators' name-keyed
        metrics of the run."""
        return self.session.execute(self, metrics=metrics)

    def to_pandas(self):
        return self.collect().to_pandas()

    def explain(self) -> str:
        """The physical plan tree."""
        return self.session.plan_physical(self).tree_string()
