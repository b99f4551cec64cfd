"""proto ↔ in-memory IR conversion.

The port of ``auron_tpu.ir.serde``, for the expression nodes the port
evaluates: the DataFrame front end serializes plans with ``*_to_proto``
and the planner parses incoming protos with ``parse_*``. Every other
expression node raises ``NotImplementedError`` naming it and the ROADMAP
item that brings it, in both directions.
"""

from __future__ import annotations

from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ir import auron_pb2 as pb

# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

_DT_TO_P = {
    DataType.NULL: pb.DT_NULL,
    DataType.BOOL: pb.DT_BOOL,
    DataType.INT8: pb.DT_INT8,
    DataType.INT16: pb.DT_INT16,
    DataType.INT32: pb.DT_INT32,
    DataType.INT64: pb.DT_INT64,
    DataType.FLOAT32: pb.DT_FLOAT32,
    DataType.FLOAT64: pb.DT_FLOAT64,
    DataType.DATE32: pb.DT_DATE32,
    DataType.TIMESTAMP_US: pb.DT_TIMESTAMP_US,
    DataType.DECIMAL: pb.DT_DECIMAL,
    DataType.STRING: pb.DT_STRING,
    DataType.LIST: pb.DT_LIST,
    DataType.MAP: pb.DT_MAP,
    DataType.STRUCT: pb.DT_STRUCT,
}
_P_TO_DT = {v: k for k, v in _DT_TO_P.items()}


def dtype_to_proto(dt: DataType) -> int:
    return _DT_TO_P[dt]


def parse_dtype(p: int) -> DataType:
    return _P_TO_DT[p]


def field_to_proto(f: Field) -> pb.FieldP:
    return pb.FieldP(
        name=f.name, dtype=_DT_TO_P[f.dtype], nullable=f.nullable,
        precision=f.precision, scale=f.scale,
        elem=_DT_TO_P[f.elem] if f.elem is not None else 0,
        key=_DT_TO_P[f.key] if f.key is not None else 0,
        children=[field_to_proto(cf) for cf in f.children])


def parse_field(f: pb.FieldP) -> Field:
    dt = _P_TO_DT[f.dtype]
    return Field(
        f.name, dt, f.nullable, f.precision, f.scale,
        elem=_P_TO_DT[f.elem] if dt in (DataType.LIST, DataType.MAP)
        else None,
        key=_P_TO_DT[f.key] if dt == DataType.MAP else None,
        children=tuple(parse_field(cf) for cf in f.children)
        if dt == DataType.STRUCT else ())


def schema_to_proto(schema: Schema) -> pb.SchemaP:
    return pb.SchemaP(fields=[field_to_proto(f) for f in schema.fields])


def parse_schema(p: pb.SchemaP) -> Schema:
    return Schema(tuple(parse_field(f) for f in p.fields))


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

_UNARY = {ir.Not: "not", ir.IsNull: "is_null", ir.IsNotNull: "is_not_null",
          ir.Negative: "negative"}

_STRING_PRED = {ir.StringStartsWith: ("starts_with", "prefix"),
                ir.StringEndsWith: ("ends_with", "suffix"),
                ir.StringContains: ("contains", "infix")}
_PARSE_STRING_PRED = {kind: cls for cls, (kind, _) in _STRING_PRED.items()}

#: expression kinds of the proto the port does not evaluate, with the
#: ROADMAP item that brings each
_UNPORTED_KINDS = {"nullary": "17b", "host_udf": "17b",
                   "bloom_might_contain": "17b"}
_PARSE_UNARY = {v: k for k, v in _UNARY.items()}


def _scalar_dtype(v) -> DataType:
    """Best-effort dtype for a bare python scalar (InList values)."""
    if isinstance(v, bool):
        return DataType.BOOL
    if isinstance(v, int):
        return DataType.INT64
    if isinstance(v, float):
        return DataType.FLOAT64
    if isinstance(v, str):
        return DataType.STRING
    raise TypeError(f"unsupported in-list scalar {type(v).__name__}")


def _literal_to_proto(value, dtype: DataType, precision=0,
                      scale=0) -> pb.LiteralE:
    out = pb.LiteralE(dtype=_DT_TO_P[dtype], precision=precision,
                      scale=scale)
    if value is None:
        out.is_null = True
    elif dtype == DataType.STRING:
        out.str = str(value)
    elif dtype in (DataType.FLOAT32, DataType.FLOAT64):
        out.f64 = float(value)
    elif dtype == DataType.BOOL:
        out.i64 = int(bool(value))
    else:
        out.i64 = int(value)
    return out


def expr_to_proto(e: ir.Expr) -> pb.ExprNode:
    if isinstance(e, ir.ColumnRef):
        return pb.ExprNode(column=pb.ColumnRefE(index=e.index, name=e.name))
    if isinstance(e, ir.Literal):
        return pb.ExprNode(literal=_literal_to_proto(
            e.value, e.dtype, e.precision, e.scale))
    if isinstance(e, ir.BinaryExpr):
        return pb.ExprNode(binary=pb.BinaryE(
            op=e.op, left=expr_to_proto(e.left),
            right=expr_to_proto(e.right)))
    op = _UNARY.get(type(e))
    if op is not None:
        return pb.ExprNode(unary=pb.UnaryE(op=op,
                                           child=expr_to_proto(e.child)))
    if isinstance(e, ir.Cast):
        return pb.ExprNode(cast=pb.CastE(
            child=expr_to_proto(e.child), dtype=_DT_TO_P[e.dtype],
            precision=e.precision, scale=e.scale, ansi=not e.safe))
    if isinstance(e, ir.CaseWhen):
        node = pb.CaseWhenE()
        for when, then in e.when_then:
            node.branches.append(pb.CaseWhenE.Branch(
                when=expr_to_proto(when), then=expr_to_proto(then)))
        if e.otherwise is not None:
            node.else_expr.CopyFrom(expr_to_proto(e.otherwise))
        return pb.ExprNode(case_when=node)
    if isinstance(e, ir.InList):
        node = pb.InListE(child=expr_to_proto(e.child), negated=e.negated)
        for v in e.values:
            node.values.append(_literal_to_proto(v, _scalar_dtype(v)))
        return pb.ExprNode(in_list=node)
    if isinstance(e, ir.Like):
        return pb.ExprNode(like=pb.LikeE(
            child=expr_to_proto(e.child), pattern=e.pattern,
            negated=e.negated))
    pred = _STRING_PRED.get(type(e))
    if pred is not None:
        kind, attr = pred
        return pb.ExprNode(string_pred=pb.StringPredE(
            kind=kind, child=expr_to_proto(e.child),
            pattern=getattr(e, attr)))
    if isinstance(e, ir.ScalarFunction):
        node = pb.ScalarFunctionE(
            name=e.name, args=[expr_to_proto(a) for a in e.args])
        if e.dtype is not None:
            node.has_dtype = True
            node.dtype = _DT_TO_P[e.dtype]
            node.precision = e.precision
            node.scale = e.scale
        return pb.ExprNode(scalar_function=node)
    if isinstance(e, ir.GetIndexedField):
        return pb.ExprNode(get_indexed_field=pb.GetIndexedFieldE(
            child=expr_to_proto(e.child), ordinal=e.ordinal))
    if isinstance(e, ir.GetStructField):
        return pb.ExprNode(get_struct_field=pb.GetStructFieldE(
            child=expr_to_proto(e.child), ordinal=e.ordinal))
    if isinstance(e, ir.ScalarSubquery):
        return pb.ExprNode(scalar_subquery=pb.ScalarSubqueryE(
            plan=pb.PlanNode.FromString(e.plan_bytes),
            dtype=_DT_TO_P[e.dtype], precision=e.precision, scale=e.scale,
            sid=e.sid))
    raise NotImplementedError(f"expr_to_proto: {type(e).__name__}")


def _parse_literal(p: pb.LiteralE) -> ir.Literal:
    dt = _P_TO_DT[p.dtype]
    if p.is_null:
        value = None
    elif p.WhichOneof("value") == "str":
        value = p.str
    elif p.WhichOneof("value") == "f64":
        value = p.f64
    else:
        value = bool(p.i64) if dt == DataType.BOOL else p.i64
    return ir.Literal(value, dt, p.precision, p.scale)


def parse_expr(p: pb.ExprNode) -> ir.Expr:
    kind = p.WhichOneof("expr")
    if kind == "column":
        return ir.ColumnRef(p.column.index, p.column.name)
    if kind == "literal":
        return _parse_literal(p.literal)
    if kind == "binary":
        return ir.BinaryExpr(p.binary.op, parse_expr(p.binary.left),
                             parse_expr(p.binary.right))
    if kind == "unary":
        cls = _PARSE_UNARY.get(p.unary.op)
        if cls is None:
            raise NotImplementedError(f"parse_expr: unary {p.unary.op}")
        return cls(parse_expr(p.unary.child))
    if kind == "cast":
        # TryCast is null-on-failure regardless of session ANSI mode
        safe = p.cast.try_cast or not p.cast.ansi
        return ir.Cast(parse_expr(p.cast.child), _P_TO_DT[p.cast.dtype],
                       p.cast.precision, p.cast.scale, safe=safe)
    if kind == "in_list":
        return ir.InList(parse_expr(p.in_list.child),
                         tuple(_parse_literal(v).value
                               for v in p.in_list.values),
                         p.in_list.negated)
    if kind == "case_when":
        branches = tuple((parse_expr(b.when), parse_expr(b.then))
                         for b in p.case_when.branches)
        otherwise = (parse_expr(p.case_when.else_expr)
                     if p.case_when.HasField("else_expr") else None)
        return ir.CaseWhen(branches, otherwise)
    if kind == "like":
        return ir.Like(parse_expr(p.like.child), p.like.pattern,
                       p.like.negated)
    if kind == "string_pred":
        cls = _PARSE_STRING_PRED[p.string_pred.kind]
        return cls(parse_expr(p.string_pred.child), p.string_pred.pattern)
    if kind == "scalar_function":
        sf = p.scalar_function
        return ir.ScalarFunction(
            sf.name, tuple(parse_expr(a) for a in sf.args),
            dtype=_P_TO_DT[sf.dtype] if sf.has_dtype else None,
            precision=sf.precision, scale=sf.scale)
    if kind == "get_indexed_field":
        return ir.GetIndexedField(parse_expr(p.get_indexed_field.child),
                                  p.get_indexed_field.ordinal)
    if kind == "get_struct_field":
        return ir.GetStructField(parse_expr(p.get_struct_field.child),
                                 p.get_struct_field.ordinal)
    if kind == "scalar_subquery":
        q = p.scalar_subquery
        return ir.ScalarSubquery(q.plan.SerializeToString(),
                                 _P_TO_DT[q.dtype], q.precision, q.scale,
                                 q.sid)
    if kind in _UNPORTED_KINDS:
        raise NotImplementedError(
            f"parse_expr: {kind} (ROADMAP item {_UNPORTED_KINDS[kind]})")
    raise NotImplementedError(f"parse_expr: {kind}")


# ---------------------------------------------------------------------------
# sort orders / agg functions
# ---------------------------------------------------------------------------

def sort_order_to_proto(o: ir.SortOrder) -> pb.SortOrderP:
    return pb.SortOrderP(expr=expr_to_proto(o.expr), ascending=o.ascending,
                         nulls_first=o.nulls_first)


def parse_sort_order(p: pb.SortOrderP) -> ir.SortOrder:
    return ir.SortOrder(parse_expr(p.expr), p.ascending, p.nulls_first)


def agg_to_proto(a: ir.AggFunction) -> pb.AggFunctionP:
    out = pb.AggFunctionP(fn=a.fn, distinct=a.distinct,
                          expected_items=a.expected_items, fpp=a.fpp)
    if a.arg is not None:
        out.arg.CopyFrom(expr_to_proto(a.arg))
    return out


def parse_agg(p: pb.AggFunctionP) -> ir.AggFunction:
    arg = parse_expr(p.arg) if p.HasField("arg") else None
    return ir.AggFunction(p.fn, arg, p.distinct, p.expected_items, p.fpp)
