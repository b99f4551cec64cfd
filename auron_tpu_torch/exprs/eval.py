"""Expression evaluation on device batches.

The port of ``auron_tpu.exprs.eval`` for the nodes in ``exprs/ir.py``:
column references (string columns too), literals (string literals as a
broadcast padded row), binary arithmetic and comparisons with numeric
promotion, the six comparisons of two strings in byte order
(``ops.strings.compare``), ``IN`` lists over numbers or strings (a
literal longer than the column's width matches nothing), Kleene
``and``/``or``, ``not``, ``is null``, ``is not null`` and casts between
bool, integer and float types. Null semantics follow Spark/SQL:
arithmetic and comparisons propagate null, ``x / 0`` and ``x % 0`` are
null, ``and``/``or`` are three-valued, and a float cast to an integer is
null where it is NaN, infinite or out of range. Every other node raises
``NotImplementedError`` naming it; so does a cast from or to a string
(ROADMAP item 17), a decimal (16d) or a date.

Each node becomes a few elementwise tensor ops on the batch's device;
nothing reads a value back to the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch.columnar.batch import (Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.ops import strings as S
from auron_tpu_torch.utils.shapes import bucket_string_width


@dataclass
class EvalContext:
    """Ambient scalars available to expressions: the partition. The
    reference's row offset and common-subexpression memo wait for the
    nodes that read them."""
    partition_id: object = 0          # python int or 0-d tensor
    num_partitions: int = 1


@dataclass(frozen=True)
class TypedValue:
    col: Column
    dtype: DataType
    precision: int = 0
    scale: int = 0

    @property
    def data(self) -> torch.Tensor:
        return self.col.data

    @property
    def validity(self) -> torch.Tensor:
        return self.col.validity


_RANK = [DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64,
         DataType.FLOAT32, DataType.FLOAT64]

_INT_BITS = {DataType.INT8: 8, DataType.INT16: 16, DataType.INT32: 32,
             DataType.INT64: 64}

#: types whose casts the numeric arm of ``cast_value`` covers
_NUMERIC_CAST = frozenset(_RANK) | {DataType.BOOL}

#: field types ``null_column_for_field`` pads with a primitive column
_PRIMITIVE_FIELDS = _NUMERIC_CAST | {DataType.DATE32, DataType.TIMESTAMP_US,
                                     DataType.NULL}

_COMPARE = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge}


def common_type(a: DataType, b: DataType) -> DataType:
    if a == b:
        return a
    if a == DataType.NULL:
        return b
    if b == DataType.NULL:
        return a
    if a == DataType.DECIMAL or b == DataType.DECIMAL:
        # decimal vs float → float64; decimal vs int → decimal
        if b.is_floating or a.is_floating:
            return DataType.FLOAT64
        return DataType.DECIMAL
    if a in _RANK and b in _RANK:
        return _RANK[max(_RANK.index(a), _RANK.index(b))]
    if {a, b} <= {DataType.DATE32, DataType.STRING}:
        return DataType.DATE32
    if {a, b} <= {DataType.TIMESTAMP_US, DataType.STRING}:
        return DataType.TIMESTAMP_US
    raise TypeError(f"no common type for {a} and {b}")


def _const_column(value, dtype: DataType, capacity: int,
                  device: torch.device) -> Column:
    """Materialize a literal as a broadcast column; a string literal is
    one padded row of its own width bucket, expanded."""
    if dtype == DataType.STRING:
        b = value.encode() if isinstance(value, str) else (value or b"")
        w = bucket_string_width(max(len(b), 1))
        row, _ = S.literal_to_device(b, w)
        chars = torch.from_numpy(row).to(device)[None, :].expand(capacity, w)
        return StringColumn(
            chars, torch.full((capacity,), len(b), dtype=torch.int32,
                              device=device),
            torch.full((capacity,), value is not None, dtype=torch.bool,
                       device=device))
    if dtype == DataType.DECIMAL:
        raise NotImplementedError(
            "literal of type decimal (ROADMAP item 16d)")
    tdt = dtype.to_torch()
    if value is None:
        return PrimitiveColumn(
            torch.zeros(capacity, dtype=tdt, device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device))
    return PrimitiveColumn(
        torch.full((capacity,), value, dtype=tdt, device=device),
        torch.ones(capacity, dtype=torch.bool, device=device))


def null_column_for_field(field: Field, cap: int,
                          device: torch.device) -> Column:
    """An all-null column of ``cap`` rows shaped for ``field``: the
    padding of outer joins (a string is 8 bytes wide, as in the
    reference). Decimal and nested fields come with those columns."""
    if field.dtype == DataType.STRING:
        return StringColumn(
            torch.zeros((cap, 8), dtype=torch.uint8, device=device),
            torch.zeros(cap, dtype=torch.int32, device=device),
            torch.zeros(cap, dtype=torch.bool, device=device))
    if field.dtype not in _PRIMITIVE_FIELDS:
        raise NotImplementedError(
            f"null column of {field.dtype.value}: the port carries "
            "primitive and string columns only (decimals: ROADMAP item "
            "16d, nested types: 16f)")
    return PrimitiveColumn(
        torch.zeros(cap, dtype=field.dtype.to_torch(), device=device),
        torch.zeros(cap, dtype=torch.bool, device=device))


def evaluate(expr: ir.Expr, batch: DeviceBatch, schema: Schema,
             ctx: EvalContext | None = None) -> TypedValue:
    """Evaluate ``expr`` against ``batch``. ``ctx`` carries the ambient
    scalars; no node of the ported subset reads them yet."""
    cap = batch.capacity
    if isinstance(expr, ir.ColumnRef):
        f = schema[expr.index]
        return TypedValue(batch.columns[expr.index], f.dtype, f.precision,
                          f.scale)

    if isinstance(expr, ir.Literal):
        return TypedValue(_const_column(expr.value, expr.dtype, cap,
                                        batch.device),
                          expr.dtype, expr.precision, expr.scale)

    if isinstance(expr, ir.BinaryExpr):
        return _eval_binary(expr, batch, schema)

    if isinstance(expr, ir.Not):
        v = evaluate(expr.child, batch, schema)
        return TypedValue(PrimitiveColumn(~v.data.bool(), v.validity),
                          DataType.BOOL)

    if isinstance(expr, (ir.IsNull, ir.IsNotNull)):
        v = evaluate(expr.child, batch, schema)
        present = v.validity if isinstance(expr, ir.IsNotNull) \
            else ~v.validity
        return TypedValue(
            PrimitiveColumn(present & batch.row_mask(),
                            torch.ones(cap, dtype=torch.bool,
                                       device=batch.device)),
            DataType.BOOL)

    if isinstance(expr, ir.Cast):
        # ``safe`` (TryCast) changes nothing here: the ported casts
        # fail only to null
        return cast_value(evaluate(expr.child, batch, schema), expr.dtype)

    if isinstance(expr, ir.InList):
        return _eval_in_list(expr, batch, schema)

    raise NotImplementedError(f"expression {type(expr).__name__}")


def _eval_in_list(expr: ir.InList, batch: DeviceBatch,
                  schema: Schema) -> TypedValue:
    """``child IN (values)``: an or of equalities, one per value; a
    string literal longer than the column's width matches nothing. The
    validity is the child's (SQL's null for a null child)."""
    v = evaluate(expr.child, batch, schema)
    hit = torch.zeros(batch.capacity, dtype=torch.bool, device=batch.device)
    if isinstance(v.col, StringColumn):
        for s in expr.values:
            row, n = S.literal_to_device(s, v.col.width)
            if n > v.col.width:
                continue
            lit = torch.from_numpy(row).to(batch.device)
            hit = hit | ((v.col.chars == lit).all(dim=1) & (v.col.lens == n))
    else:
        for s in expr.values:
            hit = hit | (v.data == s)
    if expr.negated:
        hit = ~hit
    return TypedValue(PrimitiveColumn(hit, v.validity), DataType.BOOL)


def infer_dtype(expr: ir.Expr, schema: Schema) -> tuple[DataType, int, int]:
    """Static result type of an expression (dtype, precision, scale)."""
    if isinstance(expr, ir.ColumnRef):
        f = schema[expr.index]
        return f.dtype, f.precision, f.scale
    if isinstance(expr, ir.Literal):
        return expr.dtype, expr.precision, expr.scale
    if isinstance(expr, ir.BinaryExpr):
        if expr.op in ("==", "!=", "<", "<=", ">", ">=", "and", "or"):
            return DataType.BOOL, 0, 0
        lt = infer_dtype(expr.left, schema)[0]
        rt = infer_dtype(expr.right, schema)[0]
        if lt == DataType.DECIMAL and rt == DataType.DECIMAL:
            raise NotImplementedError("infer_dtype for decimal arithmetic")
        return common_type(lt, rt), 0, 0
    if isinstance(expr, (ir.Not, ir.IsNull, ir.IsNotNull, ir.InList)):
        return DataType.BOOL, 0, 0
    if isinstance(expr, ir.Cast):
        return expr.dtype, expr.precision, expr.scale
    raise NotImplementedError(f"infer_dtype for {type(expr).__name__}")


def infer_field(expr: ir.Expr, schema: Schema, name: str = "c") -> Field:
    """Result field of an expression: the input field itself for a
    column reference (its metadata kept), else a nullable field of the
    inferred type. Nested results come with the slices that have them."""
    if isinstance(expr, ir.ColumnRef):
        return schema[expr.index].with_name(name)
    dt, p, s = infer_dtype(expr, schema)
    return Field(name, dt, True, p, s)


def _numeric_promote(v: TypedValue, target: DataType) -> TypedValue:
    if v.dtype == target:
        return v
    return cast_value(v, target)


def _eval_binary(expr: ir.BinaryExpr, batch: DeviceBatch,
                 schema: Schema) -> TypedValue:
    op = expr.op
    l = evaluate(expr.left, batch, schema)
    r = evaluate(expr.right, batch, schema)

    if op in ("and", "or"):
        ld, rd = l.data.bool(), r.data.bool()
        lv, rv = l.validity, r.validity
        if op == "and":
            data = (ld & lv) & (rd & rv)
            # null unless any FALSE or both valid
            validity = (lv & rv) | (lv & ~ld) | (rv & ~rd)
        else:
            data = (ld & lv) | (rd & rv)
            validity = (lv & rv) | (lv & ld) | (rv & rd)
        return TypedValue(PrimitiveColumn(data, validity), DataType.BOOL)

    if isinstance(l.col, StringColumn) or isinstance(r.col, StringColumn):
        return _eval_string_binary(op, l, r)

    if DataType.DECIMAL in (l.dtype, r.dtype):
        raise NotImplementedError(
            f"binary {op} on {l.dtype.value} and {r.dtype.value} (ROADMAP "
            "item 16d)")

    target = common_type(l.dtype, r.dtype)
    l = _numeric_promote(l, target)
    r = _numeric_promote(r, target)
    ld, rd = l.data, r.data
    validity = l.validity & r.validity

    if op in _COMPARE:
        return TypedValue(PrimitiveColumn(_COMPARE[op](ld, rd), validity),
                          DataType.BOOL)

    if op == "+":
        data = ld + rd
    elif op == "-":
        data = ld - rd
    elif op == "*":
        data = ld * rd
    elif op == "/":
        if target.is_floating:
            # Spark double semantics: x/0 → null (non-ANSI divide)
            data = ld / torch.where(rd == 0, 1.0, rd)
        else:
            # Java-style truncating division; x/0 → null
            safe = torch.where(rd == 0, 1, rd)
            data = torch.sign(ld) * torch.sign(safe) \
                * (torch.abs(ld) // torch.abs(safe))
        validity = validity & (rd != 0)
    elif op == "%":
        safe = torch.where(rd == 0, 1, rd)
        if target.is_floating:
            data = torch.where(rd == 0, torch.nan,
                               ld - torch.trunc(ld / safe) * safe)
        else:
            data = ld - (torch.sign(ld) * torch.sign(safe)
                         * (torch.abs(ld) // torch.abs(safe))) * safe
            validity = validity & (rd != 0)
    else:
        raise NotImplementedError(f"binary op {op}")
    return TypedValue(PrimitiveColumn(data, validity), target)


def _eval_string_binary(op: str, l: TypedValue,
                        r: TypedValue) -> TypedValue:
    """A comparison of two strings in byte order (``ops.strings.compare``);
    anything else over a string raises."""
    if not (isinstance(l.col, StringColumn)
            and isinstance(r.col, StringColumn)):
        raise TypeError(f"cannot {op} string with non-string")
    if op not in _COMPARE:
        raise NotImplementedError(f"string op {op} (ROADMAP item 17)")
    lt, eq = S.compare(l.col.chars, l.col.lens, r.col.chars, r.col.lens)
    table = {"==": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
             ">": ~(lt | eq), ">=": ~lt}
    return TypedValue(PrimitiveColumn(table[op], l.validity & r.validity),
                      DataType.BOOL)


def _eval_binary_simple(op: str, l: TypedValue,
                        r: TypedValue) -> TypedValue:
    """Arithmetic or comparison on operands already of one float type
    (no null-on-zero rules)."""
    validity = l.validity & r.validity
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul,
          "/": torch.div, **_COMPARE}[op]
    out_t = DataType.BOOL if op in _COMPARE else DataType.FLOAT64
    return TypedValue(PrimitiveColumn(fn(l.data, r.data), validity), out_t)


def cast_value(v: TypedValue, dtype: DataType) -> TypedValue:
    """Spark (non-ANSI) casts between bool, integer and float types; the
    decimal, string and date arms come with later slices."""
    if v.dtype == dtype:
        return v
    if v.dtype not in _NUMERIC_CAST or dtype not in _NUMERIC_CAST:
        item = "16d" if DataType.DECIMAL in (v.dtype, dtype) else "17"
        raise NotImplementedError(
            f"cast {v.dtype.value} -> {dtype.value}: the port casts "
            f"between bool, integer and float types only (ROADMAP item "
            f"{item})")
    validity = v.validity
    d = v.data

    if dtype == DataType.BOOL:
        return TypedValue(PrimitiveColumn(d != 0, validity), DataType.BOOL)

    if v.dtype == DataType.BOOL:
        d = d.to(torch.int32)

    if dtype in _INT_BITS:
        target = dtype.to_torch()
        if v.dtype.is_floating:
            # Spark non-ANSI Cast: truncate toward zero; NaN, ±inf and
            # values outside the target range become NULL. As in Spark,
            # where Long.MaxValue promotes to double 2^63, the input
            # exactly 2^63 is admitted and saturates to MaxValue.
            bits = _INT_BITS[dtype]
            t = torch.trunc(d.to(torch.float64))
            ok = (t >= -(2.0 ** (bits - 1))) \
                & (t <= float(2 ** (bits - 1) - 1))  # False for NaN/±inf
            at_top = t >= 2.0 ** (bits - 1)
            out = torch.where(ok & ~at_top, t, 0.0).to(target)
            out = out.masked_fill(at_top, 2 ** (bits - 1) - 1)
            return TypedValue(PrimitiveColumn(out, validity & ok), dtype)
        # int→int narrowing wraps (Java semantics)
        return TypedValue(PrimitiveColumn(d.to(target), validity), dtype)

    return TypedValue(PrimitiveColumn(d.to(dtype.to_torch()), validity),
                      dtype)
