"""Expression evaluation on device batches.

The port of ``auron_tpu.exprs.eval`` for the nodes in ``exprs/ir.py``:
column references, literals (a string literal as a broadcast padded
row), binary arithmetic and comparisons with numeric promotion, the six
comparisons of two strings in byte order, ``IN`` lists, Kleene
``and``/``or``, ``not``, ``is null``, ``is not null``, negation,
``CASE WHEN`` (string branches padded to the widest), ``LIKE`` and the
three string predicates, the scalar functions of ``exprs/functions.py``,
``split(...)[i]`` and Spark's (non-ANSI) cast matrix over bool, integer,
float, decimal, date, timestamp and string. Null semantics follow
Spark/SQL: arithmetic and comparisons propagate null, ``x / 0`` and
``x % 0`` are null, ``and``/``or`` are three-valued, and a cast that
fails gives null (or raises, for an ANSI cast from a string). Over
nested columns: ``list[i]`` (``GetIndexedField``, null past the end)
and ``struct.field`` (``GetStructField``, null where the struct is);
the nodes of ROADMAP item 17b raise ``NotImplementedError`` naming it.

Decimals follow Spark's types (``decimal_result_type``, with
``allowPrecisionLoss``): ``+ - *`` and the comparisons run on the
unscaled int64 while the result stays within 18 digits, else on two
int64 limbs (``columnar/decimal128.py``); overflow past the declared
precision nulls the row; ``/`` and any float operand go through
float64.

Each node becomes a few elementwise tensor ops on the batch's device.
Four things run on the host, as the reference's ``jax.pure_callback``
does: the general ``LIKE`` regex, casts to and from strings (decimals
included),
``split(...)[i]`` and timestamp parsing; each makes one packed readback
and one upload per batch (``exprs/host.py``). With ``EvalContext.memo``
set, each distinct subexpression is evaluated once per batch.
"""

from __future__ import annotations

import datetime
import re
import struct
from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.columnar.batch import (Column, Decimal128Column,
                                            DeviceBatch, ListColumn,
                                            MapColumn, PrimitiveColumn,
                                            StringColumn, StringListColumn,
                                            StringMapColumn, StructColumn,
                                            pad_string_width)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.host import decode, host_map, np_dtype
from auron_tpu_torch.ops import strings as S
from auron_tpu_torch.utils.shapes import bucket_string_width


@dataclass
class EvalContext:
    """Ambient scalars available to expressions: the partition, and the
    common-subexpression memo. ``memo``: when an operator passes a fresh
    dict for one batch, ``evaluate`` caches each subexpression's
    TypedValue per (batch, expr), so structural duplicates share one
    result; the default None disables caching."""
    partition_id: object = 0          # python int or 0-d tensor
    num_partitions: int = 1
    memo: object = None               # dict | None; see docstring


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

_COMPARE = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge}

US_PER_DAY = 86_400_000_000


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant divisor ``c`` (a number, or a one-element
    tensor): a multiplication by ``1 / c``, as XLA compiles it."""
    return x * (torch.reciprocal(c) if torch.is_tensor(c) else 1.0 / c)


def decimal_result_type(op: str, lp: int, ls: int, rp: int,
                        rs: int) -> tuple[int, int, int]:
    """Spark's decimal binary result type with the ``allowPrecisionLoss``
    scale adjustment (``DecimalPrecision.adjustPrecisionScale``):
    (precision, scale, full_scale), where full_scale is the scale the raw
    limb computation gives before any precision-loss rescale. One
    definition for ``infer_dtype`` and the evaluation, so declared
    schemas and evaluated columns agree."""
    if op == "*":
        p, s = lp + rp + 1, ls + rs
        full_s = ls + rs
    else:   # + - and the comparisons share add/sub typing
        s = max(ls, rs)
        p = max(lp - ls, rp - rs) + s + 1
        full_s = s
    if p <= 38:
        return p, s, full_s
    min_scale = min(s, 6)
    return 38, max(38 - (p - s), min_scale), full_s


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


def _ones(cap: int, device) -> torch.Tensor:
    return torch.ones(cap, dtype=torch.bool, device=device)


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
    tdt = dtype.to_torch()
    if value is None:
        return PrimitiveColumn(
            torch.zeros(capacity, dtype=tdt, device=device),
            torch.zeros(capacity, dtype=torch.bool, device=device))
    return PrimitiveColumn(
        torch.full((capacity,), value, dtype=tdt, device=device),
        _ones(capacity, device))


def null_column_for_field(field: Field, cap: int,
                          device: torch.device) -> Column:
    """An all-null column of ``cap`` rows shaped for ``field``: the
    padding of outer joins (a string is 8 bytes wide, as in the
    reference; a decimal of precision > 18 two limbs; a list or map one
    element slot; a struct its all-null children)."""
    def z(*shape, dtype=torch.bool):
        return torch.zeros(shape, dtype=dtype, device=device)

    i32, u8 = torch.int32, torch.uint8
    dt = field.dtype
    if dt == DataType.STRING:
        return StringColumn(z(cap, 8, dtype=u8), z(cap, dtype=i32), z(cap))
    if dt == DataType.DECIMAL and field.precision > 18:
        return Decimal128Column(z(cap, dtype=torch.int64),
                                z(cap, dtype=torch.int64), z(cap))
    if dt == DataType.MAP and field.key == DataType.STRING:
        return StringMapColumn(z(cap, 1, 8, dtype=u8), z(cap, 1, dtype=i32),
                               z(cap, 1, 8, dtype=u8), z(cap, 1, dtype=i32),
                               z(cap, 1), z(cap, dtype=i32), z(cap))
    if dt == DataType.LIST and field.elem == DataType.STRING:
        return StringListColumn(z(cap, 1, 8, dtype=u8), z(cap, 1, dtype=i32),
                                z(cap, 1), z(cap, dtype=i32), z(cap))
    if dt == DataType.LIST:
        return ListColumn(z(cap, 1, dtype=field.elem.to_torch()), z(cap, 1),
                          z(cap, dtype=i32), z(cap))
    if dt == DataType.MAP:
        return MapColumn(z(cap, 1, dtype=field.key.to_torch()),
                         z(cap, 1, dtype=field.elem.to_torch()), z(cap, 1),
                         z(cap, dtype=i32), z(cap))
    if dt == DataType.STRUCT:
        return StructColumn(tuple(null_column_for_field(cf, cap, device)
                                  for cf in field.children), z(cap))
    return PrimitiveColumn(z(cap, dtype=dt.to_torch()), z(cap))


# ---------------------------------------------------------------------------
# main entry
# ---------------------------------------------------------------------------

def evaluate(expr: ir.Expr, batch: DeviceBatch, schema: Schema,
             ctx: EvalContext | None = None) -> TypedValue:
    """Evaluate ``expr`` against ``batch``; with ``ctx.memo`` set, each
    distinct subexpression evaluates once per batch (expression trees
    are frozen and hashable, so structural duplicates share one
    result)."""
    ctx = ctx or EvalContext()
    memo = ctx.memo
    if memo is None or isinstance(expr, (ir.ColumnRef, ir.Literal)):
        return _evaluate(expr, batch, schema, ctx)
    key = (id(batch), expr, _float_literal_bits(expr))
    hit = memo.get(key)
    if hit is None:
        hit = _evaluate(expr, batch, schema, ctx)
        memo[key] = hit
    return hit


def _float_literal_bits(expr: ir.Expr) -> tuple:
    """The bits of every float literal in ``expr``, in tree order. Frozen
    trees compare ``0.0`` equal to ``-0.0``; the memo key adds these bits
    so that ``x * 0.0`` and ``x * -0.0`` do not share a result."""
    if isinstance(expr, ir.Literal):
        return (struct.pack("<d", expr.value),) \
            if isinstance(expr.value, float) else ()
    return tuple(b for ch in expr.children() for b in _float_literal_bits(ch))


def _evaluate(expr: ir.Expr, batch: DeviceBatch, schema: Schema,
              ctx: EvalContext) -> TypedValue:
    cap = batch.capacity
    if isinstance(expr, ir.ColumnRef):
        f = schema[expr.index]
        return TypedValue(batch.columns[expr.index], f.dtype, f.precision,
                          f.scale)

    if isinstance(expr, ir.ScalarSubquery):
        raise RuntimeError(
            "unresolved scalar subquery reached evaluation — plans with "
            "subqueries must go through plan_from_bytes / the DataFrame "
            "API (ScalarSubqueryBinderOp substitutes the value)")

    if isinstance(expr, ir.Literal):
        if expr.dtype == DataType.DECIMAL and expr.precision > 18:
            return TypedValue(_wide_literal(expr.value, cap, batch.device),
                              DataType.DECIMAL, expr.precision, expr.scale)
        return TypedValue(_const_column(expr.value, expr.dtype, cap,
                                        batch.device),
                          expr.dtype, expr.precision, expr.scale)

    if isinstance(expr, ir.BinaryExpr):
        return _eval_binary(expr, batch, schema, ctx)

    if isinstance(expr, ir.Not):
        v = evaluate(expr.child, batch, schema, ctx)
        return TypedValue(PrimitiveColumn(~v.data.bool(), v.validity),
                          DataType.BOOL)

    if isinstance(expr, (ir.IsNull, ir.IsNotNull)):
        v = evaluate(expr.child, batch, schema, ctx)
        present = v.validity if isinstance(expr, ir.IsNotNull) \
            else ~v.validity
        return TypedValue(
            PrimitiveColumn(present & batch.row_mask(),
                            _ones(cap, batch.device)),
            DataType.BOOL)

    if isinstance(expr, ir.Negative):
        # two's complement: -INT64_MIN wraps to itself, as in Java
        v = evaluate(expr.child, batch, schema, ctx)
        if isinstance(v.col, Decimal128Column):
            return TypedValue(Decimal128Column(*D.neg128(v.col.hi, v.col.lo),
                                               v.validity),
                              v.dtype, v.precision, v.scale)
        return TypedValue(PrimitiveColumn(-v.data, v.validity),
                          v.dtype, v.precision, v.scale)

    if isinstance(expr, ir.Cast):
        v = evaluate(expr.child, batch, schema, ctx)
        return cast_value(v, expr.dtype, expr.precision, expr.scale,
                          safe=expr.safe, num_rows=batch.num_rows)

    if isinstance(expr, ir.CaseWhen):
        return _eval_case(expr, batch, schema, ctx)

    if isinstance(expr, ir.InList):
        return _eval_in_list(expr, batch, schema, ctx)

    if isinstance(expr, (ir.Like, ir.StringStartsWith, ir.StringEndsWith,
                         ir.StringContains)):
        return _eval_like(expr, batch, schema, ctx)

    if isinstance(expr, ir.ScalarFunction):
        from auron_tpu_torch.exprs.functions import dispatch_function
        return dispatch_function(expr, batch, schema, ctx)

    if isinstance(expr, ir.GetIndexedField):
        if _is_split(expr.child):
            # split(...)[i] fused: the string list is never materialized
            from auron_tpu_torch.exprs.fn_strings import split_index
            return split_index(expr.child.args, expr.ordinal, batch,
                               schema, ctx)
        return _get_indexed(expr, evaluate(expr.child, batch, schema, ctx),
                            schema)

    if isinstance(expr, ir.GetStructField):
        v = evaluate(expr.child, batch, schema, ctx)
        if not isinstance(v.col, StructColumn):
            raise TypeError("GetStructField needs a struct")
        child = v.col.children[expr.ordinal]
        cf = infer_field(expr.child, schema).children[expr.ordinal]
        return TypedValue(child.with_validity(child.validity & v.validity),
                          cf.dtype, cf.precision, cf.scale)

    raise NotImplementedError(f"expression {type(expr).__name__}")


def _get_indexed(expr: ir.GetIndexedField, v: TypedValue,
                 schema: Schema) -> TypedValue:
    """``list[i]`` (0-based): null where the list is null, shorter than
    i + 1, or holds a null there."""
    col = v.col
    if not isinstance(col, (ListColumn, StringListColumn)):
        raise TypeError("GetIndexedField needs a list")
    i = expr.ordinal
    in_range = (i >= 0) & (i < col.lens)
    idx = min(max(i, 0), col.max_elems - 1)
    valid = col.validity & in_range & col.elem_valid[:, idx]
    if isinstance(col, StringListColumn):
        return TypedValue(StringColumn(col.chars[:, idx],
                                       torch.where(valid, col.slens[:, idx],
                                                   0), valid),
                          DataType.STRING)
    return TypedValue(PrimitiveColumn(col.values[:, idx], valid),
                      infer_dtype(expr, schema)[0])


def _wide_literal(value, cap: int, device) -> Decimal128Column:
    """A decimal(p > 18) literal (its unscaled int) broadcast to ``cap``
    rows of limbs; None is an all-null column."""
    hi, lo = D.int_limbs(0 if value is None else int(value))
    return Decimal128Column(
        torch.full((cap,), hi, dtype=torch.int64, device=device),
        torch.full((cap,), lo, dtype=torch.int64, device=device),
        torch.full((cap,), value is not None, dtype=torch.bool,
                   device=device))


def _is_split(e: ir.Expr) -> bool:
    return isinstance(e, ir.ScalarFunction) and e.name == "split"


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
        lt, lp, ls = infer_dtype(expr.left, schema)
        rt, rp, rs = infer_dtype(expr.right, schema)
        if lt == DataType.DECIMAL and rt == DataType.DECIMAL:
            if expr.op == "/":
                return DataType.FLOAT64, 0, 0
            p, s, _fs = decimal_result_type(expr.op, lp, ls, rp, rs)
            return DataType.DECIMAL, p, s
        return common_type(lt, rt), 0, 0
    if isinstance(expr, (ir.Not, ir.IsNull, ir.IsNotNull, ir.InList,
                         ir.Like, ir.StringStartsWith, ir.StringEndsWith,
                         ir.StringContains)):
        return DataType.BOOL, 0, 0
    if isinstance(expr, ir.Negative):
        return infer_dtype(expr.child, schema)
    if isinstance(expr, (ir.Cast, ir.ScalarSubquery)):
        return expr.dtype, expr.precision, expr.scale
    if isinstance(expr, ir.CaseWhen):
        if expr.when_then:
            return infer_dtype(expr.when_then[0][1], schema)
        return infer_dtype(expr.otherwise, schema)
    if isinstance(expr, ir.ScalarFunction):
        from auron_tpu_torch.exprs.functions import function_result_type
        return function_result_type(expr, schema)
    if isinstance(expr, ir.GetIndexedField):
        if _is_split(expr.child):
            return DataType.STRING, 0, 0
        if infer_dtype(expr.child, schema)[0] != DataType.LIST:
            raise NotImplementedError("GetIndexedField on non-column list")
        if isinstance(expr.child, ir.ColumnRef):
            return schema[expr.child.index].elem, 0, 0
        from auron_tpu_torch.exprs.fn_arrays import elem_dtype_of
        return elem_dtype_of(expr.child, schema), 0, 0
    if isinstance(expr, ir.GetStructField):
        cf = infer_field(expr.child, schema).children[expr.ordinal]
        return cf.dtype, cf.precision, cf.scale
    raise NotImplementedError(f"infer_dtype for {type(expr).__name__}")


def infer_field(expr: ir.Expr, schema: Schema, name: str = "c") -> Field:
    """Result field of an expression, nested-aware: the input field
    itself for a column reference, a function's own result field where
    it has one (list and map element types, struct children), else a
    nullable field of the inferred type."""
    if isinstance(expr, ir.ColumnRef):
        return schema[expr.index].with_name(name)
    if isinstance(expr, ir.ScalarFunction):
        from auron_tpu_torch.exprs.functions import function_result_field
        f = function_result_field(expr, schema)
        if f is not None:
            return f.with_name(name)
    if isinstance(expr, ir.GetStructField):
        return infer_field(expr.child, schema).children[expr.ordinal] \
            .with_name(name)
    if isinstance(expr, ir.CaseWhen) and expr.otherwise is not None:
        f = infer_field(expr.otherwise, schema)
        if f.dtype in (DataType.MAP, DataType.STRUCT, DataType.LIST):
            return f.with_name(name)
    dt, p, s = infer_dtype(expr, schema)
    if dt in (DataType.MAP, DataType.STRUCT):
        raise NotImplementedError(
            f"cannot infer nested ({dt.value}) result metadata for "
            f"{type(expr).__name__}; add an explicit typed branch "
            "(e.g. an 'otherwise' arm) or project the nested column "
            "directly")
    elem = None
    if dt == DataType.LIST and isinstance(expr, ir.ScalarFunction):
        from auron_tpu_torch.exprs.fn_arrays import elem_dtype_of
        elem = elem_dtype_of(expr, schema)
    return Field(name, dt, True, p, s, elem=elem)


# ---------------------------------------------------------------------------
# binary ops
# ---------------------------------------------------------------------------

def _numeric_promote(v: TypedValue, target: DataType) -> TypedValue:
    if v.dtype == target:
        return v
    return cast_value(v, target)


def _eval_binary(expr: ir.BinaryExpr, batch: DeviceBatch, schema: Schema,
                 ctx: EvalContext) -> TypedValue:
    op = expr.op
    l = evaluate(expr.left, batch, schema, ctx)
    r = evaluate(expr.right, batch, schema, ctx)

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
        return _eval_decimal_binary(op, l, r)

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
        if target.is_floating and _nonzero_literal(expr.right):
            data = div_const(ld, rd[:1])
        elif target.is_floating:
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


def _nonzero_literal(e: ir.Expr) -> bool:
    return isinstance(e, ir.Literal) and e.value not in (None, 0)


def _eval_string_binary(op: str, l: TypedValue,
                        r: TypedValue) -> TypedValue:
    """A comparison of two strings in byte order (``ops.strings.compare``);
    anything else over a string raises."""
    if not (isinstance(l.col, StringColumn)
            and isinstance(r.col, StringColumn)):
        raise TypeError(f"cannot {op} string with non-string")
    if op not in _COMPARE:
        raise TypeError(f"unsupported string op {op}")
    lt, eq = S.compare(l.col.chars, l.col.lens, r.col.chars, r.col.lens)
    table = {"==": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
             ">": ~(lt | eq), ">=": ~lt}
    return TypedValue(PrimitiveColumn(table[op], l.validity & r.validity),
                      DataType.BOOL)


def _eval_decimal_binary(op: str, l: TypedValue,
                         r: TypedValue) -> TypedValue:
    """Decimal arithmetic and comparisons. An integer operand is a
    decimal(18, 0); a float operand, or ``/``, sends both sides through
    float64; a result within 18 digits stays on the unscaled int64, any
    other on the limbs (``_eval_decimal128_binary``)."""
    if l.dtype != DataType.DECIMAL and not l.dtype.is_floating:
        l = TypedValue(PrimitiveColumn(l.data.to(torch.int64), l.validity),
                       DataType.DECIMAL, 18, 0)
    if r.dtype != DataType.DECIMAL and not r.dtype.is_floating:
        r = TypedValue(PrimitiveColumn(r.data.to(torch.int64), r.validity),
                       DataType.DECIMAL, 18, 0)
    if l.dtype.is_floating or r.dtype.is_floating or op == "/":
        return _eval_binary_simple(op, _decimal_to_f64(l),
                                   _decimal_to_f64(r))
    s = max(l.scale, r.scale)
    rp, rs, full_s = decimal_result_type(op, l.precision, l.scale,
                                         r.precision, r.scale)
    if isinstance(l.col, Decimal128Column) or \
            isinstance(r.col, Decimal128Column) or rp > 18 or full_s > rs:
        return _eval_decimal128_binary(op, l, r, rp, rs, full_s)
    ld = l.data * (10 ** (s - l.scale))
    rd = r.data * (10 ** (s - r.scale))
    validity = l.validity & r.validity
    if op in _COMPARE:
        return TypedValue(PrimitiveColumn(_COMPARE[op](ld, rd), validity),
                          DataType.BOOL)
    if op == "+":
        return TypedValue(PrimitiveColumn(ld + rd, validity),
                          DataType.DECIMAL, rp, s)
    if op == "-":
        return TypedValue(PrimitiveColumn(ld - rd, validity),
                          DataType.DECIMAL, rp, s)
    if op == "*":
        return TypedValue(PrimitiveColumn(l.data * r.data, validity),
                          DataType.DECIMAL, rp, l.scale + r.scale)
    raise NotImplementedError(f"decimal op {op}")


def _limbs_of(v: TypedValue):
    """(hi, lo) limbs of a decimal of either representation."""
    if isinstance(v.col, Decimal128Column):
        return v.col.hi, v.col.lo
    return D.from_int64(v.data.to(torch.int64))


def _mk_decimal(hi, lo, validity, precision: int,
                scale: int) -> TypedValue:
    """Limb results in the narrowest faithful column: the low limb for
    precision <= 18 (|x| < 10^18 always fits it), else the limbs."""
    if precision <= 18:
        return TypedValue(PrimitiveColumn(lo, validity), DataType.DECIMAL,
                          precision, scale)
    return TypedValue(Decimal128Column(hi, lo, validity), DataType.DECIMAL,
                      precision, scale)


def _eval_decimal128_binary(op: str, l: TypedValue, r: TypedValue,
                            rp: int, rs: int, full_s: int) -> TypedValue:
    """Decimal arithmetic and comparisons on the limbs. Overflow past the
    declared precision nulls the row; where ``adjustPrecisionScale``
    cut the scale (full_s > rs), the raw result rescales HALF_UP.

    A rescale by 10^ds can push a 38-digit value past 2^127 and wrap, so
    each is guarded by ``fits_precision(38 - ds)`` first: for arithmetic
    an unsafe rescale means the result overflows (null); for a
    comparison the unsafe side's sign decides the order."""
    s = max(l.scale, r.scale)
    lh, ll_ = _limbs_of(l)
    rh, rl = _limbs_of(r)
    validity = l.validity & r.validity

    def rescale_safe(h, lo, ds):
        if ds == 0:
            return h, lo, torch.ones_like(validity)
        ok = D.fits_precision(h, lo, 38 - ds)
        h2, l2 = D.mul_pow10(h, lo, ds)
        return h2, l2, ok

    if op in _COMPARE:
        ah, al, oka = rescale_safe(lh, ll_, s - l.scale)
        bh, bl, okb = rescale_safe(rh, rl, s - r.scale)
        lt, eq = D.cmp128(ah, al, bh, bl)
        # at most one side (the smaller-scale one) can be unsafe, and its
        # magnitude at the common scale is >= 10^38 while the other's is
        # below: the unsafe side dominates, and its sign decides
        a_unsafe, b_unsafe = ~oka, ~okb
        lt = torch.where(a_unsafe, lh < 0, torch.where(b_unsafe, rh >= 0,
                                                        lt))
        eq = eq & ~(a_unsafe | b_unsafe)
        out = {"==": eq, "!=": ~eq, "<": lt, "<=": lt | eq,
               ">": ~(lt | eq), ">=": ~lt}[op]
        return TypedValue(PrimitiveColumn(out, validity), DataType.BOOL)
    if op in ("+", "-"):
        ah, al, oka = rescale_safe(lh, ll_, s - l.scale)
        bh, bl, okb = rescale_safe(rh, rl, s - r.scale)
        if op == "+":
            oh, ol = D.add128(ah, al, bh, bl)
            bsign = bh < 0
        else:
            oh, ol = D.sub128(ah, al, bh, bl)
            bsign = (bh >= 0) & ~((bh == 0) & (bl == 0))
        # 128-bit wrap: same-sign operands whose result flips sign
        # overflowed 2^127 (a wrapped value could pass the precision
        # check as a plausible wrong value)
        asign = ah < 0
        no_wrap = ~((asign == bsign) & ((oh < 0) != asign))
        ok = oka & okb & no_wrap
    elif op == "*":
        oh, ol = D.mul128(lh, ll_, rh, rl)
        # a raw product past 2^127 wraps silently in the low-128
        # multiply: a float magnitude check at the representable bound
        # (2^127 ~ 1.70e38, with a margin for float error) nulls it, even
        # where the precision-loss rescale would have brought it back
        mag = torch.abs(D.to_float64(lh, ll_) * D.to_float64(rh, rl))
        ok = mag < 1.6e38
    else:
        raise NotImplementedError(f"decimal128 op {op}")
    if full_s > rs:
        # the precision-loss rescale (adjustPrecisionScale, HALF_UP)
        oh, ol = D.div_pow10_half_up(oh, ol, full_s - rs)
    ok = ok & D.fits_precision(oh, ol, rp)
    return _mk_decimal(oh, ol, validity & ok, rp, rs)


def _decimal_to_f64(v: TypedValue) -> TypedValue:
    """A decimal (either representation) or a number as float64; the
    scale divides as a reciprocal multiply (``div_const``)."""
    if isinstance(v.col, Decimal128Column):
        f = div_const(D.to_float64(v.col.hi, v.col.lo), 10.0 ** v.scale)
        return TypedValue(PrimitiveColumn(f, v.validity), DataType.FLOAT64)
    if v.dtype == DataType.DECIMAL:
        return TypedValue(PrimitiveColumn(
            div_const(v.data.to(torch.float64), 10.0 ** v.scale),
            v.validity), DataType.FLOAT64)
    if v.dtype != DataType.FLOAT64:
        return TypedValue(PrimitiveColumn(v.data.to(torch.float64),
                                          v.validity), DataType.FLOAT64)
    return v


def _eval_binary_simple(op: str, l: TypedValue,
                        r: TypedValue) -> TypedValue:
    """Arithmetic or comparison on operands already of one float type
    (no null-on-zero rules)."""
    validity = l.validity & r.validity
    fn = {"+": torch.add, "-": torch.sub, "*": torch.mul,
          "/": torch.div, **_COMPARE}[op]
    out_t = DataType.BOOL if op in _COMPARE else DataType.FLOAT64
    return TypedValue(PrimitiveColumn(fn(l.data, r.data), validity), out_t)


# ---------------------------------------------------------------------------
# case / in-list / like
# ---------------------------------------------------------------------------

def select_column(take: torch.Tensor, a: Column, b: Column,
                  validity: torch.Tensor) -> Column:
    """Row-wise ``a`` where ``take`` else ``b``, with ``validity``;
    strings are padded to the wider of the two first."""
    if isinstance(a, Decimal128Column):
        return Decimal128Column(torch.where(take, a.hi, b.hi),
                                torch.where(take, a.lo, b.lo), validity)
    if isinstance(a, StringColumn):
        w = max(a.width, b.width)
        a, b = pad_string_width(a, w), pad_string_width(b, w)
        return StringColumn(torch.where(take[:, None], a.chars, b.chars),
                            torch.where(take, a.lens, b.lens), validity)
    return PrimitiveColumn(torch.where(take, a.data, b.data), validity)


def _eval_case(expr: ir.CaseWhen, batch: DeviceBatch, schema: Schema,
               ctx: EvalContext) -> TypedValue:
    branches = [(evaluate(w, batch, schema, ctx),
                 evaluate(t, batch, schema, ctx))
                for w, t in expr.when_then]
    if expr.otherwise is not None:
        otherwise = evaluate(expr.otherwise, batch, schema, ctx)
    else:
        t0 = branches[0][1]
        none = torch.zeros(batch.capacity, dtype=torch.bool,
                           device=batch.device)
        if isinstance(t0.col, StringColumn):
            col = StringColumn(torch.zeros_like(t0.col.chars),
                               torch.zeros_like(t0.col.lens), none)
        elif isinstance(t0.col, Decimal128Column):
            col = Decimal128Column(torch.zeros_like(t0.col.hi),
                                   torch.zeros_like(t0.col.lo), none)
        else:
            col = PrimitiveColumn(torch.zeros_like(t0.data), none)
        otherwise = TypedValue(col, t0.dtype, t0.precision, t0.scale)

    result = otherwise
    for cond, val in reversed(branches):
        take = cond.data.bool() & cond.validity
        col = select_column(take, val.col, result.col,
                            torch.where(take, val.validity,
                                        result.validity))
        result = TypedValue(col, val.dtype, val.precision, val.scale)
    return result


def _eval_in_list(expr: ir.InList, batch: DeviceBatch, schema: Schema,
                  ctx: EvalContext) -> TypedValue:
    """``child IN (values)``: an or of equalities, one per value; a
    string literal longer than the column's width matches nothing. The
    validity is the child's (SQL's null for a null child)."""
    v = evaluate(expr.child, batch, schema, ctx)
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


def like_regex(pattern: str) -> "re.Pattern":
    """The host regex of a general ``LIKE`` pattern (the reference's)."""
    return re.compile("^" + re.escape(pattern).replace("%", ".*")
                      .replace("_", ".") + "$", re.S)


def _eval_like(expr, batch: DeviceBatch, schema: Schema,
               ctx: EvalContext) -> TypedValue:
    """``LIKE`` in three classes: no wildcard (an equality), ``a%`` /
    ``%a`` / ``%a%`` (a prefix, suffix or infix), and any other pattern
    through the host regex; the three string predicates are the device
    kernels of ``ops/strings.py``."""
    v = evaluate(expr.child, batch, schema, ctx)
    if not isinstance(v.col, StringColumn):
        raise TypeError("LIKE on non-string")
    chars, lens = v.col.chars, v.col.lens

    if isinstance(expr, ir.StringStartsWith):
        hit = S.starts_with(chars, lens, expr.prefix.encode())
    elif isinstance(expr, ir.StringEndsWith):
        hit = S.ends_with(chars, lens, expr.suffix.encode())
    elif isinstance(expr, ir.StringContains):
        hit = S.contains(chars, lens, expr.infix.encode())
    else:
        pat = expr.pattern
        body = pat.strip("%")
        if "%" not in pat and "_" not in pat:
            row, ln = S.literal_to_device(pat.encode(), v.col.width)
            if ln <= v.col.width:
                lit = torch.from_numpy(row).to(batch.device)
                hit = (chars == lit).all(dim=1) & (lens == ln)
            else:
                hit = torch.zeros(batch.capacity, dtype=torch.bool,
                                  device=batch.device)
        elif "_" not in body and "%" not in body:
            starts = not pat.startswith("%")
            ends = not pat.endswith("%")
            if starts:
                hit = S.starts_with(chars, lens, body.encode())
            elif ends:
                hit = S.ends_with(chars, lens, body.encode())
            else:
                hit = S.contains(chars, lens, body.encode())
        else:
            rx = like_regex(pat)

            def host_like(n, chars_np, lens_np, valid_np):
                out = np.zeros(chars_np.shape[0], bool)
                for i in np.flatnonzero(valid_np[:n]):
                    out[i] = rx.match(decode(chars_np, lens_np, i)) \
                        is not None
                return (out,)

            (hit,) = host_map(host_like, [chars, lens, v.validity],
                              batch.num_rows, [(np.bool_, ())],
                              batch.device)
    if getattr(expr, "negated", False):
        hit = ~hit
    return TypedValue(PrimitiveColumn(hit, v.validity), DataType.BOOL)


# ---------------------------------------------------------------------------
# cast
# ---------------------------------------------------------------------------

def _all_rows(v: TypedValue) -> torch.Tensor:
    """A row count covering every row of ``v`` (a cast called outside a
    batch treats each row as live)."""
    return torch.tensor(v.validity.shape[0], dtype=torch.int32,
                        device=v.validity.device)


def cast_value(v: TypedValue, dtype: DataType, precision: int = 0,
               scale: int = 0, safe: bool = True,
               num_rows: torch.Tensor | None = None) -> TypedValue:
    """Spark cast semantics. ``safe=True`` is the default
    null-on-failure mode (Spark non-ANSI / TryCast); ``safe=False`` raises
    on an unparseable string (ANSI). ``num_rows`` bounds the rows a host
    cast (from or to a string) reads; every row when it is None."""
    if v.dtype == dtype and (dtype != DataType.DECIMAL
                             or (v.scale == scale
                                 and v.precision <= precision)):
        return v
    if num_rows is None:
        num_rows = _all_rows(v)
    validity = v.validity

    if isinstance(v.col, StringColumn):
        return _cast_from_string(v, dtype, precision, scale, safe, num_rows)
    if isinstance(v.col, Decimal128Column) or (
            v.dtype == DataType.DECIMAL and dtype == DataType.DECIMAL
            and precision > 18):
        return _cast_decimal128(v, dtype, precision, scale, num_rows)
    if dtype == DataType.STRING:
        return _cast_to_string(v, num_rows)

    d = v.data
    if v.dtype == DataType.DECIMAL:
        return _cast_from_decimal(v, dtype, precision, scale)
    if dtype == DataType.DECIMAL:
        return _cast_to_decimal(v, precision, scale)
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

    if dtype in (DataType.FLOAT32, DataType.FLOAT64):
        return TypedValue(PrimitiveColumn(d.to(dtype.to_torch()), validity),
                          dtype)

    if dtype == DataType.DATE32:
        if v.dtype == DataType.TIMESTAMP_US:
            days = torch.div(d, US_PER_DAY, rounding_mode="floor")
            return TypedValue(PrimitiveColumn(days.to(torch.int32),
                                              validity), DataType.DATE32)
        return TypedValue(PrimitiveColumn(d.to(torch.int32), validity),
                          DataType.DATE32)

    if dtype == DataType.TIMESTAMP_US:
        if v.dtype == DataType.DATE32:
            us = d.to(torch.int64) * US_PER_DAY
            return TypedValue(PrimitiveColumn(us, validity),
                              DataType.TIMESTAMP_US)
        return TypedValue(PrimitiveColumn(d.to(torch.int64), validity),
                          DataType.TIMESTAMP_US)

    raise NotImplementedError(f"cast {v.dtype.value} -> {dtype.value}")


def _cast_from_decimal(v: TypedValue, dtype: DataType, precision: int,
                       scale: int) -> TypedValue:
    """A decimal(p <= 18) to a decimal(p <= 18) (HALF_UP rescale,
    overflow → null), to an integer (truncated, narrowing wraps) or, via
    float64, to anything else."""
    d, validity = v.data, v.validity
    if dtype == DataType.DECIMAL:
        ds = scale - v.scale
        limit = 10 ** min(precision, 18)
        if ds >= 0:
            # the overflow check comes BEFORE the multiply, which would
            # otherwise wrap past the bound
            pre_limit = limit // (10 ** ds) if ds <= 18 else 0
            ok = torch.abs(d) < max(pre_limit, 1)
            unscaled = torch.where(ok, d, 0) * (10 ** min(ds, 18))
        else:
            div = 10 ** (-ds)
            q_abs = (torch.abs(d) + div // 2) // div   # HALF_UP
            unscaled = torch.where(d >= 0, q_abs, -q_abs)
            ok = torch.abs(unscaled) < limit
        return TypedValue(PrimitiveColumn(torch.where(ok, unscaled, 0),
                                          validity & ok),
                          DataType.DECIMAL, precision, scale)
    if dtype.is_integer:
        div = 10 ** v.scale
        q = torch.where(d >= 0, d // div, -((-d) // div))
        return TypedValue(PrimitiveColumn(q.to(dtype.to_torch()), validity),
                          dtype)
    f = div_const(d.to(torch.float64), 10.0 ** v.scale)
    return cast_value(TypedValue(PrimitiveColumn(f, validity),
                                 DataType.FLOAT64), dtype, precision, scale)


def _cast_to_decimal(v: TypedValue, precision: int,
                     scale: int) -> TypedValue:
    """A bool, integer or float to a decimal: floats round half to even
    at the scale (``torch.round``, as ``jnp.round``), integers scale up
    exactly; past the precision the row is null. Precision > 18 builds
    limbs."""
    d, validity = v.data, v.validity
    if v.dtype == DataType.BOOL:
        d = d.to(torch.int32)
    if v.dtype.is_floating:
        unscaled = torch.round(d.to(torch.float64) * (10.0 ** scale))
        if precision > 18:
            # the limbs of the float magnitude (a double carries 53 bits;
            # Spark's BigDecimal(double) approximates the same way)
            mag = torch.abs(unscaled)
            ok = mag < float(10 ** precision)
            magc = torch.where(ok, mag, 0.0)
            hi_f = torch.floor(magc / (2.0 ** 64))
            lo_f = magc - hi_f * (2.0 ** 64)
            hi = hi_f.to(torch.int64)
            lo = torch.where(lo_f >= 2.0 ** 63,
                             (lo_f - 2.0 ** 64).to(torch.int64),
                             lo_f.to(torch.int64))
            nh, nl = D.neg128(hi, lo)
            neg = d < 0
            return TypedValue(Decimal128Column(torch.where(neg, nh, hi),
                                               torch.where(neg, nl, lo),
                                               validity & ok),
                              DataType.DECIMAL, precision, scale)
        ok = torch.abs(unscaled) < float(10 ** min(precision, 18))
        return TypedValue(PrimitiveColumn(
            torch.where(ok, unscaled, 0.0).to(torch.int64), validity & ok),
            DataType.DECIMAL, precision, scale)
    if precision > 18:
        hi, lo = D.mul_pow10(*D.from_int64(d.to(torch.int64)), scale)
        ok = D.fits_precision(hi, lo, precision)
        return TypedValue(Decimal128Column(hi, lo, validity & ok),
                          DataType.DECIMAL, precision, scale)
    # bound the integer before the multiply, so the product cannot wrap
    # (the reference multiplies first and checks the wrapped product)
    d = d.to(torch.int64)
    bound = (10 ** min(precision, 18) - 1) // 10 ** scale
    ok = (d <= bound) & (d >= -bound)
    return TypedValue(PrimitiveColumn(torch.where(ok, d, 0) * 10 ** scale,
                                      validity & ok),
                      DataType.DECIMAL, precision, scale)


def _cast_decimal128(v: TypedValue, dtype: DataType, precision: int,
                     scale: int, num_rows: torch.Tensor) -> TypedValue:
    """The casts that touch the limbs: rescales between wide and narrow
    decimals (HALF_UP, overflow → null), to float, to integers (truncated,
    null outside int64) and to string on the host."""
    validity = v.validity
    hi, lo = _limbs_of(v)
    if dtype == DataType.DECIMAL:
        ds = scale - v.scale
        if ds >= 0:
            hi2, lo2 = D.mul_pow10(hi, lo, ds)
        else:
            hi2, lo2 = D.div_pow10_half_up(hi, lo, -ds)
        ok = D.fits_precision(hi2, lo2, precision)
        return _mk_decimal(hi2, lo2, validity & ok, precision, scale)
    if dtype.is_floating:
        f = div_const(D.to_float64(hi, lo), 10.0 ** v.scale)
        return cast_value(TypedValue(PrimitiveColumn(f, validity),
                                     DataType.FLOAT64), dtype)
    if dtype.is_integer:
        qh, ql = D.div_pow10_trunc(hi, lo, v.scale)
        v64, fits = D.to_int64(qh, ql)
        return TypedValue(PrimitiveColumn(v64.to(dtype.to_torch()),
                                          validity & fits), dtype)
    if dtype == DataType.STRING:
        return _wide_decimal_to_string(v, hi, lo, num_rows)
    raise NotImplementedError(f"decimal128 cast to {dtype.value}")


def _wide_decimal_to_string(v: TypedValue, hi, lo,
                            num_rows: torch.Tensor) -> TypedValue:
    """A decimal(p > 18) as plain digits (never scientific), 48 bytes
    wide, on the host."""
    import decimal
    cap, width, scale = v.validity.shape[0], 48, v.scale

    def host_fmt(n, hi_np, lo_np, valid_np):
        chars = np.zeros((cap, width), np.uint8)
        lens = np.zeros(cap, np.int32)
        rows = np.flatnonzero(valid_np[:n])
        ints = D.ints_from_limbs(hi_np[rows], lo_np[rows], valid_np[rows])
        with decimal.localcontext() as dctx:
            dctx.prec = 60
            for i, x in zip(rows, ints):
                b = format(decimal.Decimal(x).scaleb(-scale),
                           "f").encode()[:width]
                chars[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
        return chars, lens

    chars, lens = host_map(host_fmt, [hi, lo, v.validity], num_rows,
                           [(np.uint8, (width,)), (np.int32, ())],
                           v.validity.device)
    return TypedValue(StringColumn(chars, lens, v.validity), DataType.STRING)


def format_float(x, is_f32: bool) -> str:
    """Java's Float/Double.toString as the reference formats it."""
    f = float(x)
    if f != f:
        return "NaN"
    if f == float("inf"):
        return "Infinity"
    if f == float("-inf"):
        return "-Infinity"
    a = abs(f)
    if a != 0 and (a >= 1e7 or a < 1e-3):
        # Java switches to scientific notation outside [1e-3, 1e7):
        # '1.0E30'
        s = np.format_float_scientific(
            np.float32(x) if is_f32 else f, unique=True, trim="0",
            exp_digits=1)
        mant, exp = s.split("e")
        if "." not in mant:
            mant += ".0"
        return f"{mant}E{int(exp)}"
    if f == int(f):
        return f"{f:.1f}"
    if is_f32:
        # shortest round-trip at f32 precision: '0.1', not the widened
        # double '0.10000000149...'
        return np.format_float_positional(np.float32(x), unique=True,
                                          trim="0")
    return repr(f)


def _format_timestamp(x) -> str:
    ts = datetime.datetime(1970, 1, 1) + datetime.timedelta(
        microseconds=int(x))
    s = ts.strftime("%Y-%m-%d %H:%M:%S")
    if ts.microsecond:
        s += f".{ts.microsecond:06d}".rstrip("0")
    return s


def _to_string_format(dtype: DataType, scale: int):
    """(formatter of one value, output width) of a cast to string."""
    if dtype == DataType.DECIMAL:
        import decimal
        return (lambda x: str(decimal.Decimal(int(x)).scaleb(-scale))), 24
    if dtype == DataType.BOOL:
        return (lambda x: str(bool(x)).lower()), 8
    if dtype.is_integer:
        return (lambda x: str(int(x))), 24
    if dtype == DataType.DATE32:
        return (lambda x: (datetime.date(1970, 1, 1) + datetime.timedelta(
            days=int(x))).isoformat()), 16
    if dtype == DataType.TIMESTAMP_US:
        return _format_timestamp, 32
    if dtype.is_floating:
        is_f32 = dtype == DataType.FLOAT32
        return (lambda x: format_float(x, is_f32)), 32
    raise NotImplementedError(f"cast {dtype.value} -> string")


def _cast_to_string(v: TypedValue, num_rows: torch.Tensor) -> TypedValue:
    """Bool, integer, decimal(p <= 18), float, date or timestamp →
    string on the host."""
    fmt, width = _to_string_format(v.dtype, v.scale)
    cap = v.validity.shape[0]

    def host_fmt(n, data_np, valid_np):
        chars = np.zeros((cap, width), np.uint8)
        lens = np.zeros(cap, np.int32)
        for i in np.flatnonzero(valid_np[:n]):
            b = fmt(data_np[i]).encode()[:width]
            chars[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        return chars, lens

    chars, lens = host_map(host_fmt, [v.data, v.validity], num_rows,
                           [(np.uint8, (width,)), (np.int32, ())],
                           v.validity.device)
    return TypedValue(StringColumn(chars, lens, v.validity),
                      DataType.STRING)


_BOOL_WORDS = {"true": True, "t": True, "1": True, "yes": True, "y": True,
               "false": False, "f": False, "0": False, "no": False,
               "n": False}

# Spark accepts non-zero-padded fields: yyyy-[m]m-[d]d
# (DateTimeUtils.stringToDate)
_DATE_RE = re.compile(r"^(\d{1,4})-(\d{1,2})-(\d{1,2})$")


def _parse_date(s: str):
    m = _DATE_RE.match(s.strip())
    if not m:
        return None
    try:
        d = datetime.date(int(m.group(1)), int(m.group(2)), int(m.group(3)))
    except ValueError:
        return None
    return (d - datetime.date(1970, 1, 1)).days


def _int_parser(bits: int):
    lo, hi = -(2 ** (bits - 1)), 2 ** (bits - 1) - 1

    def parse(s):
        # Spark UTF8String.toInt/toLong: trimmed, optional sign, digits
        # with an optional '.' + digit fraction that TRUNCATES toward
        # zero ('4.5'→4, '.5'→0); scientific notation ('1e2') stays
        # NULL. Exact int parsing keeps Long.MaxValue-class strings
        # lossless.
        s = s.strip()
        if not s:
            return None
        sign = -1 if s[0] == "-" else 1
        body = s[1:] if s[0] in "+-" else s
        if not (body.isascii() and body.isdigit()):
            intpart, dot, frac = body.partition(".")
            if not dot or not (frac == "" or (frac.isascii()
                                              and frac.isdigit())):
                return None
            if intpart and not (intpart.isascii() and intpart.isdigit()):
                return None
            if not intpart and not frac:
                return None      # bare '.' / '+.'
            body = intpart or "0"
        r = sign * int(body)
        return r if lo <= r <= hi else None

    return parse


def _parse_timestamp(s: str):
    try:
        ts = datetime.datetime.fromisoformat(s.strip())
    except ValueError:
        return None
    if ts.tzinfo is None:
        ts = ts.replace(tzinfo=datetime.timezone.utc)
    else:
        ts = ts.astimezone(datetime.timezone.utc)
    return int(ts.timestamp() * 1e6)


def _parse_float(s: str):
    try:
        return float(s.strip())
    except ValueError:
        return None


def _decimal_parser(precision: int, scale: int):
    """Spark's ``Decimal.changePrecision``: HALF_UP at the scale
    (``cast('1.005' as decimal(10,2))`` is 1.01), null past the
    precision or on a string that is not a number (``'Infinity'``
    parses as a Decimal but has no integer value)."""
    from decimal import ROUND_HALF_UP, Decimal, InvalidOperation

    def parse(s):
        try:
            r = int(Decimal(s.strip()).scaleb(scale)
                    .to_integral_value(rounding=ROUND_HALF_UP))
        except (InvalidOperation, ValueError, OverflowError):
            return None
        if precision and abs(r) >= 10 ** precision:
            return None
        return r

    return parse


def _from_string_parser(dtype: DataType, precision: int, scale: int):
    """(parser of one string, numpy result type) of a cast from string."""
    if dtype == DataType.DECIMAL:
        return _decimal_parser(precision, scale), np.int64
    if dtype == DataType.BOOL:
        return (lambda s: _BOOL_WORDS.get(s.strip().lower())), np.bool_
    if dtype == DataType.DATE32:
        return _parse_date, np.int32
    if dtype.is_integer:
        return _int_parser(_INT_BITS[dtype]), np_dtype(dtype.to_torch())
    if dtype == DataType.TIMESTAMP_US:
        return _parse_timestamp, np.int64
    if dtype.is_floating:
        return _parse_float, np_dtype(dtype.to_torch())
    raise NotImplementedError(f"cast string -> {dtype.value}")


def _cast_from_string(v: TypedValue, dtype: DataType, precision: int,
                      scale: int, safe: bool,
                      num_rows: torch.Tensor) -> TypedValue:
    """String → bool, integer, float, decimal, date or timestamp, parsed
    on the host; an invalid string gives null when ``safe`` (TryCast,
    non-ANSI) and raises when not (ANSI). A decimal parses into int64,
    as in the reference, so a value past the int64 range is null even
    at precision > 18 (whose column is then the limbs of that int64)."""
    col: StringColumn = v.col
    cap = col.capacity
    parse, np_t = _from_string_parser(dtype, precision, scale)

    def host_parse(n, chars_np, lens_np, valid_np):
        data = np.zeros(cap, np_t)
        ok = np.zeros(cap, bool)
        for i in np.flatnonzero(valid_np[:n]):
            s = decode(chars_np, lens_np, i)
            try:
                r = parse(s)
            except (ValueError, OverflowError):
                r = None
            if r is not None:
                try:
                    data[i] = r
                    ok[i] = True
                except (OverflowError, ValueError):
                    # parsed but does not fit the target width → null
                    data[i] = 0
            if not ok[i] and not safe:
                raise ValueError(
                    f"[CAST_INVALID_INPUT] cannot cast {s!r} to "
                    f"{dtype.value} (ANSI mode)")
        return data, ok

    data, ok = host_map(host_parse, [col.chars, col.lens, v.validity],
                        num_rows, [(np_t, ()), (np.bool_, ())],
                        col.chars.device)
    if dtype == DataType.DECIMAL and precision > 18:
        return TypedValue(Decimal128Column(*D.from_int64(data),
                                           v.validity & ok),
                          dtype, precision, scale)
    return TypedValue(PrimitiveColumn(data, v.validity & ok), dtype,
                      precision, scale)
