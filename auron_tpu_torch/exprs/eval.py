"""Expression evaluation on device batches.

The port of ``auron_tpu.exprs.eval`` for the nodes in ``exprs/ir.py``:
column references, literals (a string literal as a broadcast padded
row), binary arithmetic and comparisons with numeric promotion, the six
comparisons of two strings in byte order, ``IN`` lists, Kleene
``and``/``or``, ``not``, ``is null``, ``is not null``, negation,
``CASE WHEN`` (string branches padded to the widest), ``LIKE`` and the
three string predicates, the scalar functions of ``exprs/functions.py``,
``split(...)[i]`` and Spark's (non-ANSI) cast matrix over bool, integer,
float, date, timestamp and string. Null semantics follow Spark/SQL:
arithmetic and comparisons propagate null, ``x / 0`` and ``x % 0`` are
null, ``and``/``or`` are three-valued, and a cast that fails gives null
(or raises, for an ANSI cast from a string). Decimals (ROADMAP item
16d), nested columns (16f) and the nodes of item 17b raise
``NotImplementedError`` naming their item.

Each node becomes a few elementwise tensor ops on the batch's device.
Four things run on the host, as the reference's ``jax.pure_callback``
does: the general ``LIKE`` regex, casts to and from strings,
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

from auron_tpu_torch.columnar.batch import (Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn,
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

#: field types ``null_column_for_field`` pads with a primitive column
_PRIMITIVE_FIELDS = frozenset(_RANK) | {DataType.BOOL, DataType.DATE32,
                                        DataType.TIMESTAMP_US, DataType.NULL}

_COMPARE = {"==": torch.eq, "!=": torch.ne, "<": torch.lt,
            "<=": torch.le, ">": torch.gt, ">=": torch.ge}

US_PER_DAY = 86_400_000_000


def div_const(x: torch.Tensor, c) -> torch.Tensor:
    """``x / c`` for a constant divisor ``c`` (a number, or a one-element
    tensor): a multiplication by ``1 / c``, as XLA compiles it."""
    return x * (torch.reciprocal(c) if torch.is_tensor(c) else 1.0 / c)


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
        _ones(capacity, device))


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

    if isinstance(expr, ir.Literal):
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
        raise NotImplementedError(
            "GetIndexedField over a list column: the port carries no "
            "list columns (ROADMAP item 16f)")

    raise NotImplementedError(f"expression {type(expr).__name__}")


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
        lt = infer_dtype(expr.left, schema)[0]
        rt = infer_dtype(expr.right, schema)[0]
        if lt == DataType.DECIMAL and rt == DataType.DECIMAL:
            raise NotImplementedError(
                "infer_dtype for decimal arithmetic (ROADMAP item 16d)")
        return common_type(lt, rt), 0, 0
    if isinstance(expr, (ir.Not, ir.IsNull, ir.IsNotNull, ir.InList,
                         ir.Like, ir.StringStartsWith, ir.StringEndsWith,
                         ir.StringContains)):
        return DataType.BOOL, 0, 0
    if isinstance(expr, ir.Negative):
        return infer_dtype(expr.child, schema)
    if isinstance(expr, ir.Cast):
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
        raise NotImplementedError(
            "GetIndexedField over a list column (ROADMAP item 16f)")
    raise NotImplementedError(f"infer_dtype for {type(expr).__name__}")


def infer_field(expr: ir.Expr, schema: Schema, name: str = "c") -> Field:
    """Result field of an expression: the input field itself for a
    column reference (its metadata kept), else a nullable field of the
    inferred type. Nested results come with the slices that have them."""
    if isinstance(expr, ir.ColumnRef):
        return schema[expr.index].with_name(name)
    dt, p, s = infer_dtype(expr, schema)
    return Field(name, dt, True, p, s)


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
    if v.dtype == dtype and dtype != DataType.DECIMAL:
        return v
    if DataType.DECIMAL in (v.dtype, dtype):
        raise NotImplementedError(
            f"cast {v.dtype.value} -> {dtype.value} (decimals: ROADMAP "
            "item 16d)")
    if num_rows is None:
        num_rows = _all_rows(v)
    validity = v.validity

    if isinstance(v.col, StringColumn):
        return _cast_from_string(v, dtype, safe, num_rows)
    if dtype == DataType.STRING:
        return _cast_to_string(v, num_rows)

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


def _to_string_format(dtype: DataType):
    """(formatter of one value, output width) of a cast to string."""
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
    """Bool, integer, float, date or timestamp → string on the host."""
    fmt, width = _to_string_format(v.dtype)
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


def _from_string_parser(dtype: DataType):
    """(parser of one string, numpy result type) of a cast from string."""
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


def _cast_from_string(v: TypedValue, dtype: DataType, safe: bool,
                      num_rows: torch.Tensor) -> TypedValue:
    """String → bool, integer, float, date or timestamp, parsed on the
    host; an invalid string gives null when ``safe`` (TryCast, non-ANSI)
    and raises when not (ANSI)."""
    col: StringColumn = v.col
    cap = col.capacity
    parse, np_t = _from_string_parser(dtype)

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
    return TypedValue(PrimitiveColumn(data, v.validity & ok), dtype)
