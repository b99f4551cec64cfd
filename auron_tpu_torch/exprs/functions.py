"""Scalar function registry.

The port of ``auron_tpu.exprs.functions``: the Spark-exact scalar
functions over dates, numbers, nulls, strings and hashes. Each takes its
evaluated ``TypedValue`` arguments and returns a ``TypedValue``, as a few
eager tensor ops on the batch's device. Importing ``fn_strings`` and
``fn_dates`` at the end fills in the rest of the registry. The
reference's array, map and struct functions (ROADMAP item 16f) and its
crypto, json and regex functions (17b) are not registered: a plan that
calls one raises ``NotImplementedError`` naming its item.
"""

from __future__ import annotations

import math

import torch

from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.columnar.batch import (Decimal128Column, PrimitiveColumn,
                                            StringColumn)
from auron_tpu_torch.columnar.schema import DataType, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (US_PER_DAY, TypedValue, cast_value,
                                        div_const, evaluate, infer_dtype,
                                        select_column)
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops import strings as S
from auron_tpu_torch.utils.shapes import bucket_string_width

_REGISTRY = {}
_RESULT_TYPE = {}

#: the reference's names that the port does not register yet, with the
#: ROADMAP item that brings each
LATER = {
    **{name: "16f" for name in (
        "array", "size", "cardinality", "array_contains", "array_position",
        "element_at", "get_map_value", "array_max", "array_min",
        "sort_array", "array_repeat", "map", "create_map",
        "map_from_arrays", "map_keys", "map_values", "map_entries",
        "map_from_entries", "map_contains_key", "map_concat",
        "array_distinct", "array_union", "array_intersect", "array_except",
        "arrays_overlap", "split", "array_join", "str_to_map",
        "named_struct", "struct", "get_struct_field")},
    **{name: "17b" for name in (
        "md5", "sha1", "sha2", "crc32", "base64", "unbase64", "hex",
        "unhex", "get_json_object", "json_array_length", "regexp_extract",
        "regexp_replace", "rlike", "regexp_like", "regexp")},
}


def register(name, result_type=None):
    def deco(fn):
        _REGISTRY[name] = fn
        if result_type is not None:
            _RESULT_TYPE[name] = result_type
        return fn
    return deco


def _later(name: str) -> NotImplementedError:
    return NotImplementedError(
        f"scalar function {name!r} (ROADMAP item {LATER[name]})")


def dispatch_function(expr: ir.ScalarFunction, batch, schema,
                      ctx) -> TypedValue:
    fn = _REGISTRY.get(expr.name)
    if fn is None:
        if expr.name in LATER:
            raise _later(expr.name)
        raise NotImplementedError(f"scalar function {expr.name!r}")
    args = [evaluate(a, batch, schema, ctx) for a in expr.args]
    return fn(args, expr, batch, schema, ctx)


def function_result_type(expr: ir.ScalarFunction, schema: Schema):
    if expr.dtype is not None:
        return expr.dtype, expr.precision, expr.scale
    if expr.name not in _REGISTRY and expr.name in LATER:
        raise _later(expr.name)
    rt = _RESULT_TYPE.get(expr.name)
    if rt is None:
        # default: same as first arg
        return infer_dtype(expr.args[0], schema)
    if callable(rt):
        return rt(expr, schema)
    return rt, 0, 0


def fdiv(a, b):
    """Floor division (``jnp.floor_divide``)."""
    return torch.div(a, b, rounding_mode="floor")


def prim(data, validity, dtype: DataType) -> TypedValue:
    return TypedValue(PrimitiveColumn(data, validity), dtype)


def literal_arg(expr: ir.ScalarFunction, k: int, default=None):
    """The value of argument ``k``, which must be a literal, or
    ``default`` when absent."""
    if k >= len(expr.args):
        return default
    a = expr.args[k]
    if not isinstance(a, ir.Literal):
        raise NotImplementedError(
            f"{expr.name}: argument {k} must be a literal")
    return a.value


# ---------------------------------------------------------------------------
# date/time (civil-from-days, Hinnant algorithm — pure integer ops)
# ---------------------------------------------------------------------------

def civil_from_days(days):
    """days since 1970-01-01 → (year, month, day), int32."""
    z = days.to(torch.int32) + 719468
    era = fdiv(z, 146097)
    doe = z - era * 146097
    yoe = fdiv(doe - fdiv(doe, 1460) + fdiv(doe, 36524)
               - fdiv(doe, 146096), 365)
    y = yoe + era * 400
    doy = doe - (365 * yoe + fdiv(yoe, 4) - fdiv(yoe, 100))
    mp = fdiv(5 * doy + 2, 153)
    d = doy - fdiv(153 * mp + 2, 5) + 1
    m = mp + torch.where(mp < 10, 3, -9)
    year = y + (m <= 2).to(y.dtype)
    return year.to(torch.int32), m.to(torch.int32), d.to(torch.int32)


def days_from_civil(y, m, d):
    y = y - (m <= 2).to(y.dtype)
    era = fdiv(y, 400)
    yoe = y - era * 400
    mp = torch.remainder(m + 9, 12)
    doy = fdiv(153 * mp + 2, 5) + d - 1
    doe = yoe * 365 + fdiv(yoe, 4) - fdiv(yoe, 100) + doy
    return era * 146097 + doe - 719468


def days_arg(v: TypedValue):
    if v.dtype == DataType.TIMESTAMP_US:
        return fdiv(v.data, US_PER_DAY).to(torch.int32)
    return v.data.to(torch.int32)


@register("year", DataType.INT32)
def _year(args, expr, batch, schema, ctx):
    y, _, _ = civil_from_days(days_arg(args[0]))
    return prim(y, args[0].validity, DataType.INT32)


@register("month", DataType.INT32)
def _month(args, expr, batch, schema, ctx):
    _, m, _ = civil_from_days(days_arg(args[0]))
    return prim(m, args[0].validity, DataType.INT32)


@register("day", DataType.INT32)
@register("dayofmonth", DataType.INT32)
def _day(args, expr, batch, schema, ctx):
    _, _, d = civil_from_days(days_arg(args[0]))
    return prim(d, args[0].validity, DataType.INT32)


@register("quarter", DataType.INT32)
def _quarter(args, expr, batch, schema, ctx):
    _, m, _ = civil_from_days(days_arg(args[0]))
    return prim(fdiv(m - 1, 3) + 1, args[0].validity, DataType.INT32)


@register("dayofweek", DataType.INT32)
def _dayofweek(args, expr, batch, schema, ctx):
    # Spark: 1 = Sunday. 1970-01-01 was a Thursday (=5).
    dow = torch.remainder(days_arg(args[0]) + 4, 7) + 1
    return prim(dow.to(torch.int32), args[0].validity, DataType.INT32)


@register("dayofyear", DataType.INT32)
def _dayofyear(args, expr, batch, schema, ctx):
    days = days_arg(args[0])
    y, _, _ = civil_from_days(days)
    jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
    return prim((days - jan1 + 1).to(torch.int32), args[0].validity,
                 DataType.INT32)


def _two_dates(args, k: int, dtype: DataType) -> TypedValue:
    """args[0] + k * args[1] in int32 days."""
    d = args[0].data.to(torch.int32) + k * args[1].data.to(torch.int32)
    return prim(d, args[0].validity & args[1].validity, dtype)


@register("date_add", DataType.DATE32)
def _date_add(args, expr, batch, schema, ctx):
    return _two_dates(args, 1, DataType.DATE32)


@register("date_sub", DataType.DATE32)
def _date_sub(args, expr, batch, schema, ctx):
    return _two_dates(args, -1, DataType.DATE32)


@register("datediff", DataType.INT32)
def _datediff(args, expr, batch, schema, ctx):
    return _two_dates(args, -1, DataType.INT32)


# ---------------------------------------------------------------------------
# math
# ---------------------------------------------------------------------------

def float_to_int64(x):
    """float → int64 as XLA converts: NaN → 0, out of range saturates."""
    top = x >= 2.0 ** 63
    bottom = x <= -(2.0 ** 63)
    bad = torch.isnan(x) | top | bottom
    out = torch.where(bad, 0.0, x).to(torch.int64)
    out = out.masked_fill(top, torch.iinfo(torch.int64).max)
    return out.masked_fill(bottom, torch.iinfo(torch.int64).min)


@register("abs")
def _abs(args, expr, batch, schema, ctx):
    v = args[0]
    if isinstance(v.col, Decimal128Column):
        return TypedValue(Decimal128Column(*D.abs128(v.col.hi, v.col.lo),
                                           v.validity),
                          v.dtype, v.precision, v.scale)
    return TypedValue(PrimitiveColumn(torch.abs(v.data), v.validity),
                      v.dtype, v.precision, v.scale)


@register("sqrt", DataType.FLOAT64)
def _sqrt(args, expr, batch, schema, ctx):
    v = cast_value(args[0], DataType.FLOAT64)
    return prim(sqrt(v.data), v.validity, DataType.FLOAT64)


def _rounding(args, fn) -> TypedValue:
    v = args[0]
    data = v.data.to(torch.int64) if v.dtype.is_integer \
        else float_to_int64(fn(v.data))
    return prim(data, v.validity, DataType.INT64)


@register("floor", DataType.INT64)
def _floor(args, expr, batch, schema, ctx):
    return _rounding(args, torch.floor)


@register("ceil", DataType.INT64)
def _ceil(args, expr, batch, schema, ctx):
    return _rounding(args, torch.ceil)


def sign(x):
    """``jnp.sign``: ±0 and NaN map to themselves (``torch.sign`` maps
    both to +0)."""
    return torch.where((x == 0) | torch.isnan(x), x, torch.sign(x))


def _round_half_up(x, digits: int):
    factor = 10.0 ** digits
    scaled = x * factor
    # Spark ROUND = HALF_UP (away from zero on .5)
    return div_const(sign(scaled) * torch.floor(torch.abs(scaled) + 0.5),
                     factor)


def _round_digits(expr):
    """Static digits argument of round/bround, read from the expression
    (Spark requires a foldable scale). A typed-NULL scale returns None
    (round(x, NULL) is NULL in Spark, not an error)."""
    if len(expr.args) <= 1:
        return 0
    a = expr.args[1]
    if not isinstance(a, ir.Literal):
        raise NotImplementedError(
            f"{expr.name}: the scale argument must be a literal")
    return None if a.value is None else int(a.value)


def _round_decimal(v: TypedValue, digits: int,
                   half_even: bool) -> TypedValue:
    """A decimal rounded to ``digits`` places: its unscaled value divided
    by 10^(scale - digits), HALF_UP or HALF_EVEN, at scale ``digits``
    and the input's precision; fewer places than ``digits`` stay as
    they are."""
    shift = v.scale - digits
    if shift <= 0:
        return v
    if not isinstance(v.col, Decimal128Column) and not half_even:
        p = 10 ** shift
        d = v.data
        rounded = torch.sign(d) * ((torch.abs(d) + p // 2) // p)
        return TypedValue(PrimitiveColumn(rounded, v.validity),
                          DataType.DECIMAL, v.precision, digits)
    h, l = (v.col.hi, v.col.lo) if isinstance(v.col, Decimal128Column)         else D.from_int64(v.data)
    if not half_even:
        qh, ql = D.div_pow10_half_up(h, l, shift)
    else:
        # |q| = |v| // 10^shift; the remainder against half of 10^shift
        # decides, and a tie goes to the even quotient
        ah, al = D.abs128(h, l)
        qh, ql = D.div_pow10_trunc(ah, al, shift)
        rh, rl = D.sub128(ah, al, *D.mul_pow10(qh, ql, shift))
        th, tl = D.int_limbs(5 * 10 ** (shift - 1))
        lt, eq = D.cmp128(rh, rl, th, tl)
        up = (~lt & ~eq) | (eq & ((ql & 1) == 1))
        qh, ql = D.add128(qh, ql, torch.zeros_like(qh), up.to(torch.int64))
        nh, nl = D.neg128(qh, ql)
        neg = h < 0
        qh, ql = torch.where(neg, nh, qh), torch.where(neg, nl, ql)
    if isinstance(v.col, Decimal128Column):
        return TypedValue(Decimal128Column(qh, ql, v.validity),
                          DataType.DECIMAL, v.precision, digits)
    return TypedValue(PrimitiveColumn(ql, v.validity), DataType.DECIMAL,
                      v.precision, digits)


def _rounded_type(expr: ir.ScalarFunction, schema: Schema):
    """The argument's type; a decimal rounded to fewer places than its
    scale takes ``digits`` as its scale, as ``_round_decimal`` gives."""
    dt, p, s = infer_dtype(expr.args[0], schema)
    digits = _round_digits(expr)
    if dt == DataType.DECIMAL and digits is not None and digits < s:
        return dt, p, digits
    return dt, p, s


def _rounded(args, expr, fn, half_even: bool) -> TypedValue:
    v = args[0]
    digits = _round_digits(expr)
    if digits is None:
        return TypedValue(v.col.with_validity(torch.zeros_like(v.validity)),
                          v.dtype, v.precision, v.scale)
    if v.dtype == DataType.DECIMAL:
        return _round_decimal(v, digits, half_even)
    if v.dtype.is_integer:
        return v
    return prim(fn(v.data, digits), v.validity, v.dtype)


@register("round", _rounded_type)
def _round(args, expr, batch, schema, ctx):
    """Spark round: HALF_UP."""
    return _rounded(args, expr, _round_half_up, half_even=False)


@register("bround", _rounded_type)
def _bround(args, expr, batch, schema, ctx):
    """Spark bround: HALF_EVEN (banker's rounding; ``torch.round`` rounds
    half to even)."""
    return _rounded(args, expr, lambda x, digits: div_const(
        torch.round(x * 10.0 ** digits), 10.0 ** digits), half_even=True)


def _f64_pair(args):
    a = cast_value(args[0], DataType.FLOAT64)
    b = cast_value(args[1], DataType.FLOAT64)
    return a.data, b.data, a.validity & b.validity


@register("pow", DataType.FLOAT64)
@register("power", DataType.FLOAT64)
def _pow(args, expr, batch, schema, ctx):
    a, b, valid = _f64_pair(args)
    return prim(torch.pow(a, b), valid, DataType.FLOAT64)


@register("exp", DataType.FLOAT64)
def _exp(args, expr, batch, schema, ctx):
    v = cast_value(args[0], DataType.FLOAT64)
    return prim(torch.exp(v.data), v.validity, DataType.FLOAT64)


@register("log", DataType.FLOAT64)
@register("ln", DataType.FLOAT64)
def _log(args, expr, batch, schema, ctx):
    v = cast_value(args[0], DataType.FLOAT64)
    ok = v.data > 0
    return prim(torch.log(torch.where(ok, v.data, 1.0)), v.validity & ok,
                 DataType.FLOAT64)


@register("isnan", DataType.BOOL)
def _isnan(args, expr, batch, schema, ctx):
    v = args[0]
    ones = torch.ones_like(v.validity)
    if not v.dtype.is_floating:
        return prim(torch.zeros_like(v.validity), ones, DataType.BOOL)
    return prim(torch.isnan(v.data) & v.validity, ones, DataType.BOOL)


@register("nanvl")
def _nanvl(args, expr, batch, schema, ctx):
    a, b = args
    take_b = torch.isnan(a.data)
    return prim(torch.where(take_b, b.data, a.data),
                 torch.where(take_b, b.validity, a.validity), a.dtype)


@register("normalize_nan_and_zero")
def _normalize(args, expr, batch, schema, ctx):
    """Canonical NaN, -0.0 → 0.0."""
    v = args[0]
    d = torch.where(torch.isnan(v.data), math.nan, v.data)
    d = torch.where(d == 0.0, 0.0, d)
    return prim(d.to(v.data.dtype), v.validity, v.dtype)


def _nan_gt(a, b):
    """Spark ordering '>': NaN is the greatest value (a != a means NaN;
    no-op for ints)."""
    return (a > b) | ((a != a) & (b == b))


def _pick(args, first_wins) -> TypedValue:
    out = args[0]
    for v in args[1:]:
        take = (~out.validity) | (v.validity & first_wins(v.data, out.data))
        out = TypedValue(
            PrimitiveColumn(torch.where(take, v.data, out.data),
                            out.validity | v.validity),
            out.dtype, out.precision, out.scale)
    return out


@register("greatest")
def _greatest(args, expr, batch, schema, ctx):
    return _pick(args, _nan_gt)


@register("least")
def _least(args, expr, batch, schema, ctx):
    return _pick(args, lambda v, o: _nan_gt(o, v))


def cbrt(x):
    """XLA's cube root: |x| ** (1/3) with x's sign (so 64 gives
    3.9999999999999996, as in the reference)."""
    return torch.copysign(torch.pow(torch.abs(x), 1.0 / 3.0), x)


def _split(a):
    """Veltkamp's split of a float64 into two 26-bit halves."""
    c = 134217729.0 * a
    hi = c - (c - a)
    return hi, a - hi


def sqrt(x):
    """The correctly rounded square root, as XLA's and CUDA's are:
    ``torch.sqrt`` on the CPU is off by one unit in the last place for
    some inputs (sqrt(32) gives 5.65685424949238), so the root moves one
    step up or down where x - r² (Dekker's exact square) says the true
    root lies past the midpoint."""
    r = torch.sqrt(x)
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    dn = torch.nextafter(r, torch.zeros_like(r))
    rh, rl = _split(r)
    p = r * r
    res = (x - p) - (((rh * rh - p) + 2.0 * rh * rl) + rl * rl)
    u_up, u_dn = up - r, r - dn
    ok = torch.isfinite(r) & (r > 0)
    go_up = ok & (res > r * u_up + 0.25 * u_up * u_up)
    go_dn = ok & (-res > r * u_dn - 0.25 * u_dn * u_dn)
    return torch.where(go_up, up, torch.where(go_dn, dn, r))


_LOG_HALF = math.log(0.5)


def sinh(x):
    """XLA's sinh: (e^x - e^-x) / 2 as exp(x + log ½) - exp(-x + log ½),
    and through expm1 where |x| < 1 (``torch.sinh`` differs from the
    reference's by up to 16 units in the last place)."""
    em = torch.expm1(x)
    small = 0.5 * (em + em / (em + 1.0))
    large = torch.exp(x + _LOG_HALF) - torch.exp(-x + _LOG_HALF)
    return torch.where(torch.abs(x) < 1.0, small, large)


def cosh(x):
    """XLA's cosh: max(exp(x + log ½) + exp(-x + log ½), 1)."""
    return torch.clamp(torch.exp(x + _LOG_HALF) + torch.exp(-x + _LOG_HALF),
                       min=1.0)


_UNARY_F64 = {
    "sin": torch.sin, "cos": torch.cos, "tan": torch.tan,
    "asin": torch.asin, "acos": torch.acos, "atan": torch.atan,
    "sinh": sinh, "cosh": cosh, "tanh": torch.tanh,
    "log10": torch.log10, "log2": torch.log2, "log1p": torch.log1p,
    "expm1": torch.expm1, "cbrt": cbrt,
    # jnp.degrees / radians multiply by the rounded constant
    "degrees": lambda x: x * (180.0 / math.pi),
    "radians": lambda x: x * (math.pi / 180.0),
    "rint": torch.round,
}


def _register_unary_f64():
    for fname, tfn in _UNARY_F64.items():
        def make(tf):
            def impl(args, expr, batch, schema, ctx):
                v = cast_value(args[0], DataType.FLOAT64)
                return prim(tf(v.data), v.validity, DataType.FLOAT64)
            return impl
        register(fname, DataType.FLOAT64)(make(tfn))


_register_unary_f64()


@register("signum", DataType.FLOAT64)
@register("sign", DataType.FLOAT64)
def _signum(args, expr, batch, schema, ctx):
    v = cast_value(args[0], DataType.FLOAT64)
    return prim(sign(v.data), v.validity, DataType.FLOAT64)


@register("atan2", DataType.FLOAT64)
def _atan2(args, expr, batch, schema, ctx):
    a, b, valid = _f64_pair(args)
    return prim(torch.atan2(a, b), valid, DataType.FLOAT64)


@register("hypot", DataType.FLOAT64)
def _hypot(args, expr, batch, schema, ctx):
    a, b, valid = _f64_pair(args)
    return prim(torch.hypot(a, b), valid, DataType.FLOAT64)


def _constant(value: float, batch) -> TypedValue:
    return prim(torch.full((batch.capacity,), value, dtype=torch.float64,
                            device=batch.device),
                 torch.ones(batch.capacity, dtype=torch.bool,
                            device=batch.device), DataType.FLOAT64)


@register("pi", DataType.FLOAT64)
def _pi(args, expr, batch, schema, ctx):
    return _constant(math.pi, batch)


@register("e", DataType.FLOAT64)
def _e(args, expr, batch, schema, ctx):
    return _constant(math.e, batch)


def _pmod_result(expr, schema):
    lt, _, _ = infer_dtype(expr.args[0], schema)
    rt, _, _ = infer_dtype(expr.args[1], schema)
    if lt.is_floating or rt.is_floating:
        return DataType.FLOAT64, 0, 0
    return DataType.INT64, 0, 0


@register("pmod", _pmod_result)
def _pmod(args, expr, batch, schema, ctx):
    """Spark pmod(a, n) = ((a % n) + n) % n with Java remainder, which
    is floor-mod (``torch.remainder``) for every sign combination. Null
    on a zero divisor."""
    a, b = args
    target = DataType.FLOAT64 if (a.dtype.is_floating
                                  or b.dtype.is_floating) else DataType.INT64
    av = cast_value(a, target)
    bv = cast_value(b, target)
    nz = bv.data != 0
    r = torch.remainder(av.data, torch.where(nz, bv.data, 1))
    return prim(r, av.validity & bv.validity & nz, target)


_FACTORIALS = [math.factorial(i) for i in range(21)]


@register("factorial", DataType.INT64)
def _factorial(args, expr, batch, schema, ctx):
    """Spark factorial: defined for 0..20, null outside."""
    table = torch.tensor(_FACTORIALS, dtype=torch.int64,
                         device=batch.device)
    v = cast_value(args[0], DataType.INT64)
    ok = (v.data >= 0) & (v.data <= 20)
    return prim(table[v.data.clamp(0, 20)], v.validity & ok,
                 DataType.INT64)


# ---------------------------------------------------------------------------
# conditional / null
# ---------------------------------------------------------------------------

@register("coalesce")
def _coalesce(args, expr, batch, schema, ctx):
    out = args[0]
    for v in args[1:]:
        col = select_column(~out.validity, v.col, out.col,
                            out.validity | v.validity)
        out = TypedValue(col, out.dtype, out.precision, out.scale)
    return out


@register("nullif")
@register("null_if")
def _nullif(args, expr, batch, schema, ctx):
    a, b = args
    if isinstance(a.col, StringColumn):
        _, eq = S.compare(a.col.chars, a.col.lens, b.col.chars, b.col.lens)
    else:
        eq = a.data == b.data
    eq = eq & a.validity & b.validity
    return TypedValue(a.col.with_validity(a.validity & ~eq),
                      a.dtype, a.precision, a.scale)


def _if_result(expr, schema):
    # the result type is the THEN branch's (args[1]), not the condition's
    return infer_dtype(expr.args[1], schema)


@register("if", _if_result)
def _if(args, expr, batch, schema, ctx):
    c, t, f = args
    take = c.data.bool() & c.validity
    col = select_column(take, t.col, f.col,
                        torch.where(take, t.validity, f.validity))
    return TypedValue(col, t.dtype, t.precision, t.scale)


# ---------------------------------------------------------------------------
# strings
# ---------------------------------------------------------------------------

def string_result(expr, schema):
    return DataType.STRING, 0, 0


@register("length", DataType.INT32)
@register("char_length", DataType.INT32)
def _length(args, expr, batch, schema, ctx):
    """Characters, not bytes: the UTF-8 continuation bytes (0b10xxxxxx)
    below the length are not counted."""
    c = args[0].col
    cont = ((c.chars & 0xC0) == 0x80) & (
        S.positions(c.width, c.chars.device) < c.lens[:, None])
    return prim(c.lens - cont.sum(dim=1).to(torch.int32),
                 args[0].validity, DataType.INT32)


@register("upper", string_result)
def _upper(args, expr, batch, schema, ctx):
    return TypedValue(S.upper(args[0].col), DataType.STRING)


@register("lower", string_result)
def _lower(args, expr, batch, schema, ctx):
    return TypedValue(S.lower(args[0].col), DataType.STRING)


@register("trim", string_result)
def _trim(args, expr, batch, schema, ctx):
    return TypedValue(S.trim(args[0].col), DataType.STRING)


@register("ltrim", string_result)
def _ltrim(args, expr, batch, schema, ctx):
    return TypedValue(S.trim(args[0].col, right=False), DataType.STRING)


@register("rtrim", string_result)
def _rtrim(args, expr, batch, schema, ctx):
    return TypedValue(S.trim(args[0].col, left=False), DataType.STRING)


@register("substring", string_result)
@register("substr", string_result)
def _substring(args, expr, batch, schema, ctx):
    start = args[1].data.to(torch.int32)
    length = args[2].data.to(torch.int32) if len(args) > 2 \
        else torch.full_like(start, 2 ** 30)
    return TypedValue(S.substring(args[0].col, start, length),
                      DataType.STRING)


@register("concat", string_result)
def _concat(args, expr, batch, schema, ctx):
    cols = [a.col for a in args]
    out_w = bucket_string_width(sum(c.width for c in cols))
    return TypedValue(S.concat(cols, out_w), DataType.STRING)


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

@register("hash", DataType.INT32)
@register("murmur3_hash", DataType.INT32)
def _hash(args, expr, batch, schema, ctx):
    h = hashing.murmur3_columns([a.col for a in args], batch.capacity, 42,
                                device=batch.device)
    return prim(h, torch.ones(batch.capacity, dtype=torch.bool,
                               device=batch.device), DataType.INT32)


@register("xxhash64", DataType.INT64)
def _xxhash64(args, expr, batch, schema, ctx):
    h = hashing.xxhash64_columns([a.col for a in args], batch.capacity, 42,
                                 device=batch.device)
    return prim(h, torch.ones(batch.capacity, dtype=torch.bool,
                               device=batch.device), DataType.INT64)


# importing these modules fills in the rest of the registry
from auron_tpu_torch.exprs import fn_dates    # noqa: E402,F401
from auron_tpu_torch.exprs import fn_strings  # noqa: E402,F401
