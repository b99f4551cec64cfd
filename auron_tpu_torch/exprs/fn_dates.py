"""Spark date/time functions as device tensor ops.

The port of ``auron_tpu.exprs.fn_dates``: every function is Hinnant
civil-calendar integer arithmetic over whole columns (the
``civil_from_days`` / ``days_from_civil`` pair of exprs/functions.py),
with floor division and floor modulo, so dates before 1970 come out
right. ``date_format`` and ``from_unixtime`` build fixed-width digit
segments on the device (``format_timestamp``); parsing a string with a
format (``unix_timestamp(str, fmt)``, ``to_date(str, fmt)``) runs on the
host (``exprs/host.py``). Formats use Java SimpleDateFormat tokens
(yyyy, MM, dd, HH, mm, ss) as Spark does.

Registered into the shared scalar-function registry (exprs/functions.py).
"""

from __future__ import annotations

import datetime

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import PrimitiveColumn, StringColumn
from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (US_PER_DAY, TypedValue, cast_value,
                                        div_const)
from auron_tpu_torch.exprs.functions import (civil_from_days, days_arg,
                                             days_from_civil, fdiv,
                                             literal_arg, prim, register,
                                             string_result)
from auron_tpu_torch.exprs.host import decode, host_map

US_PER_HOUR = 3_600_000_000
US_PER_MIN = 60_000_000
US_PER_SEC = 1_000_000


def _ts_us(v: TypedValue):
    """Any date/timestamp input → microseconds since epoch (int64)."""
    if v.dtype == DataType.TIMESTAMP_US:
        return v.data.to(torch.int64)
    return v.data.to(torch.int64) * US_PER_DAY


def _time_of_day_us(ts):
    return torch.remainder(ts, US_PER_DAY)  # floor-mod: right before 1970


@register("hour", DataType.INT32)
def _hour(args, expr, batch, schema, ctx):
    t = _time_of_day_us(_ts_us(args[0]))
    return prim(fdiv(t, US_PER_HOUR).to(torch.int32), args[0].validity,
                 DataType.INT32)


@register("minute", DataType.INT32)
def _minute(args, expr, batch, schema, ctx):
    t = _time_of_day_us(_ts_us(args[0]))
    return prim(torch.remainder(fdiv(t, US_PER_MIN), 60).to(torch.int32),
                 args[0].validity, DataType.INT32)


@register("second", DataType.INT32)
def _second(args, expr, batch, schema, ctx):
    t = _time_of_day_us(_ts_us(args[0]))
    return prim(torch.remainder(fdiv(t, US_PER_SEC), 60).to(torch.int32),
                 args[0].validity, DataType.INT32)


# ---------------------------------------------------------------------------
# date_format / from_unixtime / unix_timestamp / to_date
# ---------------------------------------------------------------------------

_TOKENS = ["yyyy", "yy", "MM", "dd", "HH", "hh", "mm", "ss", "SSS"]


def _tokenize(fmt: str):
    """Format string → list of ('tok', name) | ('lit', bytes)."""
    out, i = [], 0
    while i < len(fmt):
        for t in _TOKENS:
            if fmt.startswith(t, i):
                out.append(("tok", t))
                i += len(t)
                break
        else:
            if fmt[i] == "'":
                j = fmt.find("'", i + 1)
                j = len(fmt) if j < 0 else j
                out.append(("lit", fmt[i + 1:j].encode() or b"'"))
                i = j + 1
            else:
                out.append(("lit", fmt[i].encode()))
                i += 1
    return out


def _digits(x, ndig: int):
    """int tensor → uint8 [n, ndig] ASCII digits, zero-padded (floor
    division and modulo, as the reference's)."""
    cols = [(torch.remainder(fdiv(x, 10 ** k), 10) + ord("0"))
            .to(torch.uint8) for k in range(ndig - 1, -1, -1)]
    return torch.stack(cols, dim=1)


def format_timestamp(ts, fmt: str):
    """Device timestamp formatting → (chars, lens)."""
    days = fdiv(ts, US_PER_DAY)
    tod = torch.remainder(ts, US_PER_DAY)
    y, mo, d = civil_from_days(days)
    vals = {
        "yyyy": (y, 4), "yy": (torch.remainder(y, 100), 2),
        "MM": (mo, 2), "dd": (d, 2),
        "HH": (fdiv(tod, US_PER_HOUR).to(torch.int32), 2),
        "hh": ((torch.remainder(fdiv(tod, US_PER_HOUR) + 11, 12) + 1)
               .to(torch.int32), 2),
        "mm": (torch.remainder(fdiv(tod, US_PER_MIN), 60).to(torch.int32),
               2),
        "ss": (torch.remainder(fdiv(tod, US_PER_SEC), 60).to(torch.int32),
               2),
        "SSS": (torch.remainder(fdiv(tod, 1000), 1000).to(torch.int32), 3),
    }
    n = ts.shape[0]
    segs = []
    for kind, tok in _tokenize(fmt):
        if kind == "lit":
            lit = torch.tensor(list(tok), dtype=torch.uint8, device=ts.device)
            segs.append(lit[None, :].expand(n, len(tok)))
        else:
            x, nd = vals[tok]
            segs.append(_digits(x, nd))
    chars = torch.cat(segs, dim=1) if segs else \
        torch.zeros((n, 1), dtype=torch.uint8, device=ts.device)
    return chars, torch.full((n,), chars.shape[1], dtype=torch.int32,
                             device=ts.device)


@register("date_format", string_result)
def _date_format(args, expr, batch, schema, ctx):
    fmt = str(literal_arg(expr, 1, "yyyy-MM-dd HH:mm:ss"))
    chars, lens = format_timestamp(_ts_us(args[0]), fmt)
    return TypedValue(StringColumn(chars, lens, args[0].validity),
                      DataType.STRING)


@register("from_unixtime", string_result)
def _from_unixtime(args, expr, batch, schema, ctx):
    fmt = str(literal_arg(expr, 1, "yyyy-MM-dd HH:mm:ss"))
    secs = cast_value(args[0], DataType.INT64).data
    chars, lens = format_timestamp(secs * US_PER_SEC, fmt)
    return TypedValue(StringColumn(chars, lens, args[0].validity),
                      DataType.STRING)


def _java_to_strptime(fmt: str) -> str:
    for a, b in [("yyyy", "%Y"), ("yy", "%y"), ("MM", "%m"), ("dd", "%d"),
                 ("HH", "%H"), ("mm", "%M"), ("ss", "%S")]:
        fmt = fmt.replace(a, b)
    return fmt


def host_parse_ts(col: StringColumn, validity, fmt: str, num_rows):
    """string → epoch micros on the host (strptime); invalid → not ok."""
    cap = col.capacity
    py_fmt = _java_to_strptime(fmt)

    def host(n, chars_np, lens_np, valid_np):
        out = np.zeros(cap, np.int64)
        ok = np.zeros(cap, bool)
        for i in np.flatnonzero(valid_np[:n]):
            try:
                dt = datetime.datetime.strptime(
                    decode(chars_np, lens_np, i).strip(), py_fmt)
            except ValueError:
                continue
            dt = dt.replace(tzinfo=datetime.timezone.utc)
            out[i] = int(dt.timestamp() * 1e6)
            ok[i] = True
        return out, ok

    return host_map(host, [col.chars, col.lens, validity], num_rows,
                    [(np.int64, ()), (np.bool_, ())], col.chars.device)


@register("unix_timestamp", DataType.INT64)
@register("to_unix_timestamp", DataType.INT64)
def _unix_timestamp(args, expr, batch, schema, ctx):
    v = args[0]
    if v.dtype == DataType.STRING:
        fmt = str(literal_arg(expr, 1, "yyyy-MM-dd HH:mm:ss"))
        us, ok = host_parse_ts(v.col, v.validity, fmt, batch.num_rows)
        return prim(fdiv(us, US_PER_SEC), v.validity & ok, DataType.INT64)
    return prim(fdiv(_ts_us(v), US_PER_SEC), v.validity, DataType.INT64)


@register("to_date", DataType.DATE32)
def _to_date(args, expr, batch, schema, ctx):
    v = args[0]
    if v.dtype != DataType.STRING:
        return prim(fdiv(_ts_us(v), US_PER_DAY).to(torch.int32), v.validity,
                     DataType.DATE32)
    if len(expr.args) > 1:
        us, ok = host_parse_ts(v.col, v.validity, str(literal_arg(expr, 1)),
                               batch.num_rows)
        return prim(fdiv(us, US_PER_DAY).to(torch.int32), v.validity & ok,
                     DataType.DATE32)
    return cast_value(v, DataType.DATE32, num_rows=batch.num_rows)


# ---------------------------------------------------------------------------
# trunc / date_trunc / month math
# ---------------------------------------------------------------------------

def _null_like(data, validity, dtype: DataType) -> TypedValue:
    """Spark's answer to an unknown unit or day name: null."""
    return prim(torch.zeros_like(data), torch.zeros_like(validity), dtype)


def _truncated_days(days, fmt: str):
    """The first day of ``days``' year, quarter, month or ISO week."""
    if fmt == "week":
        # Monday of the week; 1970-01-01 was Thursday
        return days - torch.remainder(days + 3, 7)
    y, m, _d = civil_from_days(days)
    one = torch.ones_like(y)
    if fmt in ("year", "yyyy", "yy"):
        return days_from_civil(y, one, one)
    if fmt == "quarter":
        return days_from_civil(y, fdiv(m - 1, 3) * 3 + 1, one)
    return days_from_civil(y, m, one)


@register("trunc", DataType.DATE32)
def _trunc(args, expr, batch, schema, ctx):
    """trunc(date, fmt): year/yyyy/yy → Jan 1; month/mon/mm → 1st; week →
    Monday; quarter → quarter start (Spark trunc)."""
    v = args[0]
    fmt = str(literal_arg(expr, 1, "")).lower()
    days = days_arg(v)
    if fmt not in ("year", "yyyy", "yy", "month", "mon", "mm", "quarter",
                   "week"):
        return _null_like(days, v.validity, DataType.DATE32)
    return prim(_truncated_days(days, fmt).to(torch.int32), v.validity,
                 DataType.DATE32)


@register("date_trunc", DataType.TIMESTAMP_US)
def _date_trunc(args, expr, batch, schema, ctx):
    """date_trunc(fmt, ts) → the timestamp truncated to the unit."""
    fmt = str(literal_arg(expr, 0, "")).lower()
    v = args[1]
    ts = _ts_us(v)
    days = fdiv(ts, US_PER_DAY)
    if fmt in ("year", "yyyy", "yy", "month", "mon", "mm", "quarter",
               "week"):
        out = _truncated_days(days, fmt).to(torch.int64) * US_PER_DAY
    elif fmt in ("day", "dd"):
        out = days * US_PER_DAY
    elif fmt == "hour":
        out = ts - torch.remainder(ts, US_PER_HOUR)
    elif fmt == "minute":
        out = ts - torch.remainder(ts, US_PER_MIN)
    elif fmt == "second":
        out = ts - torch.remainder(ts, US_PER_SEC)
    else:
        return _null_like(ts, v.validity, DataType.TIMESTAMP_US)
    return prim(out, v.validity, DataType.TIMESTAMP_US)


def _next_first(y, m):
    """The first day of the month after (y, m)."""
    return days_from_civil(y + (m == 12).to(y.dtype),
                           torch.where(m == 12, 1, m + 1), torch.ones_like(y))


def _month_add(days, n):
    y, m, d = civil_from_days(days)
    m0 = y * 12 + (m - 1) + n
    y2 = fdiv(m0, 12)
    m2 = torch.remainder(m0, 12) + 1
    first = days_from_civil(y2, m2, torch.ones_like(y2))
    dim = _next_first(y2, m2) - first      # days in the target month
    return first + torch.minimum(d, dim) - 1   # Spark clamps to the last


@register("add_months", DataType.DATE32)
def _add_months(args, expr, batch, schema, ctx):
    n = cast_value(args[1], DataType.INT32).data
    out = _month_add(days_arg(args[0]), n)
    return prim(out.to(torch.int32), args[0].validity & args[1].validity,
                 DataType.DATE32)


@register("last_day", DataType.DATE32)
def _last_day(args, expr, batch, schema, ctx):
    y, m, _d = civil_from_days(days_arg(args[0]))
    return prim((_next_first(y, m) - 1).to(torch.int32), args[0].validity,
                 DataType.DATE32)


@register("months_between", DataType.FLOAT64)
def _months_between(args, expr, batch, schema, ctx):
    """Spark months_between: the whole-month difference when both are the
    same day of month or both last days; otherwise a 31-day-month
    fraction including the time of day."""
    ts1, ts2 = _ts_us(args[0]), _ts_us(args[1])
    y1, m1, dd1 = civil_from_days(fdiv(ts1, US_PER_DAY))
    y2, m2, dd2 = civil_from_days(fdiv(ts2, US_PER_DAY))

    def last_dom(y, m, d):
        first = days_from_civil(y, m, torch.ones_like(y))
        return d == (_next_first(y, m) - first)

    months = (y1 - y2) * 12 + (m1 - m2)
    both_last = last_dom(y1, m1, dd1) & last_dom(y2, m2, dd2)
    t1 = torch.remainder(ts1, US_PER_DAY).to(torch.float64)
    t2 = torch.remainder(ts2, US_PER_DAY).to(torch.float64)
    day_frac = div_const(
        (dd1 - dd2).to(torch.float64) * US_PER_DAY + (t1 - t2),
        31.0 * US_PER_DAY)
    frac = torch.where(both_last | (dd1 == dd2), 0.0, day_frac)
    out = months.to(torch.float64) + frac
    roundoff = literal_arg(expr, 2, True) if len(expr.args) > 2 else True
    if roundoff:
        out = div_const(torch.round(out * 1e8), 1e8)
    return prim(out, args[0].validity & args[1].validity, DataType.FLOAT64)


@register("weekofyear", DataType.INT32)
def _weekofyear(args, expr, batch, schema, ctx):
    """ISO-8601 week number."""
    days = days_arg(args[0])
    y, _m, _d = civil_from_days(days)

    def iso_week(days, y):
        jan1 = days_from_civil(y, torch.ones_like(y), torch.ones_like(y))
        ordinal = days - jan1 + 1                       # 1-based day of year
        wd = torch.remainder(days + 3, 7) + 1           # ISO weekday 1=Mon
        return fdiv(ordinal - wd + 10, 7)

    w0 = iso_week(days, y)
    # w0 == 0 → last week of previous year; own-year w0 == 53 rolls to
    # week 1 when the year has no week 53. Dec 28 is ALWAYS in the year's
    # last ISO week, so its week number is the year's week count.
    w_prev = iso_week(days, y - 1)
    dec28 = days_from_civil(y, torch.full_like(y, 12), torch.full_like(y, 28))
    roll = w0 > iso_week(dec28, y)
    w = torch.where(w0 < 1, w_prev, torch.where(roll, 1, w0))
    return prim(w.to(torch.int32), args[0].validity, DataType.INT32)


_DOW = {"mo": 0, "tu": 1, "we": 2, "th": 3, "fr": 4, "sa": 5, "su": 6}


@register("next_day", DataType.DATE32)
def _next_day(args, expr, batch, schema, ctx):
    days = days_arg(args[0])
    dow_s = str(literal_arg(expr, 1, "")).strip().lower()[:2]
    if dow_s not in _DOW:
        return _null_like(days, args[0].validity, DataType.DATE32)
    cur = torch.remainder(days + 3, 7)                # 0 = Monday
    delta = torch.remainder(_DOW[dow_s] - cur + 6, 7) + 1  # strictly after
    return prim((days + delta).to(torch.int32), args[0].validity,
                 DataType.DATE32)


_MONTH_LEN = [31, 28, 31, 30, 31, 30, 31, 31, 30, 31, 30, 31]


@register("make_date", DataType.DATE32)
def _make_date(args, expr, batch, schema, ctx):
    y = cast_value(args[0], DataType.INT32).data
    m = cast_value(args[1], DataType.INT32).data
    d = cast_value(args[2], DataType.INT32).data
    # Spark nulls invalid dates (make_date(2019,2,29) → NULL), it never
    # rolls them over into the next month
    leap = ((torch.remainder(y, 4) == 0) & (torch.remainder(y, 100) != 0)) \
        | (torch.remainder(y, 400) == 0)
    table = torch.tensor(_MONTH_LEN, dtype=torch.int32, device=y.device)
    month_len = table[(m.clamp(1, 12) - 1).long()] \
        + (leap & (m == 2)).to(torch.int32)
    ok = (m >= 1) & (m <= 12) & (d >= 1) & (d <= month_len)
    out = days_from_civil(y, m.clamp(1, 12), d.clamp(1, 31))
    valid = args[0].validity & args[1].validity & args[2].validity & ok
    return prim(out.to(torch.int32), valid, DataType.DATE32)
