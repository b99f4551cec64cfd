"""Golden vectors of the JAX package's function tests, for the port.

Transcribed from ``tests/test_borrowed_vectors.py`` (Spark's documented
semantics as input → expected tables) and ``tests/test_functions_ext.py``
(the per-function unit cases), the groups over primitive, string and
date columns: casts, strings, dates, NaN/null semantics, math and
conditionals. The decimal groups wait for ROADMAP item 16d; the crypto,
json and regex groups for 17b; the array and map groups for 16f. Each
case names the reference test it comes from.

``CASES`` holds ``(source, build, arrays, expected, approx)``:
``build(ir, DT)`` makes the expression in the port's IR over the input
columns ``arrays`` (pyarrow arrays by name); ``expected`` is the output
column as Python values; ``approx`` marks the float groups the reference
compares within a relative 1e-12.
"""

import datetime
import math

import pyarrow as pa

BV = "test_borrowed_vectors.py::"
FX = "test_functions_ext.py::"

CASES = []


def _case(source, build, arrays, expected, approx=False):
    CASES.append((source, build, arrays, expected, approx))


def _c(i):
    return lambda ir, DT: ir.ColumnRef(i)


def _fn(name, *args):
    """A ScalarFunction builder; each arg is a builder or ('lit', v, dt)."""
    def build(ir, DT):
        return ir.ScalarFunction(name, tuple(_arg(a, ir, DT) for a in args))
    return build


def _arg(a, ir, DT):
    if isinstance(a, tuple) and a[0] == "lit":
        return ir.Literal(a[1], getattr(DT, a[2]))
    if isinstance(a, int):
        return ir.ColumnRef(a)
    return a(ir, DT)


def _lit(v, dt=None):
    if dt is None:
        dt = {int: "INT32", str: "STRING", bool: "BOOL",
              float: "FLOAT64"}[type(v)]
    return ("lit", v, dt)


def _cast(dt):
    return lambda ir, DT: ir.Cast(ir.ColumnRef(0), getattr(DT, dt), 0, 0,
                                  safe=True)


def _one(vec, pa_type):
    """{'c': array of the inputs} and the expected outputs of (in, out)
    pairs."""
    return {"c": pa.array([v for v, _ in vec], pa_type)}, \
        [e for _, e in vec]


D = datetime.date

# ---------------------------------------------------------------------------
# casts (TestCastVectors)
# ---------------------------------------------------------------------------

_case(BV + "TestCastVectors::test_string_to_int", _cast("INT32"), *_one(
    [("42", 42), ("  42  ", 42), ("-7", -7), ("+9", 9), ("4.5", 4),
     ("-4.9", -4), ("0", 0), ("", None), ("abc", None), ("4a", None),
     ("2147483647", 2147483647), ("2147483648", None),
     ("-2147483648", -2147483648), ("-2147483649", None), (" 1.0 ", 1),
     (".5", 0), ("1e2", None), (None, None), ("00012", 12), ("-0", 0)],
    pa.string()))
_case(BV + "TestCastVectors::test_string_to_long", _cast("INT64"), *_one(
    [("9223372036854775807", 9223372036854775807),
     ("9223372036854775808", None),
     ("-9223372036854775808", -9223372036854775808), ("123", 123),
     ("12.99", 12), ("-12.99", -12), ("", None), ("x", None), (None, None),
     ("  -5 ", -5)], pa.string()))
_case(BV + "TestCastVectors::test_string_to_double", _cast("FLOAT64"), *_one(
    [("1.5", 1.5), (" 2.25 ", 2.25), ("-0.0", -0.0), ("1e3", 1000.0),
     ("1E-2", 0.01), ("Infinity", math.inf), ("-Infinity", -math.inf),
     ("NaN", math.nan), ("", None), ("abc", None), (None, None),
     ("3", 3.0), (".5", 0.5), ("5.", 5.0), ("+4.5", 4.5)], pa.string()),
    approx=True)
_case(BV + "TestCastVectors::test_double_to_int", _cast("INT32"), *_one(
    [(4.9, 4), (-4.9, -4), (0.0, 0), (2147483646.7, 2147483646),
     (2.5e9, None), (-2.5e9, None), (math.nan, None), (math.inf, None),
     (-math.inf, None), (None, None), (1e-300, 0), (-0.5, 0)],
    pa.float64()))
_case(BV + "TestCastVectors::test_int_to_string", _cast("STRING"), *_one(
    [(0, "0"), (42, "42"), (-7, "-7"),
     (9223372036854775807, "9223372036854775807"),
     (-9223372036854775808, "-9223372036854775808"), (None, None)],
    pa.int64()))
_case(BV + "TestCastVectors::test_string_to_date", _cast("DATE32"), *_one(
    [("2020-01-01", D(2020, 1, 1)), ("1970-01-01", D(1970, 1, 1)),
     ("1969-12-31", D(1969, 12, 31)), ("2000-02-29", D(2000, 2, 29)),
     ("1900-02-28", D(1900, 2, 28)), ("2001-02-29", None),
     ("2020-13-01", None), ("2020-00-10", None), ("2020-01-32", None),
     ("not a date", None), ("", None), (None, None),
     ("2020-1-2", D(2020, 1, 2)), ("0001-01-01", D(1, 1, 1))],
    pa.string()))
_case(BV + "TestCastVectors::test_bool_casts", _cast("BOOL"), *_one(
    [("true", True), ("TRUE", True), ("t", True), ("1", True),
     ("false", False), ("FALSE", False), ("f", False), ("0", False),
     ("yes", True), ("no", False), ("y", True), ("n", False),
     ("maybe", None), ("", None), (None, None)], pa.string()))

# ---------------------------------------------------------------------------
# strings (TestStringVectors)
# ---------------------------------------------------------------------------

for s, p, ln, e in [("hello", 1, 3, "hel"), ("hello", 0, 3, "hel"),
                    ("hello", 2, 10, "ello"), ("hello", -3, 2, "ll"),
                    ("hello", -10, 2, ""), ("hello", 6, 2, ""),
                    ("", 1, 2, ""), (None, 1, 2, None),
                    ("hello", 3, 0, ""), ("ab", -1, 5, "b"),
                    ("spark sql", 7, 3, "sql"), ("x", 1, 1, "x")]:
    _case(BV + "TestStringVectors::test_substring",
          _fn("substring", 0, _lit(p), _lit(ln)),
          {"c": pa.array([s], pa.string())}, [e])

_vec = [("a", "b", "ab"), ("", "b", "b"), ("a", "", "a"), (None, "b", None),
        ("a", None, None), (None, None, None), ("x", "yz", "xyz")]
_case(BV + "TestStringVectors::test_concat_null_propagation",
      _fn("concat", 0, 1),
      {"a": pa.array([a for a, _, _ in _vec], pa.string()),
       "b": pa.array([b for _, b, _ in _vec], pa.string())},
      [e for _, _, e in _vec])

_vec = [("  hi  ", "hi", "hi  ", "  hi"), ("hi", "hi", "hi", "hi"),
        ("   ", "", "", ""), ("", "", "", ""), (None, None, None, None),
        (" a b ", "a b", "a b ", " a b")]
for _i, _name in enumerate(("trim", "ltrim", "rtrim")):
    _case(BV + "TestStringVectors::test_trim_family", _fn(_name, 0),
          {"c": pa.array([v[0] for v in _vec], pa.string())},
          [v[_i + 1] for v in _vec])

for s, n, p, el, er in [("hi", 5, "*", "***hi", "hi***"),
                        ("hi", 1, "*", "h", "h"),
                        ("hi", 2, "*", "hi", "hi"),
                        ("", 3, "ab", "aba", "aba"),
                        (None, 3, "*", None, None),
                        ("abc", 7, "xy", "xyxyabc", "abcxyxy")]:
    for _name, _want in (("lpad", el), ("rpad", er)):
        _case(BV + "TestStringVectors::test_pad",
              _fn(_name, 0, _lit(n), _lit(p)),
              {"c": pa.array([s], pa.string())}, [_want])

for s, sub, e in [("hello world", "o", 5), ("hello", "z", 0), ("", "a", 0),
                  ("aaa", "aa", 1), (None, "a", None)]:
    _case(BV + "TestStringVectors::test_instr_substring_index",
          _fn("instr", 0, _lit(sub)), {"c": pa.array([s], pa.string())},
          [e])
for s, d, n, e in [("a.b.c", ".", 2, "a.b"), ("a.b.c", ".", -1, "c"),
                   ("a.b.c", ".", 0, ""), ("abc", ".", 2, "abc"),
                   (None, ".", 1, None)]:
    _case(BV + "TestStringVectors::test_instr_substring_index",
          _fn("substring_index", 0, _lit(d), _lit(n)),
          {"c": pa.array([s], pa.string())}, [e])

_vec = [("MiXeD", "MIXED", "mixed", 5, "DeXiM"), ("", "", "", 0, ""),
        (None, None, None, None, None),
        ("abc123", "ABC123", "abc123", 6, "321cba")]
for _i, _name in enumerate(("upper", "lower", "length", "reverse")):
    _case(BV + "TestStringVectors::test_upper_lower_length_reverse",
          _fn(_name, 0), {"c": pa.array([v[0] for v in _vec], pa.string())},
          [v[_i + 1] for v in _vec])

_case(BV + "TestStringVectors::test_translate_ascii_chr",
      _fn("translate", 0, _lit("abc"), _lit("xy")),
      {"c": pa.array(["aabbcc", "", None, "cab"], pa.string())},
      ["xxyy", "", None, "xy"])
_case(BV + "TestStringVectors::test_translate_ascii_chr", _fn("ascii", 0),
      {"c": pa.array(["A", "abc", "", None], pa.string())},
      [65, 97, 0, None])

# ---------------------------------------------------------------------------
# dates (TestDateVectors)
# ---------------------------------------------------------------------------

_DATES = {"c": pa.array([D(2020, 2, 29), D(1970, 1, 1), D(1969, 12, 31),
                         D(2000, 12, 31), D(1582, 10, 15), D(9999, 12, 31),
                         None, D(2024, 3, 1)], pa.date32())}
for _name, _want in (("year", [2020, 1970, 1969, 2000, 1582, 9999, None,
                               2024]),
                     ("month", [2, 1, 12, 12, 10, 12, None, 3]),
                     ("day", [29, 1, 31, 31, 15, 31, None, 1])):
    _case(BV + "TestDateVectors::test_extract_fields", _fn(_name, 0), _DATES,
          _want)
# the reference checks rows 0-3 and 7 of dayofyear
_case(BV + "TestDateVectors::test_extract_fields", _fn("dayofyear", 0),
      {"c": pa.array([D(2020, 2, 29), D(1970, 1, 1), D(1969, 12, 31),
                      D(2000, 12, 31), D(2024, 3, 1)], pa.date32())},
      [60, 1, 365, 366, 61])

_BASE = {"c": pa.array([D(2020, 1, 31), D(2020, 2, 28), None], pa.date32())}
_case(BV + "TestDateVectors::test_date_add_sub_diff",
      _fn("date_add", 0, _lit(1)), _BASE,
      [D(2020, 2, 1), D(2020, 2, 29), None])
_case(BV + "TestDateVectors::test_date_add_sub_diff",
      _fn("date_sub", 0, _lit(31)), _BASE,
      [D(2019, 12, 31), D(2020, 1, 28), None])
_case(BV + "TestDateVectors::test_date_add_sub_diff", _fn("datediff", 0, 1),
      {"a": pa.array([D(2020, 3, 1), D(2020, 1, 1), None], pa.date32()),
       "b": pa.array([D(2020, 2, 1), D(2020, 3, 1), D(2020, 1, 1)],
                     pa.date32())}, [29, -60, None])

_BASE = {"c": pa.array([D(2020, 2, 10), D(2021, 2, 10), D(2020, 12, 31),
                        None], pa.date32())}
_case(BV + "TestDateVectors::test_last_day_trunc", _fn("last_day", 0), _BASE,
      [D(2020, 2, 29), D(2021, 2, 28), D(2020, 12, 31), None])
_case(BV + "TestDateVectors::test_last_day_trunc",
      _fn("trunc", 0, _lit("MM")), _BASE,
      [D(2020, 2, 1), D(2021, 2, 1), D(2020, 12, 1), None])
_case(BV + "TestDateVectors::test_last_day_trunc",
      _fn("trunc", 0, _lit("YEAR")), _BASE,
      [D(2020, 1, 1), D(2021, 1, 1), D(2020, 1, 1), None])

# ---------------------------------------------------------------------------
# NaN / null (TestNanNullSemantics), math (TestMathVectors)
# ---------------------------------------------------------------------------

_case(BV + "TestNanNullSemantics::test_comparison_null_propagation",
      lambda ir, DT: ir.BinaryExpr("==", ir.ColumnRef(0), ir.ColumnRef(1)),
      {"a": pa.array([1.0, None, math.nan], pa.float64()),
       "b": pa.array([1.0, 1.0, math.nan], pa.float64())},
      [True, None, False])

_case(BV + "TestMathVectors::test_round_bround", _fn("round", 0),
      {"c": pa.array([2.5, -2.5, 2.4, 3.5, -3.5, 0.5, None], pa.float64())},
      [3.0, -3.0, 2.0, 4.0, -4.0, 1.0, None], approx=True)
_case(BV + "TestMathVectors::test_round_bround", _fn("round", 0, _lit(2)),
      {"c": pa.array([2.675, 1.234, -2.675, None], pa.float64())},
      [2.68, 1.23, -2.68, None], approx=True)
_case(BV + "TestMathVectors::test_round_bround", _fn("bround", 0),
      {"c": pa.array([2.5, 3.5, -2.5, 0.5, None], pa.float64())},
      [2.0, 4.0, -2.0, 0.0, None], approx=True)
_vec = [(1.1, 2, 1), (-1.1, -1, -2), (0.0, 0, 0), (-0.5, 0, -1),
        (5.0, 5, 5), (None, None, None)]
_case(BV + "TestMathVectors::test_ceil_floor", _fn("ceil", 0),
      {"c": pa.array([v for v, _, _ in _vec], pa.float64())},
      [e for _, e, _ in _vec])
_case(BV + "TestMathVectors::test_ceil_floor", _fn("floor", 0),
      {"c": pa.array([v for v, _, _ in _vec], pa.float64())},
      [e for _, _, e in _vec])
_case(BV + "TestMathVectors::test_abs_sign", _fn("abs", 0),
      {"c": pa.array([-5, 5, 0, None], pa.int64())}, [5, 5, 0, None])
_case(BV + "TestMathVectors::test_abs_sign", _fn("sign", 0),
      {"c": pa.array([-3.5, 0.0, 7.0, None], pa.float64())},
      [-1.0, 0.0, 1.0, None], approx=True)
_case(BV + "TestMathVectors::test_pmod", _fn("pmod", 0, _lit(3)),
      {"c": pa.array([10, -7, 0, None], pa.int32())}, [1, 2, 0, None])
_case(BV + "TestMathVectors::test_pmod", _fn("pmod", 0, _lit(-3)),
      {"c": pa.array([7, -7], pa.int32())}, [-2, -1])
_case(BV + "TestMathVectors::test_pow_sqrt_exp_log",
      _fn("pow", 0, _lit(10.0)),
      {"c": pa.array([2.0, 0.0, None], pa.float64())}, [1024.0, 0.0, None],
      approx=True)
_case(BV + "TestMathVectors::test_pow_sqrt_exp_log", _fn("sqrt", 0),
      {"c": pa.array([4.0, 0.0, -1.0, None], pa.float64())},
      [2.0, 0.0, math.nan, None], approx=True)
_case(BV + "TestMathVectors::test_pow_sqrt_exp_log", _fn("exp", 0),
      {"c": pa.array([0.0, 1.0, None], pa.float64())}, [1.0, math.e, None],
      approx=True)
_case(BV + "TestMathVectors::test_pow_sqrt_exp_log", _fn("ln", 0),
      {"c": pa.array([math.e, 1.0, 0.0, -1.0, None], pa.float64())},
      [1.0, 0.0, None, None, None], approx=True)
_case(BV + "TestMathVectors::test_pow_sqrt_exp_log", _fn("hypot", 0, 1),
      {"a": pa.array([3.0, 0.0], pa.float64()),
       "b": pa.array([4.0, 0.0], pa.float64())}, [5.0, 0.0], approx=True)
_case(BV + "TestMathVectors::test_factorial", _fn("factorial", 0),
      {"c": pa.array([0, 5, 20, 21, -1, None], pa.int32())},
      [1, 120, 2432902008176640000, None, None, None])
_a = pa.array([1.0, None, float("nan"), None], pa.float64())
_b = pa.array([2.0, 3.0, 1.0, None], pa.float64())
_case(BV + "TestMathVectors::test_greatest_least_skip_nulls",
      _fn("greatest", 0, 1), {"a": _a, "b": _b}, [2.0, 3.0, math.nan, None],
      approx=True)
_case(BV + "TestMathVectors::test_greatest_least_skip_nulls",
      _fn("least", 0, 1), {"a": _a, "b": _b}, [1.0, 3.0, 1.0, None],
      approx=True)
_case(BV + "TestMathVectors::test_isnan_nanvl", _fn("isnan", 0),
      {"c": pa.array([float("nan"), 1.0, None], pa.float64())},
      [True, False, False])
_case(BV + "TestMathVectors::test_isnan_nanvl", _fn("nanvl", 0, 1),
      {"a": pa.array([float("nan"), 1.0, None], pa.float64()),
       "b": pa.array([5.0, 9.0, 2.0], pa.float64())}, [5.0, 1.0, None],
      approx=True)

# ---------------------------------------------------------------------------
# more strings (TestMoreStringVectors; base64, hex and crypto: item 17b)
# ---------------------------------------------------------------------------

_case(BV + "TestMoreStringVectors::test_locate_position",
      _fn("locate", _lit("l"), 0),
      {"c": pa.array(["hello", "world", "xyz", "", None])},
      [3, 4, 0, 0, None])
_case(BV + "TestMoreStringVectors::test_locate_position",
      _fn("position", _lit("o"), 0), {"c": pa.array(["hello world", "xyz"])},
      [5, 0])
_case(BV + "TestMoreStringVectors::test_repeat_initcap",
      _fn("repeat", 0, _lit(3)), {"c": pa.array(["ab", "", None])},
      ["ababab", "", None])
_case(BV + "TestMoreStringVectors::test_repeat_initcap",
      _fn("repeat", 0, _lit(0)), {"c": pa.array(["ab"])}, [""])
_case(BV + "TestMoreStringVectors::test_repeat_initcap", _fn("initcap", 0),
      {"c": pa.array(["hello world", "hELLO", "a b", "", None])},
      ["Hello World", "Hello", "A B", "", None])
_case(BV + "TestMoreStringVectors::test_concat_ws_skips_nulls",
      _fn("concat_ws", _lit("-"), 0, 1),
      {"a": pa.array(["a", None, "x", None]),
       "b": pa.array(["b", "c", None, None])}, ["a-b", "c", "x", ""])
_case(BV + "TestMoreStringVectors::test_chr_ascii_char", _fn("chr", 0),
      {"c": pa.array([65, 97, 48, None], pa.int64())},
      ["A", "a", "0", None])
_case(BV + "TestMoreStringVectors::test_chr_ascii_char", _fn("char", 0),
      {"c": pa.array([66], pa.int64())}, ["B"])
for s, p, ln, e in [("spark sql", -10, 2, "s"), ("hello", -5, 2, "he"),
                    ("hello", -4, 10, "ello"), ("hello", 1, 0, "")]:
    _case(BV + "TestMoreStringVectors::test_substring_clamp_subtleties",
          _fn("substring", 0, _lit(p), _lit(ln)),
          {"c": pa.array([s], pa.string())}, [e])
_case(BV + "TestMoreStringVectors::test_char_length", _fn("char_length", 0),
      {"c": pa.array(["abc", "", None])}, [3, 0, None])

# ---------------------------------------------------------------------------
# more dates / timestamps (TestMoreDateVectors)
# ---------------------------------------------------------------------------

_BASE = {"c": pa.array([D(2020, 1, 31), D(2020, 2, 29), D(2020, 11, 30),
                        None], pa.date32())}
_case(BV + "TestMoreDateVectors::test_add_months",
      _fn("add_months", 0, _lit(1)), _BASE,
      [D(2020, 2, 29), D(2020, 3, 29), D(2020, 12, 30), None])
_case(BV + "TestMoreDateVectors::test_add_months",
      _fn("add_months", 0, _lit(-12)), _BASE,
      [D(2019, 1, 31), D(2019, 2, 28), D(2019, 11, 30), None])
_case(BV + "TestMoreDateVectors::test_months_between",
      _fn("months_between", 0, 1),
      {"a": pa.array([D(2020, 3, 15), D(2020, 2, 29), None], pa.date32()),
       "b": pa.array([D(2020, 1, 15), D(2020, 1, 31), D(2020, 1, 1)],
                     pa.date32())}, [2.0, 1.0, None], approx=True)
_case(BV + "TestMoreDateVectors::test_next_day_weekofyear",
      _fn("next_day", 0, _lit("Sunday")),
      {"c": pa.array([D(2020, 1, 1), D(2020, 1, 5), None], pa.date32())},
      [D(2020, 1, 5), D(2020, 1, 12), None])
_case(BV + "TestMoreDateVectors::test_next_day_weekofyear",
      _fn("weekofyear", 0),
      {"c": pa.array([D(2020, 1, 1), D(2016, 1, 1), D(2020, 12, 31), None],
                     pa.date32())}, [1, 53, 53, None])
_case(BV + "TestMoreDateVectors::test_dayofweek_quarter", _fn("dayofweek", 0),
      {"c": pa.array([D(2020, 1, 1), D(2020, 1, 5), D(2020, 1, 6), None],
                     pa.date32())}, [4, 1, 2, None])
_case(BV + "TestMoreDateVectors::test_dayofweek_quarter", _fn("quarter", 0),
      {"c": pa.array([D(2020, 1, 1), D(2020, 5, 1), D(2020, 12, 31), None],
                     pa.date32())}, [1, 2, 4, None])
_case(BV + "TestMoreDateVectors::test_make_date_to_date",
      _fn("make_date", 0, 1, 2),
      {"y": pa.array([2020, 2020, 2019, None], pa.int32()),
       "m": pa.array([2, 13, 2, 1], pa.int32()),
       "d": pa.array([29, 1, 29, 1], pa.int32())},
      [D(2020, 2, 29), None, None, None])
_case(BV + "TestMoreDateVectors::test_make_date_to_date", _fn("to_date", 0),
      {"c": pa.array(["2020-01-01", "bad", "", None])},
      [D(2020, 1, 1), None, None, None])
_case(BV + "TestMoreDateVectors::test_date_format_from_unixtime",
      _fn("date_format", 0, _lit("yyyy-MM-dd")),
      {"c": pa.array([D(2020, 1, 5), None], pa.date32())},
      ["2020-01-05", None])
_case(BV + "TestMoreDateVectors::test_date_format_from_unixtime",
      _fn("from_unixtime", 0),
      {"c": pa.array([0, 86400, 86399, None], pa.int64())},
      ["1970-01-01 00:00:00", "1970-01-02 00:00:00", "1970-01-01 23:59:59",
       None])
_case(BV + "TestMoreDateVectors::test_date_format_from_unixtime",
      _fn("unix_timestamp", 0), {"c": pa.array(["1970-01-01 00:00:01"])},
      [1])
_TS = {"c": pa.array([datetime.datetime(2020, 1, 2, 13, 45, 59),
                      datetime.datetime(1970, 1, 1, 0, 0, 0), None],
                     pa.timestamp("us"))}
for _name, _want in (("hour", [13, 0, None]), ("minute", [45, 0, None]),
                     ("second", [59, 0, None])):
    _case(BV + "TestMoreDateVectors::test_timestamp_fields", _fn(_name, 0),
          _TS, _want)
_case(BV + "TestMoreDateVectors::test_trunc_quarter_week",
      _fn("trunc", 0, _lit("QUARTER")),
      {"c": pa.array([D(2020, 5, 20), None], pa.date32())},
      [D(2020, 4, 1), None])

# ---------------------------------------------------------------------------
# conditionals (TestConditionalVectors)
# ---------------------------------------------------------------------------

_case(BV + "TestConditionalVectors::test_coalesce", _fn("coalesce", 0, 1),
      {"a": pa.array([None, 5, None], pa.int64()),
       "b": pa.array([2, 9, None], pa.int64())}, [2, 5, None])
_case(BV + "TestConditionalVectors::test_nullif",
      _fn("nullif", 0, _lit(1, "INT64")),
      {"c": pa.array([1, 2, None], pa.int64())}, [None, 2, None])
_case(BV + "TestConditionalVectors::test_if",
      _fn("if", lambda ir, DT: ir.BinaryExpr(
          ">", ir.ColumnRef(0), ir.Literal(0, DT.INT64)),
          _lit("pos"), _lit("neg")),
      {"c": pa.array([5, -5, 0], pa.int64())}, ["pos", "neg", "neg"])
_case(BV + "TestConditionalVectors::"
      "test_case_when_null_condition_falls_through",
      lambda ir, DT: ir.CaseWhen(
          ((ir.BinaryExpr(">", ir.ColumnRef(0), ir.Literal(0, DT.INT64)),
            ir.Literal("pos", DT.STRING)),),
          otherwise=ir.Literal("other", DT.STRING)),
      {"c": pa.array([3, -3, None], pa.int64())}, ["pos", "other", "other"])

# ---------------------------------------------------------------------------
# test_functions_ext.py: strings, dates, math (crypto/json/regex: 17b;
# arrays and maps: 16f)
# ---------------------------------------------------------------------------

_case(FX + "test_concat_ws", _fn("concat_ws", _lit("-"), 0, 1),
      {"a": pa.array(["x", None, "p", None], pa.string()),
       "b": pa.array(["y", "q", None, None], pa.string())},
      ["x-y", "q", "p", ""])
_case(FX + "test_initcap", _fn("initcap", 0),
      {"s": pa.array(["hello wORLD", "a b  c", "", "X"])},
      ["Hello World", "A B  C", "", "X"])
_S = {"s": pa.array(["ab", "", "xyz"])}
_case(FX + "test_repeat_reverse", _fn("repeat", 0, _lit(3)), _S,
      ["ababab", "", "xyzxyzxyz"])
_case(FX + "test_repeat_reverse", _fn("reverse", 0), _S, ["ba", "", "zyx"])
_S = {"s": pa.array(["hi", "longer", ""])}
_case(FX + "test_pads", _fn("lpad", 0, _lit(5), _lit("*")), _S,
      ["***hi", "longe", "*****"])
_case(FX + "test_pads", _fn("rpad", 0, _lit(5), _lit("ab")), _S,
      ["hiaba", "longe", "ababa"])
_S = {"s": pa.array(["hello", "a", ""]), "n": pa.array([2, 5, 3], pa.int32())}
_case(FX + "test_left_right_ascii_chr", _fn("left", 0, 1), _S,
      ["he", "a", ""])
_case(FX + "test_left_right_ascii_chr", _fn("right", 0, 1), _S,
      ["lo", "a", ""])
_case(FX + "test_left_right_ascii_chr", _fn("ascii", 0), _S, [104, 97, 0])
_case(FX + "test_left_right_ascii_chr", _fn("chr", 0),
      {"n": pa.array([65, 97, 48], pa.int64())}, ["A", "a", "0"])
_S = {"s": pa.array(["hello world", "abc", "aaa"])}
_case(FX + "test_instr_locate", _fn("instr", 0, _lit("o")), _S, [5, 0, 0])
_case(FX + "test_instr_locate", _fn("locate", _lit("a"), 0, _lit(2)), _S,
      [0, 0, 2])
_case(FX + "test_instr_locate", _fn("locate", _lit("a"), 0), _S, [0, 1, 1])
_S = {"s": pa.array(["www.apache.org", "a.b", "no-dots", "a.b.c.d"])}
_case(FX + "test_substring_index",
      _fn("substring_index", 0, _lit("."), _lit(2)), _S,
      ["www.apache", "a.b", "no-dots", "a.b"])
_case(FX + "test_substring_index",
      _fn("substring_index", 0, _lit("."), _lit(-2)), _S,
      ["apache.org", "a.b", "no-dots", "c.d"])
_case(FX + "test_translate", _fn("translate", 0, _lit("ab"), _lit("X")),
      {"s": pa.array(["AaBbCc", "translate", ""])},
      ["AXBCc", "trXnslXte", ""])
_case(FX + "test_split_getitem",
      lambda ir, DT: ir.GetIndexedField(ir.ScalarFunction(
          "split", (ir.ColumnRef(0), ir.Literal(",", DT.STRING))), 1),
      {"s": pa.array(["a,b,c", "x", ",y"])}, ["b", None, "y"])


def _days(s):
    return (datetime.date.fromisoformat(s) - D(1970, 1, 1)).days


def _us(s):
    dt = datetime.datetime.fromisoformat(s).replace(
        tzinfo=datetime.timezone.utc)
    return int(dt.timestamp() * 1e6)


_T = {"t": pa.array([_us("2023-07-04T12:34:56"), _us("1969-12-31T23:00:01")],
                    pa.timestamp("us"))}
for _name, _want in (("hour", [12, 23]), ("minute", [34, 0]),
                     ("second", [56, 1])):
    _case(FX + "test_hour_minute_second", _fn(_name, 0), _T, _want)
_T = {"t": pa.array([_us("2023-07-04T09:05:06"), _us("1999-12-31T23:59:59")],
                    pa.timestamp("us"))}
_case(FX + "test_date_format_from_unixtime",
      _fn("date_format", 0, _lit("yyyy-MM-dd HH:mm:ss")), _T,
      ["2023-07-04 09:05:06", "1999-12-31 23:59:59"])
_case(FX + "test_date_format_from_unixtime",
      _fn("date_format", 0, _lit("dd/MM/yy")), _T, ["04/07/23", "31/12/99"])
_case(FX + "test_date_format_from_unixtime", _fn("from_unixtime", 0),
      {"sec": pa.array([0, 86400 + 3661], pa.int64())},
      ["1970-01-01 00:00:00", "1970-01-02 01:01:01"])
_case(FX + "test_unix_timestamp_and_to_date",
      _fn("unix_timestamp", 0, _lit("yyyy-MM-dd HH:mm:ss")),
      {"s": pa.array(["2023-07-04 12:00:00", "bogus",
                      "1970-01-01 00:00:10"])},
      [_us("2023-07-04T12:00:00") // 10 ** 6, None, 10])
_case(FX + "test_unix_timestamp_and_to_date", _fn("to_date", 0),
      {"s": pa.array(["2021-03-05", "nope"])}, [D(2021, 3, 5), None])
_DD = {"d": pa.array([_days("2023-07-14"), _days("2023-01-01")], pa.date32())}
_case(FX + "test_trunc_date_trunc", _fn("trunc", 0, _lit("year")), _DD,
      [D(2023, 1, 1)] * 2)
_case(FX + "test_trunc_date_trunc", _fn("trunc", 0, _lit("month")), _DD,
      [D(2023, 7, 1), D(2023, 1, 1)])
_case(FX + "test_trunc_date_trunc", _fn("trunc", 0, _lit("week")), _DD,
      [D(2023, 7, 10), D(2022, 12, 26)])
_case(FX + "test_trunc_date_trunc", _fn("date_trunc", _lit("hour"), 0),
      {"t": pa.array([_us("2023-07-14T10:30:45")], pa.timestamp("us"))},
      [datetime.datetime(2023, 7, 14, 10, 0, 0)])
_DD = {"d": pa.array([_days("2023-01-31"), _days("2023-02-28")], pa.date32()),
       "n": pa.array([1, 12], pa.int32())}
_case(FX + "test_month_math", _fn("add_months", 0, 1), _DD,
      [D(2023, 2, 28), D(2024, 2, 28)])
_case(FX + "test_month_math", _fn("last_day", 0), _DD,
      [D(2023, 1, 31), D(2023, 2, 28)])
_case(FX + "test_month_math", _fn("months_between", 0, 1),
      {"a": pa.array([_us("2023-03-31T00:00:00"), _us("2023-03-15T00:00:00")],
                     pa.timestamp("us")),
       "b": pa.array([_us("2023-02-28T00:00:00"), _us("2023-02-15T00:00:00")],
                     pa.timestamp("us"))}, [1.0, 1.0])
_case(FX + "test_month_math", _fn("months_between", 0, 1),
      {"a": pa.array([_us("2023-03-15T12:00:00")], pa.timestamp("us")),
       "b": pa.array([_us("2023-02-15T00:00:00")], pa.timestamp("us"))},
      [1.0])
_DD = {"d": pa.array([_days("2021-01-01"), _days("2021-01-04"),
                      _days("2023-07-14")], pa.date32())}
_case(FX + "test_weekofyear_next_day", _fn("weekofyear", 0), _DD,
      [53, 1, 28])
_WEEKS = ["2019-12-30", "2019-12-31", "2024-12-30", "2015-12-28",
          "2020-12-31", "2016-01-01"]
_case(FX + "test_weekofyear_next_day", _fn("weekofyear", 0),
      {"d": pa.array([_days(s) for s in _WEEKS], pa.date32())},
      [datetime.date.fromisoformat(s).isocalendar()[1] for s in _WEEKS])
_case(FX + "test_weekofyear_next_day", _fn("next_day", 0, _lit("Monday")),
      _DD, [D(2021, 1, 4), D(2021, 1, 11), D(2023, 7, 17)])
_case(FX + "test_make_date", _fn("make_date", 0, 1, 2),
      {"y": pa.array([2023, 2020], pa.int32()),
       "m": pa.array([7, 2], pa.int32()),
       "d": pa.array([14, 29], pa.int32())},
      [D(2023, 7, 14), D(2020, 2, 29)])

_X = [0.5, -1.2, 2.0]
_XY = {"x": pa.array(_X, pa.float64()),
       "y": pa.array([2.0, 3.0, -4.0], pa.float64())}
for _name, _ref in [("sin", math.sin), ("cos", math.cos), ("tan", math.tan),
                    ("atan", math.atan), ("tanh", math.tanh),
                    ("cbrt", lambda v: math.copysign(abs(v) ** (1 / 3), v)),
                    ("degrees", math.degrees), ("radians", math.radians),
                    ("expm1", math.expm1)]:
    _case(FX + "test_math_family", _fn(_name, 0), _XY,
          [_ref(v) for v in _X], approx=True)
_case(FX + "test_math_family", _fn("signum", 0), _XY, [1.0, -1.0, 1.0])
_case(FX + "test_math_family", _fn("atan2", 0, 1), _XY,
      [math.atan2(a, b) for a, b in zip(_X, [2.0, 3.0, -4.0])], approx=True)
_case(FX + "test_math_family", _fn("pmod", 0, 1),
      {"a": pa.array([7, -7, 5], pa.int64()),
       "b": pa.array([3, 3, 0], pa.int64())}, [1, 2, None])
_case(FX + "test_math_family", _fn("factorial", 0),
      {"n": pa.array([5, 20, 21, -1], pa.int64())},
      [120, math.factorial(20), None, None])
