"""Shared cases of the port's expression tests against the JAX package.

One batch of seeded numpy columns (64 rows of capacity, 61 live) for
both evaluators: strings of widths 16 and 8 with nulls, empty strings,
bytes above 0x7F, spaces and parseable text; int64 with INT64_MIN and
INT64_MAX; int32; float64 with ±0.0, NaN, ±inf and one subnormal;
float32; dates and timestamps before and after 1970; bools; and small
integers. ``FUNCTIONS`` gives every registered name the argument shapes
it is held on; ``NODES`` the slice's expression nodes and casts;
``eval_both`` evaluates one spec in both packages and ``assert_same``
compares the live rows: validity, values (floats bit for bit, NaN equal
to NaN) and result types; the transcendental family (``ULP_NAMES``) may
differ from XLA's CPU results by at most ``ULP_BOUND`` units in the last
place. The test files ``test_torch_functions.py``,
``test_torch_fn_strings.py`` and ``test_torch_fn_dates.py`` split the
cases by the reference module that registers each name.
"""

import numpy as np

import jax
import jax.numpy as jnp

from auron_tpu.columnar.batch import DeviceBatch as JBatch
from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.columnar.batch import StringColumn as JStr
from auron_tpu.columnar.schema import DataType as JDT
from auron_tpu.columnar.schema import Field as JField
from auron_tpu.columnar.schema import Schema as JSchema
from auron_tpu.exprs import eval as jeval
from auron_tpu.exprs import functions as jfunctions
from auron_tpu.exprs import ir as jir
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.it import comparator

CAP, ROWS = 64, 61
ULP_BOUND = comparator.ULP_BOUND
ULP_NAMES = frozenset({
    "exp", "log", "ln", "pow", "power", "sin", "cos", "tan", "asin", "acos",
    "atan", "sinh", "cosh", "tanh", "log10", "log2", "log1p", "expm1",
    "cbrt", "hypot", "atan2"})

WORDS = ["", "a", " a b ", "  hi  ", "Hello wORLD", "é", "日本", "éa",
         "42", " -7 ", "4.5", "1e3", ".5", "-0", "9223372036854775807",
         "true", "N", "yes", "maybe", "2020-1-2", "1969-12-31", "2020-02-30",
         "2020-01-01 10:20:30", "a.b.c", "x,y,,z", "www.apache.org",
         "abcabc", "Infinity", "NaN", "aXbXc"]
SHORT = ["", "a", "ab", "ba", "b", "xyz", "é", "a_b", "a%c"]
COLS = ["s", "t", "i64", "i32", "f64", "f32", "d", "ts", "b", "n", "m"]
TYPES = ["STRING", "STRING", "INT64", "INT32", "FLOAT64", "FLOAT32",
         "DATE32", "TIMESTAMP_US", "BOOL", "INT32", "INT32"]
US_PER_DAY = 86_400_000_000


def _strings(words, n, width, rng):
    chars = np.zeros((n, width), np.uint8)
    lens = np.zeros(n, np.int32)
    for i in range(n):
        b = words[int(rng.integers(len(words)))].encode()[:width]
        chars[i, :len(b)] = np.frombuffer(b, np.uint8)
        lens[i] = len(b)
    return chars, lens, rng.random(n) > 0.1


def columns():
    rng = np.random.default_rng(11)
    valid = lambda: rng.random(CAP) > 0.12
    i64 = rng.integers(-10**15, 10**15, CAP)
    i64[:4] = [np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, -1]
    f64 = rng.normal(size=CAP) * 100
    f64[:12] = [0.0, -0.0, np.nan, np.inf, -np.inf, 2.5, -2.5, 0.5, 64.0,
                -27.0, 1e300, 1e-310]
    days = rng.integers(-700_000, 2_900_000, CAP).astype(np.int32)
    days[:4] = [0, -1, -719162, 18321]
    ts = days.astype(np.int64) * US_PER_DAY \
        + rng.integers(0, US_PER_DAY, CAP)
    ts[4] = -1
    return [
        _strings(WORDS, CAP, 16, rng),
        _strings(SHORT, CAP, 8, rng),
        (i64, valid()),
        (rng.integers(-40, 40, CAP).astype(np.int32), valid()),
        (f64, valid()),
        (rng.normal(size=CAP).astype(np.float32) * 10, valid()),
        (days, valid()),
        (ts, valid()),
        (rng.random(CAP) > 0.5, valid()),
        (rng.integers(-3, 23, CAP).astype(np.int32), valid()),
        (rng.integers(-14, 15, CAP).astype(np.int32), np.ones(CAP, bool)),
    ]


def batches():
    cols = columns()
    jcols = tuple(JStr(jnp.asarray(c[0]), jnp.asarray(c[1]),
                       jnp.asarray(c[2])) if len(c) == 3
                  else JCol(jnp.asarray(c[0]), jnp.asarray(c[1]))
                  for c in cols)
    jb = JBatch(jcols, jnp.asarray(ROWS, jnp.int32))
    tb = batch_from_numpy(cols, ROWS, "cpu")
    js = JSchema(tuple(JField(n, JDT[t]) for n, t in zip(COLS, TYPES)))
    ts = TSchema(tuple(TField(n, TDT[t]) for n, t in zip(COLS, TYPES)))
    return jb, js, tb, ts


# ---------------------------------------------------------------------------
# expression specs: nested tuples built in either package's IR
# ---------------------------------------------------------------------------

def c(name):
    return ("col", name)


def lit(v, dt=None):
    if dt is None:
        dt = {int: "INT32", str: "STRING", bool: "BOOL",
              float: "FLOAT64"}[type(v)]
    return ("lit", v, dt)


def fn(name, *args):
    return ("fn", name) + args


def build(spec, ir, DT):
    head = spec[0]
    if head == "col":
        return ir.ColumnRef(COLS.index(spec[1]), spec[1])
    if head == "lit":
        return ir.Literal(spec[1], DT[spec[2]])
    if head == "fn":
        return ir.ScalarFunction(spec[1], tuple(build(a, ir, DT)
                                                for a in spec[2:]))
    if head == "neg":
        return ir.Negative(build(spec[1], ir, DT))
    if head == "cast":
        return ir.Cast(build(spec[1], ir, DT), DT[spec[2]], 0, 0,
                       safe=spec[3] if len(spec) > 3 else True)
    if head == "case":
        pairs = tuple((build(w, ir, DT), build(t, ir, DT))
                      for w, t in spec[1])
        other = build(spec[2], ir, DT) if spec[2] is not None else None
        return ir.CaseWhen(pairs, other)
    if head == "like":
        return ir.Like(build(spec[1], ir, DT), spec[2],
                       spec[3] if len(spec) > 3 else False)
    if head in ("startswith", "endswith", "contains"):
        cls = {"startswith": ir.StringStartsWith,
               "endswith": ir.StringEndsWith,
               "contains": ir.StringContains}[head]
        return cls(build(spec[1], ir, DT), spec[2])
    if head == "index":
        return ir.GetIndexedField(build(spec[1], ir, DT), spec[2])
    return ir.BinaryExpr(head, build(spec[1], ir, DT), build(spec[2], ir, DT))


def positive(col):
    return (">", c(col), lit(0, "INT64" if col == "i64" else "INT32"))


#: every registered name with the argument shapes it is held on
FUNCTIONS = {
    # dates
    "year": [(c("d"),), (c("ts"),)], "month": [(c("d"),), (c("ts"),)],
    "day": [(c("d"),)], "dayofmonth": [(c("ts"),)],
    "quarter": [(c("d"),)], "dayofweek": [(c("d"),), (c("ts"),)],
    "dayofyear": [(c("d"),)],
    "date_add": [(c("d"), c("m")), (c("d"), lit(40))],
    "date_sub": [(c("d"), c("n"))], "datediff": [(c("d"), c("m"))],
    # math
    "abs": [(c("i64"),), (c("f64"),), (c("i32"),)],
    "sqrt": [(c("f64"),), (c("i32"),)],
    "floor": [(c("f64"),), (c("i32"),), (c("f32"),)],
    "ceil": [(c("f64"),), (c("i64"),)],
    "round": [(c("f64"),), (c("f64"), lit(2)), (c("f64"), lit(-1)),
              (c("i32"), lit(1)), (c("f64"), lit(None, "INT32"))],
    "bround": [(c("f64"),), (c("f64"), lit(1)), (c("i64"),)],
    "pow": [(c("f64"), lit(2.0)), (c("i32"), c("n"))],
    "power": [(c("f32"), lit(0.5))],
    "exp": [(c("f32"),)], "log": [(c("f64"),)], "ln": [(c("i32"),)],
    "isnan": [(c("f64"),), (c("i64"),)],
    "nanvl": [(c("f64"), lit(-1.0))],
    "normalize_nan_and_zero": [(c("f64"),)],
    "greatest": [(c("f64"), lit(1.0), lit(None, "FLOAT64")),
                 (c("i32"), c("n"))],
    "least": [(c("f64"), lit(1.0)), (c("i32"), c("n"), c("m"))],
    **{name: [(c("f64"),), (c("f32"),)] for name in (
        "sin", "cos", "tan", "asin", "acos", "atan", "sinh", "cosh",
        "tanh", "log10", "log2", "log1p", "expm1", "cbrt", "degrees",
        "radians", "rint")},
    "signum": [(c("f64"),)], "sign": [(c("i32"),)],
    "atan2": [(c("f64"), c("f32"))], "hypot": [(c("f64"), c("i32"))],
    "pi": [()], "e": [()],
    "pmod": [(c("i32"), c("m")), (c("i64"), lit(7)), (c("f64"), lit(3.0))],
    "factorial": [(c("n"),)],
    # nulls
    "coalesce": [(c("i64"), c("i32"), lit(0, "INT64")), (c("s"), c("t"))],
    "nullif": [(c("i32"), c("n")), (c("t"), lit("a"))],
    "null_if": [(c("f64"), lit(0.0))],
    "if": [(positive("i32"), c("f64"), lit(0.0)),
           (positive("i64"), c("t"), c("s"))],
    # strings
    "length": [(c("s"),)], "char_length": [(c("t"),)],
    "upper": [(c("s"),)], "lower": [(c("s"),)], "trim": [(c("s"),)],
    "ltrim": [(c("s"),)], "rtrim": [(c("s"),)],
    "substring": [(c("s"), c("m"), c("n")), (c("s"), lit(2)),
                  (c("s"), lit(-3), lit(2)),
                  (c("s"), lit(1), lit(2147483647))],
    "substr": [(c("t"), lit(0), lit(1))],
    "concat": [(c("s"), lit("/"), c("t")), (c("t"), c("t"))],
    # hashes
    "hash": [(c("i64"), c("s")), (c("f64"),)],
    "murmur3_hash": [(c("t"), c("i32"))],
    "xxhash64": [(c("s"), c("i64"), c("d"))],
    # fn_strings
    "concat_ws": [(lit("/"), c("s"), c("t")), (lit(", "), c("t")),
                  (lit(None, "STRING"), c("s")),
                  (lit("--"), c("t"), c("s"), c("t"))],
    "initcap": [(c("s"),)], "repeat": [(c("t"), lit(3)), (c("t"), lit(0))],
    "reverse": [(c("s"),)],
    "lpad": [(c("t"), lit(5), lit("*")), (c("s"), lit(12), lit("ab")),
             (c("s"), lit(3))],
    "rpad": [(c("t"), lit(6), lit("xy")), (c("s"), lit(20))],
    "left": [(c("s"), c("m"))], "right": [(c("s"), c("m")),
                                          (c("t"), lit(2))],
    "space": [(lit(5),)], "ascii": [(c("s"),)],
    "chr": [(c("i64"),)], "char": [(c("i32"),)],
    "instr": [(c("s"), lit("a")), (c("s"), lit("ab")), (c("s"), lit(""))],
    "locate": [(lit("b"), c("s")), (lit("a"), c("s"), c("m"))],
    "position": [(lit("bc"), c("s"), lit(2))],
    "substring_index": [(c("s"), lit("."), lit(1)),
                        (c("s"), lit("."), lit(-2)),
                        (c("s"), lit("abc"), lit(1)),
                        (c("s"), lit("bc"), lit(-1)),
                        (c("s"), lit("X"), lit(2)),
                        (c("t"), lit(""), lit(1))],
    "translate": [(c("s"), lit("abé"), lit("x")), (c("t"), lit("ab"),
                                                     lit("ba"))],
    # fn_dates
    "hour": [(c("ts"),), (c("d"),)], "minute": [(c("ts"),)],
    "second": [(c("ts"),)],
    "date_format": [(c("ts"), lit("yyyy-MM-dd HH:mm:ss.SSS")),
                    (c("d"), lit("dd/MM/yy 'at' hh"))],
    "from_unixtime": [(c("i32"),), (c("n"), lit("yyyy"))],
    "unix_timestamp": [(c("ts"),), (c("s"), lit("yyyy-MM-dd HH:mm:ss"))],
    "to_unix_timestamp": [(c("d"),)],
    "to_date": [(c("ts"),), (c("s"),), (c("s"), lit("yyyy-MM-dd"))],
    "trunc": [(c("d"), lit(u)) for u in ("year", "MM", "quarter", "week",
                                         "day")],
    "date_trunc": [(lit(u), c("ts")) for u in (
        "yyyy", "month", "quarter", "week", "dd", "hour", "minute",
        "second", "ms")],
    "add_months": [(c("d"), c("m")), (c("ts"), lit(13))],
    "last_day": [(c("d"),)],
    "months_between": [(c("ts"), c("d")), (c("d"), c("ts"),
                                          lit(False))],
    "weekofyear": [(c("d"),)],
    "next_day": [(c("d"), lit("Sunday")), (c("d"), lit("xx"))],
    "make_date": [(c("i32"), c("m"), c("n")),
                  (lit(2020), lit(2), c("n"))],
}

FUNCTION_CASES = [(name, i) for name, shapes in FUNCTIONS.items()
                  for i in range(len(shapes))]

#: the nodes, casts and predicates of the slice
NODES = {
    "neg_i64": ("neg", c("i64")), "neg_f64": ("neg", c("f64")),
    "neg_i32": ("neg", c("i32")),
    "case_str": ("case", ((positive("i32"), c("t")),
                          (positive("n"), lit("long literal text"))), c("s")),
    "case_no_else": ("case", ((positive("i64"), c("f64")),), None),
    "case_str_no_else": ("case", ((positive("m"), c("s")),), None),
    "case_nulls": ("case", ((c("b"), c("i32")), (positive("m"), c("n"))),
                   lit(7)),
    "like_exact": ("like", c("s"), "42"),
    "like_exact_long": ("like", c("t"), "longer than eight"),
    "like_prefix": ("like", c("s"), "a%"),
    "like_suffix": ("like", c("s"), "%c"),
    "like_infix": ("like", c("s"), "%b%"),
    "like_chain": ("like", c("s"), "a%b%c"),
    "like_regex": ("like", c("s"), "_._%"),
    "like_regex_neg": ("like", c("s"), "%a_b%", True),
    "startswith": ("startswith", c("s"), "ab"),
    "endswith": ("endswith", c("s"), "c"),
    "contains": ("contains", c("s"), "b"),
    "contains_empty": ("contains", c("t"), ""),
    "contains_long": ("contains", c("t"), "longer than eight"),
    "split_0": ("index", fn("split", c("s"), lit(r"\.")), 0),
    "split_2": ("index", fn("split", c("s"), lit(",")), 2),
    # a float division by a constant, compiled as a reciprocal multiply
    "div_f64_literal": ("/", c("f64"), lit(7.0)),
    "div_i32_literal": ("/", c("i32"), lit(2.5)),
    "div_f32_literal": ("/", c("f32"), lit(3.0, "FLOAT32")),
    "div_f64_zero": ("/", c("f64"), lit(0.0)),
}
for _src, _dst in [("s", "BOOL"), ("s", "INT8"), ("s", "INT32"),
                   ("s", "INT64"), ("s", "FLOAT32"), ("s", "FLOAT64"),
                   ("s", "DATE32"), ("s", "TIMESTAMP_US"), ("b", "STRING"),
                   ("i64", "STRING"), ("i32", "STRING"), ("f64", "STRING"),
                   ("f32", "STRING"), ("d", "STRING"), ("ts", "STRING"),
                   ("d", "TIMESTAMP_US"), ("ts", "DATE32"), ("i32", "DATE32"),
                   ("i64", "TIMESTAMP_US"), ("f64", "INT64"),
                   ("f32", "INT8"), ("i64", "INT16"), ("d", "INT64")]:
    NODES[f"cast_{_src}_{_dst}"] = ("cast", c(_src), _dst)


def reads_floats(spec) -> bool:
    return spec in (c("f64"), c("f32")) or any(
        isinstance(a, tuple) and reads_floats(a) for a in spec[1:])


def subnormal_rows() -> np.ndarray:
    """Live rows whose float64 or float32 input is subnormal: XLA's CPU
    backend flushes those to zero, the port keeps IEEE values (ROADMAP
    Queue 3 item 12; ``test_torch_functions.py::
    test_subnormals_keep_their_ieee_values``)."""
    cols = columns()
    out = np.zeros(ROWS, bool)
    for k in (4, 5):
        x = cols[k][0][:ROWS]
        out |= (x != 0) & (np.abs(x) < np.finfo(x.dtype).tiny)
    return out


def eval_both(spec, batches):
    """(reference TypedValue, port TypedValue) of one spec. The reference
    runs compiled (``jax.jit``), as its operators run it."""
    jb, js, tb, ts = batches
    expr = build(spec, jir, JDT)
    typed = {}

    def run(b):
        v = jeval.evaluate(expr, b, js)
        typed["v"] = v
        return v.col

    col = jax.jit(run)(jb)
    v = typed["v"]
    want = jeval.TypedValue(col, v.dtype, v.precision, v.scale)
    got = teval.evaluate(build(spec, tir, TDT), tb, ts)
    return want, got


def bits(a: np.ndarray) -> np.ndarray:
    """Floats as integers of the same width (NaNs made one pattern)."""
    a = np.where(np.isnan(a), np.nan, a).astype(a.dtype)
    return a.view(np.int64 if a.dtype == np.float64 else np.int32)


def assert_same(want, got, ulps: int = 0, label="", skip=None):
    """Equal result types, and over the live rows (but ``skip``) equal
    validity and equal values where valid."""
    assert got.dtype.value == want.dtype.value, label
    keep = np.ones(ROWS, bool) if skip is None else ~skip
    wv = np.asarray(want.validity)[:ROWS] & keep
    gv = got.validity.numpy()[:ROWS] & keep
    np.testing.assert_array_equal(gv, wv, err_msg=f"{label} validity")
    if hasattr(want.col, "chars"):
        wl = np.asarray(want.col.lens)[:ROWS]
        gl = got.col.lens.numpy()[:ROWS]
        np.testing.assert_array_equal(np.where(wv, gl, 0),
                                      np.where(wv, wl, 0), err_msg=label)
        wc, gc = np.asarray(want.col.chars), got.col.chars.numpy()
        for i in np.flatnonzero(wv):
            assert bytes(gc[i, :gl[i]]) == bytes(wc[i, :wl[i]]), (label, i)
        return
    wd = np.asarray(want.data)[:ROWS]
    gd = got.data.numpy()[:ROWS]
    assert gd.dtype == wd.dtype, (label, gd.dtype, wd.dtype)
    if wd.dtype.kind != "f":
        np.testing.assert_array_equal(gd[wv], wd[wv], err_msg=label)
        return
    gb, wb = bits(gd[wv]), bits(wd[wv])
    if ulps == 0:
        np.testing.assert_array_equal(gb, wb, err_msg=label)
        return
    # within the bound, and the same class (NaN, ±inf, sign, zero)
    same_class = (np.isnan(gd[wv]) == np.isnan(wd[wv])) \
        & ((gd[wv] == wd[wv]) | np.isnan(wd[wv])
           | (np.isfinite(wd[wv]) & np.isfinite(gd[wv])
              & (np.signbit(gd[wv]) == np.signbit(wd[wv]))))
    assert same_class.all(), (label, gd[wv][~same_class],
                              wd[wv][~same_class])
    finite = np.isfinite(wd[wv])
    diff = np.abs(gb[finite].astype(np.int64) - wb[finite].astype(np.int64))
    assert diff.max(initial=0) <= ulps, (label, int(diff.max()))


def function_cases(module: str) -> list:
    """(name, shape index) of every name the reference's ``module``
    (``functions``, ``fn_strings`` or ``fn_dates``) registers."""
    return [(name, i) for name, i in FUNCTION_CASES
            if jfunctions._REGISTRY[name].__module__.rsplit(".", 1)[-1]
            == module]


def check_function(name: str, i: int, batches) -> None:
    """FUNCTIONS[name][i] in both packages: values and inferred types."""
    spec = fn(name, *FUNCTIONS[name][i])
    want, got = eval_both(spec, batches)
    assert_same(want, got, ULP_BOUND if name in ULP_NAMES else 0,
                f"{name}[{i}]", subnormal_rows() if reads_floats(spec)
                else None)
    _jb, js, _tb, ts = batches
    assert teval.infer_dtype(build(spec, tir, TDT), ts)[0].value == \
        jeval.infer_dtype(build(spec, jir, JDT), js)[0].value


def check_node(name: str, batches) -> None:
    want, got = eval_both(NODES[name], batches)
    assert_same(want, got, 0, name, subnormal_rows()
                if reads_floats(NODES[name]) else None)
