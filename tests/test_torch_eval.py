"""The port's expression evaluator against the JAX package's.

One batch of seeded numpy columns, with nulls, zero divisors and a
padded tail, goes to both evaluators; each expression tree is built
twice, once from each package's IR. Data, validity and result types must
be identical: the ops are elementwise and IEEE-exact in both, including
Kleene ``and``/``or``, Java-style integer division and Spark's non-ANSI
casts.

The decimal section holds narrow (precision <= 18, the unscaled int64)
and wide (two limbs) columns with their edge values, and evaluates the
reference compiled (``jax.jit``), as its operators run it: the binary
operators over every pairing of the two representations, integers and
floats, Spark's result types (precision-loss rescale included), the
overflow that nulls a row, and the cast matrix to and from every type,
strings through the host.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar.batch import DeviceBatch as JBatch
from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.columnar.schema import DataType as JDT
from auron_tpu.columnar.schema import Field as JField
from auron_tpu.columnar.schema import Schema as JSchema
from auron_tpu.exprs import eval as jeval
from auron_tpu.exprs import ir as jir
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir

CAP, ROWS = 32, 29
_COLS = ["a", "b", "i32", "i64", "f64", "f32", "i8", "d"]
_TYPES = ["BOOL", "BOOL", "INT32", "INT64", "FLOAT64", "FLOAT32", "INT8",
          "INT32"]


def _columns():
    rng = np.random.default_rng(3)
    tri = np.array([0, 1, 2] * 11)[:CAP]          # false / true / null
    a, b = tri, np.repeat([0, 1, 2], 11)[:CAP]     # all 9 Kleene pairs
    cols = [
        (a == 1, a != 2),
        (b == 1, b != 2),
        (rng.integers(-50, 50, CAP).astype(np.int32), rng.random(CAP) > 0.2),
        (rng.integers(-10**12, 10**12, CAP), rng.random(CAP) > 0.2),
        (np.where(rng.random(CAP) > 0.3, rng.normal(size=CAP) * 10, 0.0),
         rng.random(CAP) > 0.1),
        (rng.normal(size=CAP).astype(np.float32), np.ones(CAP, bool)),
        (rng.integers(-128, 128, CAP).astype(np.int8), rng.random(CAP) > 0.2),
        (rng.integers(-3, 4, CAP).astype(np.int32), np.ones(CAP, bool)),
    ]
    return cols


def _batches():
    cols = _columns()
    jb = JBatch(tuple(JCol(jnp.asarray(d), jnp.asarray(v)) for d, v in cols),
                jnp.asarray(ROWS, jnp.int32))
    tb = batch_from_numpy(cols, ROWS, "cpu")
    js = JSchema(tuple(JField(n, JDT[t]) for n, t in zip(_COLS, _TYPES)))
    ts = TSchema(tuple(TField(n, TDT[t]) for n, t in zip(_COLS, _TYPES)))
    return jb, js, tb, ts


def _build(spec, ir, DT):
    """An expression tree from a nested tuple spec, in one package's IR."""
    head = spec[0]
    if head == "col":
        return ir.ColumnRef(_COLS.index(spec[1]))
    if head == "lit":
        return ir.Literal(spec[1], DT[spec[2]])
    if head in ("not", "is_null", "is_not_null"):
        node = {"not": ir.Not, "is_null": ir.IsNull,
                "is_not_null": ir.IsNotNull}[head]
        return node(_build(spec[1], ir, DT))
    return ir.BinaryExpr(head, _build(spec[1], ir, DT),
                         _build(spec[2], ir, DT))


def _c(name):
    return ("col", name)


EXPRS = {
    "and": ("and", _c("a"), _c("b")),
    "or": ("or", _c("a"), _c("b")),
    "not": ("not", _c("a")),
    "is_null": ("is_null", _c("i32")),
    "is_not_null": ("is_not_null", _c("f64")),
    "and_of_compares": ("and", (">", _c("i32"), ("lit", 10, "INT32")),
                        ("is_not_null", _c("f64"))),
    "or_null_literal": ("or", _c("a"), ("lit", None, "BOOL")),
    "eq_null_literal": ("==", _c("i32"), ("lit", None, "INT32")),
    **{f"cmp{op}_i32_i64": (op, _c("i32"), _c("i64"))
       for op in ("==", "!=", "<", "<=", ">", ">=")},
    "cmp_i8_f32": ("<", _c("i8"), _c("f32")),
    **{f"int{op}": (op, _c("i64"), _c("d"))
       for op in ("+", "-", "*", "/", "%")},
    **{f"f64{op}": (op, _c("f64"), _c("f32"))
       for op in ("+", "-", "*", "/", "%")},
    "f64_div_int_zero": ("/", _c("f64"), _c("d")),
    "i8_wraps": ("*", _c("i8"), ("lit", 3, "INT8")),
    "i32_mod_neg": ("%", _c("i32"), ("lit", -7, "INT32")),
    "nested": ("and", ("or", _c("a"), ("not", _c("b"))),
               ("<=", ("+", _c("i32"), _c("d")), ("lit", 5, "INT64"))),
}


def _np(tv):
    return np.asarray(tv.data), np.asarray(tv.validity)


@pytest.mark.parametrize("name", sorted(EXPRS))
def test_evaluate_matches_reference(name):
    jb, js, tb, ts = _batches()
    spec = EXPRS[name]
    want = jeval.evaluate(_build(spec, jir, JDT), jb, js, jeval.EvalContext())
    got = teval.evaluate(_build(spec, tir, TDT), tb, ts)
    assert got.dtype.value == want.dtype.value
    wd, wv = _np(want)
    gd, gv = got.data.numpy(), got.validity.numpy()
    assert gd.dtype == wd.dtype
    np.testing.assert_array_equal(gv, wv)
    np.testing.assert_array_equal(gd, wd)
    assert teval.infer_dtype(_build(spec, tir, TDT), ts)[0].value == \
        jeval.infer_dtype(_build(spec, jir, JDT), js)[0].value


_CAST_IN = {
    "FLOAT64": np.array([0.0, -0.5, 2.5, -2.5, 2.5e9, -2.5e9, 2.0**63,
                         -2.0**63, 2.0**64, np.nan, np.inf, -np.inf,
                         127.9, -128.9, 1e300, 3.0]),
    "FLOAT32": np.array([0.0, -0.5, 2.5, 3.4e38, -3e9, np.nan, np.inf,
                         1.0, 32767.5, -32768.5, 2.0**31, 7.0, -7.0, 0.0,
                         -1.0, 5.0], np.float32),
    "INT64": np.array([0, 1, -1, 127, 128, -129, 2**31, -2**31 - 1,
                       2**63 - 1, -2**63, 255, 256, 65535, 65536, 3, -3]),
    "BOOL": np.array([True, False] * 8),
}


@pytest.mark.parametrize("src,dst", [
    (s, d) for s in _CAST_IN
    for d in ("BOOL", "INT8", "INT16", "INT32", "INT64", "FLOAT32",
              "FLOAT64") if s != d])
def test_cast_value_matches_reference(src, dst):
    data = _CAST_IN[src]
    valid = np.arange(data.size) % 5 != 4
    want = jeval.cast_value(
        jeval.TypedValue(JCol(jnp.asarray(data), jnp.asarray(valid)),
                         JDT[src]), JDT[dst])
    got = teval.cast_value(
        teval.TypedValue(TCol(torch.from_numpy(data),
                              torch.from_numpy(valid)), TDT[src]), TDT[dst])
    wd, wv = _np(want)
    assert got.dtype.value == want.dtype.value
    np.testing.assert_array_equal(got.validity.numpy(), wv)
    np.testing.assert_array_equal(got.data.numpy(), wd)


@pytest.mark.parametrize("op", ["+", "-", "*", "/", "==", "<", ">="])
def test_binary_simple_matches_reference(op):
    jb, _, tb, _ = _batches()
    jc, tc = jb.columns[4], tb.columns[4]
    jl = jeval.TypedValue(jc, JDT.FLOAT64)
    jr = jeval.TypedValue(JCol(jc.data[::-1], jc.validity[::-1]),
                          JDT.FLOAT64)
    tl = teval.TypedValue(tc, TDT.FLOAT64)
    tr = teval.TypedValue(TCol(tc.data.flip(0), tc.validity.flip(0)),
                          TDT.FLOAT64)
    want = jeval._eval_binary_simple(op, jl, jr)
    got = teval._eval_binary_simple(op, tl, tr)
    wd, wv = _np(want)
    assert got.dtype.value == want.dtype.value
    np.testing.assert_array_equal(got.validity.numpy(), wv)
    np.testing.assert_array_equal(got.data.numpy(), wd)


@pytest.mark.parametrize("a,b", [
    ("INT8", "INT64"), ("INT32", "FLOAT32"), ("INT64", "FLOAT64"),
    ("NULL", "INT16"), ("DECIMAL", "FLOAT32"), ("DECIMAL", "INT32"),
    ("DATE32", "STRING"), ("STRING", "INT32")])
def test_common_type_matches_reference(a, b):
    try:
        want = jeval.common_type(JDT[a], JDT[b]).value
    except TypeError:
        with pytest.raises(TypeError):
            teval.common_type(TDT[a], TDT[b])
        return
    assert teval.common_type(TDT[a], TDT[b]).value == want


class _Negative(tir.Expr):
    pass


def test_unported_nodes_raise_with_their_name():
    _, _, tb, ts = _batches()
    with pytest.raises(NotImplementedError, match="_Negative"):
        teval.evaluate(_Negative(), tb, ts)
    with pytest.raises(NotImplementedError, match="_Negative"):
        teval.infer_dtype(_Negative(), ts)
    with pytest.raises(TypeError, match="GetIndexedField needs a list"):
        teval.evaluate(tir.GetIndexedField(tir.ColumnRef(0), 1), tb, ts)


# ---------------------------------------------------------------------------
# decimals
# ---------------------------------------------------------------------------

import decimal as _pydec

import jax

from auron_tpu.columnar.batch import StringColumn as JStr
from auron_tpu.columnar.decimal128 import Decimal128Column as JDec
from auron_tpu_torch.columnar import decimal128 as D

#: name, (precision, scale) or None, kind
_DEC_COLS = [("n9", (9, 2)), ("n18", (18, 4)), ("w25", (25, 2)),
             ("w38", (38, 10)), ("i64", None), ("f64", None), ("s", None)]
_DEC_ROWS = 62
_STRINGS = ["1.005", "-1.005", "0.5", "-0.5", "12345678901234.567",
            "Infinity", "abc", "", " 42 ", "1e3", "-0", "99999999.995",
            "123456789012345678901234", "-9223372036854775808.4", "7", "-7"]


def _dec_values(rng, p: int, n: int) -> list:
    edge = [0, 1, -1, 10 ** p - 1, -(10 ** p - 1), 10 ** (p // 2),
            -(10 ** (p - 1)) - 5, 5 * 10 ** (p - 2) if p > 2 else 5]
    out = list(edge)
    while len(out) < n:
        digits = int(rng.integers(1, p + 1))
        v = int(rng.integers(0, 10 ** min(digits, 18))) \
            * 10 ** max(0, digits - 18)
        out.append(v if rng.random() < 0.5 else -v)
    return out[:n]


def _dec_batches():
    rng = np.random.default_rng(11)
    cap = _DEC_ROWS + 2
    valid = rng.random(cap) > 0.15
    valid[:8] = True                  # the edge values
    valid[_DEC_ROWS:] = False
    jcols, tcols = [], []
    for name, ps in _DEC_COLS:
        if ps is not None:
            vals = _dec_values(rng, ps[0], cap)
            hi, lo, _v = D.limbs_from_ints(vals, cap)
            if ps[0] <= 18:
                jcols.append(JCol(jnp.asarray(lo), jnp.asarray(valid)))
                tcols.append((lo, valid))
            else:
                jcols.append(JDec(jnp.asarray(hi), jnp.asarray(lo),
                                  jnp.asarray(valid)))
                tcols.append((hi, lo, valid))
        elif name == "i64":
            d = rng.integers(-10 ** 15, 10 ** 15, cap)
            d[:4] = [2 ** 63 - 1, -2 ** 63, 0, 10 ** 17]
            jcols.append(JCol(jnp.asarray(d), jnp.asarray(valid)))
            tcols.append((d, valid))
        elif name == "f64":
            d = np.round(rng.normal(size=cap) * 10 ** rng.integers(
                0, 12, cap), 3)
            d[:8] = [np.nan, np.inf, -np.inf, 0.125, -2.675, 1e30, 0.005,
                     -0.0]
            jcols.append(JCol(jnp.asarray(d), jnp.asarray(valid)))
            tcols.append((d, valid))
        else:
            strs = [_STRINGS[i % len(_STRINGS)] for i in range(cap)]
            chars = np.zeros((cap, 32), np.uint8)
            lens = np.zeros(cap, np.int32)
            for i, t in enumerate(strs):
                b = t.encode()
                chars[i, :len(b)] = np.frombuffer(b, np.uint8)
                lens[i] = len(b)
            jcols.append(JStr(jnp.asarray(chars), jnp.asarray(lens),
                              jnp.asarray(valid)))
            tcols.append((chars, lens, valid))
    fields = [(n, "DECIMAL", ps) if ps else
              (n, {"i64": "INT64", "f64": "FLOAT64", "s": "STRING"}[n],
               (0, 0)) for n, ps in _DEC_COLS]
    js = JSchema(tuple(JField(n, JDT[t], True, *ps) for n, t, ps in fields))
    ts = TSchema(tuple(TField(n, TDT[t], True, *ps) for n, t, ps in fields))
    jb = JBatch(tuple(jcols), jnp.asarray(_DEC_ROWS, jnp.int32))
    return jb, js, batch_from_numpy(tcols, _DEC_ROWS, "cpu"), ts


def _dcol(name):
    return ("dcol", name)


def _dbuild(spec, ir, DT):
    head = spec[0]
    if head == "dcol":
        return ir.ColumnRef([n for n, _ in _DEC_COLS].index(spec[1]),
                            spec[1])
    if head == "dlit":   # (dlit, unscaled, p, s)
        return ir.Literal(spec[1], DT.DECIMAL, spec[2], spec[3])
    if head == "cast":   # (cast, child, type, p, s)
        return ir.Cast(_dbuild(spec[1], ir, DT), DT[spec[2]], spec[3],
                       spec[4])
    if head == "neg":
        return ir.Negative(_dbuild(spec[1], ir, DT))
    return ir.BinaryExpr(head, _dbuild(spec[1], ir, DT),
                         _dbuild(spec[2], ir, DT))


_PAIRS = [("n9", "n18"), ("n18", "n9"), ("n9", "w25"), ("w25", "w38"),
          ("n18", "n18"), ("w38", "w38"), ("w25", "i64"), ("i64", "n9"),
          ("n9", "f64"), ("w38", "f64"), ("w25", "w25")]

DEC_EXPRS = {
    **{f"{a}{op}{b}": (op, _dcol(a), _dcol(b)) for a, b in _PAIRS
       for op in ("+", "-", "*", "/", "==", "<", ">=")},
    "wide_literal": ("+", _dcol("w25"), ("dlit", 10 ** 22 + 7, 24, 1)),
    "narrow_literal": ("*", _dcol("n9"), ("dlit", -1234, 6, 3)),
    "null_wide_literal": ("-", _dcol("w38"), ("dlit", None, 20, 0)),
    "neg_narrow": ("neg", _dcol("n18")),
    "nested": ("<", ("*", _dcol("n9"), _dcol("w25")),
               ("+", _dcol("w38"), _dcol("n18"))),
}

_DEC_TARGETS = [("DECIMAL", 5, 0), ("DECIMAL", 18, 6), ("DECIMAL", 20, 2),
                ("DECIMAL", 38, 0), ("DECIMAL", 38, 20), ("DECIMAL", 9, 2),
                ("INT8", 0, 0), ("INT32", 0, 0), ("INT64", 0, 0),
                ("FLOAT32", 0, 0), ("FLOAT64", 0, 0), ("STRING", 0, 0)]

DEC_CASTS = {
    **{f"{c}_to_{t}{p}_{s}": ("cast", _dcol(c), t, p, s)
       for c in ("n9", "n18", "w25", "w38") for t, p, s in _DEC_TARGETS},
    "n9_to_BOOL": ("cast", _dcol("n9"), "BOOL", 0, 0),
    **{f"f64_to_{p}_{s}": ("cast", _dcol("f64"), "DECIMAL", p, s)
       for p, s in ((9, 2), (18, 3), (20, 4), (38, 10), (38, 0))},
    **{f"i64_to_{p}_{s}": ("cast", _dcol("i64"), "DECIMAL", p, s)
       for p, s in ((18, 2), (10, 0), (25, 0), (38, 18), (38, 22))},
    **{f"s_to_{p}_{s}": ("cast", _dcol("s"), "DECIMAL", p, s)
       for p, s in ((10, 2), (25, 3), (5, 0))},
}


def _dec_eval_both(spec):
    jb, js, tb, ts = _dec_batches()
    expr = _dbuild(spec, jir, JDT)
    typed = {}

    def run(b):
        v = jeval.evaluate(expr, b, js)
        typed["v"] = v
        return v.col

    col = jax.jit(run)(jb)
    v = typed["v"]
    want = jeval.TypedValue(col, v.dtype, v.precision, v.scale)
    got = teval.evaluate(_dbuild(spec, tir, TDT), tb, ts)
    return want, got, (jb, js, tb, ts)


def _assert_dec_same(want, got, label):
    assert (got.dtype.value, got.precision, got.scale) == \
        (want.dtype.value, want.precision, want.scale), label
    n = _DEC_ROWS
    wv = np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(got.validity.numpy()[:n], wv,
                                  err_msg=f"{label} validity")
    if isinstance(got.col, D.Decimal128Column):
        if hasattr(want.col, "hi"):
            wh, wl = np.asarray(want.col.hi), np.asarray(want.col.lo)
        else:
            # a string cast to decimal(p > 18): the reference keeps its
            # int64 parse in a one-limb column, the port sign-extends it
            wl = np.asarray(want.data)
            wh = np.where(wl < 0, -1, 0)
        for g, w in ((got.col.hi, wh), (got.col.lo, wl)):
            np.testing.assert_array_equal(g.numpy()[:n][wv], w[:n][wv],
                                          err_msg=label)
        return
    if hasattr(want.col, "chars"):
        wl, gl = np.asarray(want.col.lens), got.col.lens.numpy()
        wc, gc = np.asarray(want.col.chars), got.col.chars.numpy()
        for i in np.flatnonzero(wv):
            assert bytes(gc[i, :gl[i]]) == bytes(wc[i, :wl[i]]), (label, i)
        return
    wd, gd = np.asarray(want.data)[:n], got.data.numpy()[:n]
    assert gd.dtype == wd.dtype, label
    if wd.dtype.kind == "f":
        wd, gd = wd.view(np.int64 if wd.itemsize == 8 else np.int32), \
            gd.view(np.int64 if gd.itemsize == 8 else np.int32)
    np.testing.assert_array_equal(gd[wv], wd[wv], err_msg=label)


#: a decimal plus or minus a float: XLA's CPU backend contracts the
#: reference's ``x * (1 / 10^s) ± y`` into one fused multiply-add, which
#: rounds once; the port (eager, on the CPU and on CUDA) rounds the
#: product and then the sum
_FMA = {f"{a}{op}f64" for a in ("n9", "w38") for op in ("+", "-")}


def _typed(t):
    return tuple(x.value if hasattr(x, "value") else x for x in t)


@pytest.mark.parametrize("name", sorted(DEC_EXPRS))
def test_decimal_arithmetic_matches_reference(name):
    spec = DEC_EXPRS[name]
    want, got, (_jb, js, tb, ts) = _dec_eval_both(spec)
    assert _typed(teval.infer_dtype(_dbuild(spec, tir, TDT), ts)) == \
        _typed(jeval.infer_dtype(_dbuild(spec, jir, JDT), js))
    if name not in _FMA:
        _assert_dec_same(want, got, name)
        return
    # the port: the float of the decimal (its reciprocal multiply), then
    # the operation, each rounded; the reference within one unit in the
    # last place of it
    x = teval._decimal_to_f64(teval.evaluate(_dbuild(spec[1], tir, TDT),
                                             tb, ts)).data.numpy()
    y = tb.columns[5].data.numpy()
    oracle = x + y if spec[0] == "+" else x - y
    n = _DEC_ROWS
    wv = np.asarray(want.validity)[:n]
    np.testing.assert_array_equal(got.validity.numpy()[:n], wv)
    gd, wd = got.data.numpy()[:n][wv], np.asarray(want.data)[:n][wv]
    np.testing.assert_array_equal(gd.view(np.int64),
                                  oracle[:n][wv].view(np.int64))
    fin = np.isfinite(wd)
    assert np.array_equal(np.isnan(gd), np.isnan(wd))
    assert np.abs(gd[fin].view(np.int64)
                  - wd[fin].view(np.int64)).max(initial=0) <= 1


def _spark_integer_cast_validity(want, tb, p: int, s: int):
    """The reference's integer cast to decimal(p <= 18) with Spark's
    nulls: a row whose value does not fit in p digits at scale s is null
    (the reference scales first, so int64.min passes its check: ROADMAP
    Queue 3 item 24, where the port departs from it)."""
    i = [n for n, _ in _DEC_COLS].index("i64")
    fits = np.array([abs(int(d)) * 10 ** s < 10 ** p
                     for d in tb.columns[i].data.tolist()])
    return jeval.TypedValue(
        JCol(want.col.data, jnp.asarray(np.asarray(want.validity) & fits)),
        want.dtype, want.precision, want.scale)


@pytest.mark.parametrize("name", sorted(DEC_CASTS))
def test_decimal_cast_matrix_matches_reference(name):
    spec = DEC_CASTS[name]
    want, got, (_jb, _js, tb, _ts) = _dec_eval_both(spec)
    if spec[1] == _dcol("i64") and spec[3] <= 18:
        want = _spark_integer_cast_validity(want, tb, spec[3], spec[4])
    _assert_dec_same(want, got, name)


def test_decimal_overflow_nulls_rows():
    """w38 + w38 and w38 * w38 overflow decimal(38): both packages null
    the same rows, and some rows are nulled."""
    for op in ("+", "*"):
        want, got, _ = _dec_eval_both((op, _dcol("w38"), _dcol("w38")))
        _assert_dec_same(want, got, op)
        _jb, _js, tb, _ts = _dec_batches()
        live = tb.columns[3].validity.numpy()[:_DEC_ROWS]
        assert (live & ~got.validity.numpy()[:_DEC_ROWS]).any(), op


def test_wide_decimal_to_string_is_plain():
    """The host formats a wide decimal in plain digits, never scientific
    (Python's ``decimal`` at 60 digits)."""
    _jb, _js, tb, ts = _dec_batches()
    got = teval.evaluate(_dbuild(("cast", _dcol("w38"), "STRING", 0, 0),
                                 tir, TDT), tb, ts)
    col = tb.columns[3]
    ints = D.ints_from_limbs(col.hi.numpy(), col.lo.numpy(),
                             col.validity.numpy())
    for i in range(_DEC_ROWS):
        if ints[i] is None:
            continue
        with _pydec.localcontext() as ctx:
            ctx.prec = 60
            want = format(_pydec.Decimal(ints[i]).scaleb(-10), "f")
        n = int(got.col.lens[i])
        assert bytes(got.col.chars[i, :n].numpy()).decode() == want


def _round_spec(name, column, digits):
    return lambda ir, DT: ir.ScalarFunction(
        name, (_dbuild(_dcol(column), ir, DT),
               ir.Literal(digits, DT.INT32)))


@pytest.mark.parametrize("digits", [0, 1, 3])
def test_decimal_round_matches_reference(digits):
    """round(decimal(p <= 18)) HALF_UP, as the reference computes it: the
    unscaled value at scale ``digits``, the input's precision."""
    jb, js, tb, ts = _dec_batches()
    for column in ("n9", "n18"):
        spec = _round_spec("round", column, digits)
        want = jeval.evaluate(spec(jir, JDT), jb, js)
        got = teval.evaluate(spec(tir, TDT), tb, ts)
        _assert_dec_same(want, got, f"round({column}, {digits})")


@pytest.mark.parametrize("name", ["round", "bround"])
def test_decimal_rounding_matches_python_decimal(name):
    """round (HALF_UP) and bround (HALF_EVEN) of narrow and wide
    decimals against Python's ``decimal`` (the reference cannot round a
    wide decimal, and its bround of a decimal gives floats: ROADMAP
    Queue 3), with the inferred type equal to the evaluated one."""
    _jb, _js, tb, ts = _dec_batches()
    mode = _pydec.ROUND_HALF_UP if name == "round" else _pydec.ROUND_HALF_EVEN
    for i, column in enumerate(("n9", "n18", "w25", "w38")):
        p, s = dict(_DEC_COLS)[column]
        for digits in (0, 1, s - 1):
            expr = _round_spec(name, column, digits)(tir, TDT)
            got = teval.evaluate(expr, tb, ts)
            assert teval.infer_dtype(expr, ts) == (TDT.DECIMAL, p, digits)
            assert (got.precision, got.scale) == (p, digits)
            col = tb.columns[i]
            if isinstance(col, D.Decimal128Column):
                ints = D.ints_from_limbs(col.hi.numpy(), col.lo.numpy(),
                                         col.validity.numpy())
                out = D.ints_from_limbs(got.col.hi.numpy(),
                                        got.col.lo.numpy(),
                                        got.validity.numpy())
            else:
                ints = [int(x) if ok else None for x, ok in
                        zip(col.data.numpy(), col.validity.numpy())]
                out = [int(x) if ok else None for x, ok in
                       zip(got.data.numpy(), got.validity.numpy())]
            for x, y in list(zip(ints, out))[:_DEC_ROWS]:
                if x is None:
                    assert y is None
                    continue
                with _pydec.localcontext() as ctx:
                    ctx.prec = 60
                    want = _pydec.Decimal(x).scaleb(-s).quantize(
                        _pydec.Decimal(1).scaleb(-digits), rounding=mode)
                    assert _pydec.Decimal(y).scaleb(-digits) == want, \
                        (name, column, digits, x, y)


#: integers whose product with 10^scale leaves int64 (ROADMAP Queue 3
#: item 24), the int64 edges, and small values beside them
_WRAP_INTS = [1844674407370955162, 922337203685477581, 2 ** 62,
              np.iinfo(np.int64).min, np.iinfo(np.int64).max, 0, 7, -7,
              99999, -99999]


@pytest.mark.parametrize("p,s", [(5, 1), (18, 2), (18, 0), (10, 9)])
def test_integer_cast_to_narrow_decimal_nulls_what_does_not_fit(p, s):
    """An int64 cast to decimal(p <= 18, s) is the value itself where it
    fits in p digits at scale s, and null (Spark's non-ANSI cast)
    everywhere else, the int64 edges included: the port bounds the
    integer before it scales it, so no product wraps."""
    vals = np.array(_WRAP_INTS, np.int64)
    batch = batch_from_numpy([(vals, np.ones(vals.size, bool))], vals.size,
                             "cpu")
    schema = TSchema((TField("i", TDT.INT64),))
    tv = teval.evaluate(tir.Cast(tir.ColumnRef(0), TDT.DECIMAL, p, s), batch,
                        schema, teval.EvalContext())
    assert (tv.dtype, tv.precision, tv.scale) == (TDT.DECIMAL, p, s)
    got = [int(d) if ok else None for d, ok in
           zip(tv.col.data.tolist(), tv.col.validity.tolist())]
    with _pydec.localcontext() as ctx:
        ctx.prec = 60
        want = []
        for v in _WRAP_INTS:
            unscaled = _pydec.Decimal(int(v)).scaleb(s)
            want.append(int(unscaled) if abs(unscaled) < 10 ** p else None)
    assert got == want
