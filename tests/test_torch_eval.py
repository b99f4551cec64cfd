"""The port's expression evaluator against the JAX package's.

One batch of seeded numpy columns, with nulls, zero divisors and a
padded tail, goes to both evaluators; each expression tree is built
twice, once from each package's IR. Data, validity and result types must
be identical: the ops are elementwise and IEEE-exact in both, including
Kleene ``and``/``or``, Java-style integer division and Spark's non-ANSI
casts.
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
    with pytest.raises(NotImplementedError, match="decimal"):
        teval.evaluate(tir.Literal(1, TDT.DECIMAL), tb, ts)
