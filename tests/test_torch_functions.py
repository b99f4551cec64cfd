"""The port's scalar function registry against the JAX package's.

The cases of ``torch_function_cases.py`` (one seeded batch with nulls,
empty strings, bytes above 0x7F, INT64_MIN, ±0.0, NaN and negative
dates) for every name the reference's ``exprs/functions.py`` registers
(dates, math, nulls, strings, hashes), each over several argument
shapes, evaluated in both packages: validity, values and result types
equal over the live rows, floats bit for bit, but the transcendental
family within ``ULP_BOUND`` units in the last place. Also:

- the port's registry is exactly the union of the reference's
  ``functions.py``, ``fn_strings.py``, ``fn_dates.py``, ``fn_arrays.py``
  and ``fn_structs.py`` registries (the last two held against the
  reference in ``test_torch_fn_arrays.py`` and ``test_torch_fn_structs.py``);
  every other reference name raises ``NotImplementedError`` naming
  ROADMAP item 17b (crypto, json, regex);
- cube roots (``cbrt(64)`` is the reference's 3.9999999999999996) and
  the bounded family's special values are exact; a subnormal input
  keeps its IEEE value in the port where XLA's CPU backend flushes it
  (ROADMAP Queue 3 item 12);
- the common-subexpression memo evaluates a repeated subtree once;
- the reference's golden vectors (``torch_function_vectors.py``) through
  the port's scan → project → collect.
"""

import math

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
from auron_tpu.exprs import functions as jfunctions
from auron_tpu.exprs import ir as jir
from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import functions as tfunctions
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.io.parquet import MemoryScanOp
from auron_tpu_torch.ops.project import ProjectOp
from auron_tpu_torch.runtime.executor import collect
from tests import torch_function_cases as cases
from tests import torch_function_vectors as vectors
from tests.torch_function_cases import COLS, c, fn


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def batches():
    return cases.batches()


@pytest.mark.parametrize("name,i", cases.function_cases("functions"))
def test_function_equals_reference(name, i, batches):
    cases.check_function(name, i, batches)


def test_cube_roots_and_special_values_are_exact():
    """cbrt of exact cubes (``pow`` alone gives 3.9999999999999996 for
    64), and the special values of the bounded family, equal the
    reference's bit for bit."""
    x = np.array([64.0, -27.0, 8.0, 1e-300, 0.0, -0.0, np.inf, -np.inf,
                  np.nan, 1.0, 1000.0, 3.375], np.float64)
    n = len(x)
    jb = JBatch((JCol(jnp.asarray(x), jnp.ones(n, bool)),),
                jnp.asarray(n, jnp.int32))
    tb = batch_from_numpy([(x, np.ones(n, bool))], n, "cpu")
    js = JSchema((JField("x", JDT.FLOAT64),))
    ts = TSchema((TField("x", TDT.FLOAT64),))
    for name in ("cbrt", "exp", "log10", "sin", "tanh", "expm1"):
        want = jeval.evaluate(jir.ScalarFunction(name, (jir.ColumnRef(0),)),
                              jb, js)
        got = teval.evaluate(tir.ScalarFunction(name, (tir.ColumnRef(0),)),
                             tb, ts)
        w, g = np.asarray(want.data), got.data.numpy()
        exact = ~np.isfinite(x) | (x == 0) \
            if name != "cbrt" else np.ones(n, bool)
        np.testing.assert_array_equal(cases.bits(g[exact]), cases.bits(w[exact]),
                                      err_msg=name)


def test_subnormals_keep_their_ieee_values(batches):
    """The one subnormal float64 input (1e-310): the reference's CPU
    backend flushes it to zero; the port computes on it as IEEE does."""
    _jb, _js, tb, ts = batches
    row = int(np.flatnonzero(cases.subnormal_rows())[0])
    x = cases.columns()[4][0][row]
    for name, want in (("sqrt", np.sqrt(x)), ("ceil", 1), ("log10", -310.0),
                       ("signum", 1.0)):
        got = teval.evaluate(tir.ScalarFunction(name, (
            tir.ColumnRef(COLS.index("f64")),)), tb, ts)
        assert got.data[row].item() == pytest.approx(want, rel=1e-15), name
    s = teval.evaluate(tir.Cast(tir.ColumnRef(COLS.index("f64")),
                                TDT.STRING), tb, ts)
    assert bytes(s.col.chars[row, :s.col.lens[row]].tolist()) == b"1.0E-310"


def test_memo_evaluates_each_subexpression_once(batches, monkeypatch):
    _jb, _js, tb, ts = batches
    calls = []
    real = tfunctions._REGISTRY["upper"]
    monkeypatch.setitem(tfunctions._REGISTRY, "upper",
                        lambda *a: calls.append(1) or real(*a))
    up = fn("upper", c("s"))
    spec = fn("concat", up, up)
    ctx = teval.EvalContext(memo={})
    teval.evaluate(cases.build(spec, tir, TDT), tb, ts, ctx)
    assert len(calls) == 1
    teval.evaluate(cases.build(spec, tir, TDT), tb, ts)
    assert len(calls) == 3


def test_memo_keeps_signed_zero_literals_apart():
    """``x * 0.0`` beside ``x * -0.0`` (and ``+``) in one select: the trees
    compare equal, since 0.0 == -0.0, but each keeps its own sign of zero
    (the reference's memo shares one result; ROADMAP Queue 3 item 15)."""
    import pyarrow as pa
    x = np.array([-0.0, 0.0, 1.5, -2.0])
    rb = pa.record_batch([pa.array(x)], names=["x"])
    scan = MemoryScanOp([[rb]], schema_from_arrow(rb.schema), capacity=16,
                        device="cpu")
    ref = tir.ColumnRef(0)
    exprs, want = [], []
    for op, f in (("*", np.multiply), ("+", np.add)):
        for z in (0.0, -0.0):
            exprs.append(tir.BinaryExpr(op, ref, tir.Literal(z, TDT.FLOAT64)))
            want.append(f(x, z))
    names = [f"e{i}" for i in range(len(exprs))]
    got = collect(ProjectOp(scan, exprs, names))
    for name, w in zip(names, want):
        g = got.column(name).to_numpy()
        np.testing.assert_array_equal(cases.bits(g), cases.bits(w),
                                      err_msg=name)


def test_registry_is_the_references():
    ref = {n for n, f in jfunctions._REGISTRY.items()
           if f.__module__.rsplit(".", 1)[-1]
           in ("functions", "fn_strings", "fn_dates")}
    assert len(ref) == 101
    nested = {n for n, f in jfunctions._REGISTRY.items()
              if f.__module__.rsplit(".", 1)[-1]
              in ("fn_arrays", "fn_structs")}
    assert len(nested) == 31
    assert set(tfunctions._REGISTRY) == ref | nested
    rest = set(jfunctions._REGISTRY) - ref - nested
    assert set(tfunctions.LATER) == rest
    assert set(cases.FUNCTIONS) == ref


@pytest.mark.parametrize("name", sorted(tfunctions.LATER))
def test_later_names_raise_naming_their_item(name, batches):
    _jb, _js, tb, ts = batches
    expr = tir.ScalarFunction(name, (tir.ColumnRef(0),))
    item = tfunctions.LATER[name]
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        teval.evaluate(expr, tb, ts)
    with pytest.raises(NotImplementedError, match=f"item {item}"):
        teval.infer_dtype(expr, ts)


def test_decimal_casts_and_list_access_raise(batches):
    """Casts to decimal(0, 0) evaluate as the reference's (the decimal
    cast matrix is ``test_torch_eval.py``'s), but int64.min, which
    passes the reference's wrapped range check and is null in Spark and
    the port (ROADMAP Queue 3 item 24); a list access evaluates as the
    reference's."""
    _jb, _js, tb, ts = batches
    i64 = tb.columns[cases.COLS.index("i64")].data.numpy()[:cases.ROWS]
    wraps = i64 == np.iinfo(np.int64).min
    for spec in (("cast", c("s"), "DECIMAL"), ("cast", c("i64"), "DECIMAL")):
        want, got = cases.eval_both(spec, batches)
        skip = wraps if spec[1] == c("i64") else None
        cases.assert_same(want, got, 0, repr(spec), skip=skip)
        if skip is not None:
            assert skip.any()
            assert not got.validity.numpy()[:cases.ROWS][skip].any()
    jb, js = _jb, _js
    got = teval.evaluate(tir.GetIndexedField(tir.ScalarFunction(
        "array", (tir.ColumnRef(2),)), 0), tb, ts)
    want = jeval.evaluate(jir.GetIndexedField(jir.ScalarFunction(
        "array", (jir.ColumnRef(2),)), 0), jb, js)
    n = cases.ROWS
    gv = got.validity.numpy()[:n]
    np.testing.assert_array_equal(gv, np.asarray(want.validity)[:n])
    np.testing.assert_array_equal(got.data.numpy()[:n][gv],
                                  np.asarray(want.data)[:n][gv])


@pytest.mark.parametrize("k", range(len(vectors.CASES)))
def test_golden_vector(k):
    import pyarrow as pa
    source, make, arrays, expected, approx = vectors.CASES[k]
    rb = pa.record_batch(arrays)
    scan = MemoryScanOp([[rb]], schema_from_arrow(rb.schema),
                        capacity=max(16, 1 << (rb.num_rows - 1)
                                     .bit_length()), device="cpu")
    got = collect(ProjectOp(scan, [make(tir, TDT)], ["out"])) \
        .column("out").to_pylist()
    assert len(got) == len(expected), source
    for i, (g, e) in enumerate(zip(got, expected)):
        if isinstance(e, float) and g is not None and math.isnan(e):
            assert isinstance(g, float) and math.isnan(g), (source, i, g)
        elif approx and isinstance(e, float) and g is not None:
            assert g == pytest.approx(e, rel=1e-12), (source, i, g, e)
        else:
            assert g == e, (source, i, g, e)
