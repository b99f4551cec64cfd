"""The port's array and map functions against the JAX package's, on the
CPU.

- ``it/nested.py``'s sweep, which calls all 31 array, map and struct
  functions over a parquet file of nested columns (null lists, empty
  lists, null elements, null map values), through each package's
  Session: the same task bytes, then every output cell equal (lists,
  maps and structs value for value, floats bit for bit);
- the cases of ``tests/test_map_struct.py``, ``test_string_lists.py``
  and ``test_functions_ext.py``, through a project over one batch in
  each package: duplicate map keys (LAST_WIN), a null key nulling its
  row, ``element_at`` past either end, ``split`` with a limit and with a
  zero-width regex, ``array_join`` with and without a null replacement
  or separator, ``str_to_map`` with other delimiters, ``sort_array``
  over strings both ways, and the set operations over NaN;
- the golden values of ``tests/test_functions_ext.py``'s array and map
  tests (``test_array_functions``, ``test_sort_array_and_getitem``,
  ``test_map_functions``) through the port's scan → project → collect;
- ``auron.map.key_dedup_policy=EXCEPTION`` raises in the port, which
  evaluates eagerly (ROADMAP Queue 3).
"""

import struct
from types import SimpleNamespace

import pyarrow as pa
import pytest
import torch

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops.project import ProjectOp as RProject
from auron_tpu.runtime.executor import collect as rcollect
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.it import nested
from auron_tpu_torch.it.comparator import compare_cells
from auron_tpu_torch.ops.project import ProjectOp as TProject
from auron_tpu_torch.runtime.executor import collect as tcollect

RDSL = SimpleNamespace(col=rdf.col, lit=rdf.lit, F=rdf.functions,
                       DataType=RDT)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_sweep_calls_every_function():
    from auron_tpu_torch.exprs import functions as tfunctions
    nested_names = {n for n, f in tfunctions._REGISTRY.items()
                    if f.__module__.rsplit(".", 1)[-1]
                    in ("fn_arrays", "fn_structs")}
    assert set(nested.SWEEP_FUNCTIONS) == nested_names
    assert len(nested_names) == 31


def test_sweep_matches_reference(tmp_path):
    files = nested.write_nested(str(tmp_path), 400)
    tdf_ = nested.function_sweep_dataframe(TSession(device="cpu"), files)
    rdf_ = nested.function_sweep_dataframe(RSession(), files, dsl=RDSL)
    assert tdf_.task_bytes() == rdf_.task_bytes()
    got, want = tdf_.collect(), rdf_.collect()
    bad, _ulps = compare_cells(want, got)
    assert not bad, bad


def _rb():
    nan = float("nan")
    return pa.record_batch({
        "k": pa.array([1, 2, 3, 4], pa.int64()),
        "li": pa.array([[3, 1, None, 3], [], None, [7, 8]],
                       pa.list_(pa.int64())),
        "lf": pa.array([[nan, 1.0, nan, -0.0], [0.0], [], None],
                       pa.list_(pa.float64())),
        "ls": pa.array([["b", None, "a", "ab"], ["zz"], None, []],
                       pa.list_(pa.string())),
        "s": pa.array(["a=1;b=2;a=3", "x", None, "k=;=v"], pa.string()),
        "t": pa.array(["a1b22c", "", None, "123"], pa.string()),
    })


def _project(pkg, make):
    rb = _rb()
    if pkg == "port":
        ir, DT = tir, TDT
        scan = TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                    capacity=8, device="cpu")
        exprs = make(ir, DT)
        return tcollect(TProject(scan, exprs,
                                 [f"e{i}" for i in range(len(exprs))]))
    ir, DT = rir, RDT
    scan = RMem([[rb]], rbridge.schema_from_arrow(rb.schema), capacity=8)
    exprs = make(ir, DT)
    return rcollect(RProject(scan, exprs,
                             [f"e{i}" for i in range(len(exprs))]))


def _cases(ir, DT):
    C, L = ir.ColumnRef, ir.Literal

    def fn(name, *a):
        return ir.ScalarFunction(name, tuple(a))

    return [
        fn("map", C(0), L(1, DT.INT64), C(0), L(2, DT.INT64)),
        fn("map", L(None, DT.INT64), C(0)),
        fn("map_from_arrays", C(1), C(1)),
        fn("element_at", C(1), L(-1, DT.INT64)),
        fn("element_at", C(1), L(5, DT.INT64)),
        fn("element_at", C(3), L(-4, DT.INT64)),
        fn("split", C(5), L("[0-9]", DT.STRING)),
        fn("split", C(5), L("", DT.STRING)),
        fn("split", C(5), L("[0-9]+", DT.STRING), L(2, DT.INT64)),
        fn("array_join", C(3), L(",", DT.STRING)),
        fn("array_join", C(3), L(",", DT.STRING), L("~", DT.STRING)),
        fn("array_join", C(3), L(None, DT.STRING)),
        fn("str_to_map", C(4), L(";", DT.STRING), L("=", DT.STRING)),
        fn("sort_array", C(3)),
        fn("sort_array", C(3), L(False, DT.BOOL)),
        fn("sort_array", C(2)),
        fn("array_distinct", C(2)),
        fn("array_union", C(2), C(2)),
        fn("array_contains", C(1), L(3, DT.INT64)),
        fn("array_contains", C(1), L(9, DT.INT64)),
        fn("arrays_overlap", C(1), C(1)),
        fn("size", C(1)),
        fn("map_keys", fn("str_to_map", C(4), L(";", DT.STRING),
                          L("=", DT.STRING))),
    ]


def _bits(x):
    """A cell as something ``==`` compares exactly: floats by their bits
    (NaN equal to NaN of the same bits), containers element-wise."""
    if isinstance(x, float):
        return struct.pack("<d", x)
    if isinstance(x, (list, tuple)):
        return type(x)(_bits(e) for e in x)
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    return x


def test_unit_cases_match_reference():
    got = _project("port", _cases)
    want = _project("ref", _cases)
    assert got.schema == want.schema
    for name in want.column_names:
        assert _bits(got[name].to_pylist()) == _bits(want[name].to_pylist()), \
            name


def test_duplicate_keys_last_win():
    got = _project("port", lambda ir, DT: [ir.ScalarFunction("map", (
        ir.ColumnRef(0), ir.Literal(1, DT.INT64), ir.ColumnRef(0),
        ir.Literal(2, DT.INT64)))])
    assert got["e0"].to_pylist()[0] == [(1, 2)]


def test_exception_policy_raises():
    conf = tcfg.get_config()
    conf.set(tcfg.MAP_KEY_DEDUP_POLICY, "EXCEPTION")
    try:
        with pytest.raises(ValueError, match="duplicate map key"):
            _project("port", lambda ir, DT: [ir.ScalarFunction("map", (
                ir.ColumnRef(0), ir.Literal(1, DT.INT64), ir.ColumnRef(0),
                ir.Literal(2, DT.INT64)))])
    finally:
        conf.unset(tcfg.MAP_KEY_DEDUP_POLICY)


def _golden_cases():
    """(reference test, batch, expression builder, expected values)."""
    ab = pa.record_batch({"a": pa.array([1, 5, 3], pa.int64()),
                          "b": pa.array([2, None, 4], pa.int64()),
                          "k": pa.array([2, 2, 9], pa.int64())})
    kv = pa.record_batch({"k1": pa.array([1, 1], pa.int64()),
                          "v1": pa.array([10, 11], pa.int64()),
                          "k2": pa.array([2, 1], pa.int64()),
                          "v2": pa.array([20, 21], pa.int64()),
                          "q": pa.array([2, 1], pa.int64())})
    abc = pa.record_batch({"a": pa.array([3, 1], pa.int64()),
                           "b": pa.array([1, 2], pa.int64()),
                           "c": pa.array([2, 0], pa.int64())})
    C = tir.ColumnRef

    def fn(name, *args):
        return tir.ScalarFunction(name, tuple(args))

    arr = fn("array", C(0), C(1))
    m = fn("map", C(0), C(1), C(2), C(3))
    one, minus_one = (tir.Literal(v, TDT.INT32) for v in (1, -1))
    return [
        ("test_array_functions", ab, fn("size", arr), [2, 2, 2]),
        # array(5, NULL) holds no 2: Spark's three-valued contains
        ("test_array_functions", ab, fn("array_contains", arr, C(2)),
         [True, None, False]),
        ("test_array_functions", ab, fn("array_position", arr, C(2)),
         [2, 0, 0]),
        ("test_array_functions", ab, fn("array_max", arr), [2, 5, 4]),
        ("test_array_functions", ab, fn("array_min", arr), [1, 5, 3]),
        ("test_array_functions", ab, fn("element_at", arr, minus_one),
         [2, None, 4]),
        ("test_sort_array_and_getitem", abc, tir.GetIndexedField(
            fn("sort_array", fn("array", C(0), C(1), C(2))), 0), [1, 0]),
        # a duplicate key keeps the later value (LAST_WIN), counts once
        ("test_map_functions", kv, fn("element_at", m, C(4)), [20, 21]),
        ("test_map_functions", kv, fn("size", m), [2, 1]),
        ("test_map_functions", kv,
         fn("element_at", fn("map_keys", m), one), [1, 1]),
    ]


@pytest.mark.parametrize("k", range(10))
def test_golden_values_of_the_reference_tests(k):
    _source, rb, expr, want = _golden_cases()[k]
    scan = TMem([[rb]], tbridge.schema_from_arrow(rb.schema), capacity=4,
                device="cpu")
    got = tcollect(TProject(scan, [expr], ["out"]))
    assert got["out"].to_pylist() == want
