"""The port's sort, range partitioning and Cast against the JAX
package's, on the CPU.

The same seeded numpy columns go to both packages:

- ``order_words`` / ``sort_key_words`` over bool, int8–int64 (their min
  and max included) and float32/float64 (NaN, ±0.0, ±inf, a subnormal),
  nulls first and last, ascending and descending: the port's int64 words
  mapped back to uint64 are bit-identical to the reference's;
- ``sort_permutation`` over keys with runs of equal values, nulls and
  padding rows: the permutation is identical (ties keep input order);
- ``_concat_all`` and ``SortOp`` (no fetch, a fetch below and above the
  row count, one and several input batches): rows identical in order;
- ``compute_range_bounds`` and ``RangePartitioning.partition_ids``:
  bounds and partition ids identical; a range ``ShuffleExchangeOp``
  that samples its own bounds gives each partition the reference's rows
  in the reference's order;
- ``Cast`` through ``evaluate``: int → float64, float → int (truncated;
  NaN, ±inf and out-of-range values null) and bool → int, data, validity
  and type identical;
- decimal keys: a wide column's two words (its limbs' signed order, the
  ±2^63 and carry edges, ties) and a narrow one's, in every order; the
  permutation, SortOp's rows over Arrow decimal columns, and the range
  bounds and partition ids over a wide key.

There is no tolerance anywhere here: every comparison is exact.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.columnar.batch import DeviceBatch as JBatch
from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.columnar.schema import DataType as JDT
from auron_tpu.columnar.schema import Field as JField
from auron_tpu.columnar.schema import Schema as JSchema
from auron_tpu.exprs import eval as jeval
from auron_tpu.exprs import ir as rir
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops import sort as rsort
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.parallel import partitioning as rpart
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field, Schema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ops import sort as tsort
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.ops.base import PhysicalOp
from auron_tpu_torch.parallel import partitioning as tpart
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle

REF = SimpleNamespace(ir=rir, sort=rsort, part=rpart, Mem=RMem, Ctx=RCtx,
                      Shuffle=RShuffle, bridge=rbridge)
PORT = SimpleNamespace(ir=tir, sort=tsort, part=tpart,
                       Mem=functools.partial(TMem, device="cpu"), Ctx=TCtx,
                       Shuffle=TShuffle, bridge=tbridge)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _edge(dtype: str) -> np.ndarray:
    """Values of one type with its edges: min and max for integers; NaN,
    ±0.0, ±inf and a subnormal for floats; ties everywhere."""
    rng = np.random.default_rng(5)
    if dtype == "bool":
        return rng.random(24) > 0.5
    if dtype.startswith("int"):
        info = np.iinfo(dtype)
        v = rng.integers(-3, 4, 24).astype(dtype)
        v[:4] = [info.min, info.max, info.min + 1, 0]
        return v
    v = rng.normal(size=24).astype(dtype)
    tiny = np.finfo(dtype).smallest_subnormal
    v[:10] = [np.nan, 0.0, -0.0, np.inf, -np.inf, tiny, -tiny, 1.0, -1.0,
              np.nan]
    v[10:14] = v[:4]
    return v


DTYPES = ["bool", "int8", "int16", "int32", "int64", "float32", "float64"]
ORDERS = [(True, True), (True, False), (False, True), (False, False)]


def _valid(n: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).random(n) > 0.25


@pytest.mark.parametrize("asc,nf", ORDERS,
                         ids=[f"{'asc' if a else 'desc'}-nulls_"
                              f"{'first' if f else 'last'}"
                              for a, f in ORDERS])
@pytest.mark.parametrize("dtype", DTYPES)
def test_sort_key_words_match_reference(dtype, asc, nf):
    v = _edge(dtype)
    ok = _valid(v.size, 1)
    want = rsort.sort_key_words([JCol(jnp.asarray(v), jnp.asarray(ok))],
                                [(asc, nf)])
    got = tsort.sort_key_words([TCol(torch.from_numpy(v.copy()),
                                     torch.from_numpy(ok))], [(asc, nf)])
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == torch.int64
        np.testing.assert_array_equal(tsort.words_to_uint64(g),
                                      np.asarray(w))
    # the value words alone, nulls not neutralized
    w_only = rsort.order_words(JCol(jnp.asarray(v), jnp.asarray(ok)), asc,
                               nf)
    g_only = tsort.order_words(TCol(torch.from_numpy(v.copy()),
                                    torch.from_numpy(ok)), asc, nf)
    np.testing.assert_array_equal(tsort.words_to_uint64(g_only[0]),
                                  np.asarray(w_only[0]))


def _key_batch(cap: int, rows: int, seed: int):
    """Columns with long runs of equal keys and nulls, in both packages:
    int64 in [0, 4), float64 of 3 values with -0.0 beside 0.0, int8."""
    rng = np.random.default_rng(seed)
    cols = [(rng.integers(0, 4, cap).astype(np.int64), _valid(cap, seed)),
            (rng.choice([0.0, -0.0, 2.5], cap), _valid(cap, seed + 1)),
            (rng.integers(-2, 2, cap).astype(np.int8), _valid(cap, seed + 2))]
    jb = JBatch(tuple(JCol(jnp.asarray(d), jnp.asarray(v)) for d, v in cols),
                jnp.asarray(rows, jnp.int32))
    return jb, batch_from_numpy(cols, rows, "cpu")


PERM_CASES = {
    "one_int_key": ([0], [(True, True)]),
    "float_desc_then_int": ([1, 0], [(False, True), (True, False)]),
    "three_keys_mixed": ([2, 1, 0], [(False, False), (True, True),
                                     (False, True)]),
}


@pytest.mark.parametrize("case", sorted(PERM_CASES))
def test_sort_permutation_matches_reference(case):
    idx, orders = PERM_CASES[case]
    jb, tb = _key_batch(64, 50, seed=len(case))
    want = rsort.sort_permutation(jb, [jb.columns[i] for i in idx], orders)
    got = tsort.sort_permutation(tb, [tb.columns[i] for i in idx], orders)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# SortOp over a memory scan
# ---------------------------------------------------------------------------

def _record_batches(rows: int, batch: int, seed: int = 9):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 6, rows)
    w = rng.choice([1.5, -0.0, 0.0, np.nan, 7.25], rows)
    v = rng.integers(-100, 100, rows)
    kv, wv = _valid(rows, seed), _valid(rows, seed + 1)
    return [pa.record_batch({
        "k": pa.array(k[i:i + batch], pa.int64(), mask=~kv[i:i + batch]),
        "w": pa.array(w[i:i + batch], pa.float64(), mask=~wv[i:i + batch]),
        "v": pa.array(v[i:i + batch], pa.int64())})
        for i in range(0, rows, batch)]


def _orders(ns):
    C = ns.ir.ColumnRef
    return [ns.ir.SortOrder(C(1), False, True),
            ns.ir.SortOrder(C(0), True, False)]


def _run(ns, op, partitions: int = 1) -> list[pa.Table]:
    """Each partition's output as one table."""
    out = []
    schema = ns.bridge.schema_to_arrow(op.schema())
    for p in range(partitions):
        ctx = ns.Ctx(partition_id=p, num_partitions=partitions)
        bs = [ns.bridge.to_arrow(b, op.schema()) for b in op.execute(p, ctx)
              if int(b.num_rows)]
        out.append(pa.Table.from_batches(bs, schema=schema) if bs
                   else schema.empty_table())
    return out


def _same_rows(got: pa.Table, want: pa.Table) -> None:
    """Identical rows in identical order; NaN equals NaN."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got[name].to_pylist(), want[name].to_pylist()
        same = [a == b or (a != a and b != b) for a, b in zip(g, w)]
        assert all(same), (name, g, w)


@pytest.mark.parametrize("batches", [1, 3])
@pytest.mark.parametrize("fetch", [None, 7, 1000])
def test_sort_op_matches_reference(fetch, batches):
    rbs = _record_batches(90, 30)[:batches]

    def plan(ns):
        scan = ns.Mem([rbs], ns.bridge.schema_from_arrow(rbs[0].schema),
                      capacity=32)
        return ns.sort.SortOp(scan, _orders(ns), fetch=fetch)

    want, = _run(REF, plan(REF))
    got, = _run(PORT, plan(PORT))
    assert want.num_rows == (min(fetch, 30 * batches) if fetch
                             else 30 * batches)
    _same_rows(got, want)


def test_concat_all_matches_reference():
    """Three padded batches: the same capacity, row count and rows."""
    rows, parts = [5, 16, 0], []
    for n in rows:
        parts.append(_key_batch(16, n, seed=n))
    want = rsort._concat_all([j for j, _t in parts])
    got = tsort._concat_all([t for _j, t in parts])
    assert got.capacity == want.capacity == 64
    assert int(got.num_rows) == int(want.num_rows) == sum(rows)
    n = sum(rows)
    for g, w in zip(got.columns, want.columns):
        gv, wv = g.validity.numpy()[:n], np.asarray(w.validity)[:n]
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(g.data.numpy()[:n][gv],
                                      np.asarray(w.data)[:n][wv])


def test_sort_op_refuses_unported_key_types():
    class _Structs(PhysicalOp):
        def schema(self):
            return Schema((Field("d", TDT.STRUCT),))

    with pytest.raises(NotImplementedError, match="16f"):
        tsort.SortOp(_Structs(), [tir.SortOrder(tir.ColumnRef(0))])


# ---------------------------------------------------------------------------
# range partitioning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_out", [2, 4, 7])
def test_range_bounds_and_partition_ids_match_reference(n_out):
    """Bounds from two sampled batches (runs of equal keys, so some
    bounds collapse), then partition ids of a third batch."""
    samples = [_key_batch(32, 30, seed=s) for s in (1, 2)]
    jb, tb = _key_batch(64, 60, seed=3)
    schema = tbridge.schema_from_arrow(pa.schema(
        [("k", pa.int64()), ("w", pa.float64()), ("i", pa.int8())]))
    jschema = rbridge.schema_from_arrow(pa.schema(
        [("k", pa.int64()), ("w", pa.float64()), ("i", pa.int8())]))
    want_b = rpart.compute_range_bounds([j for j, _t in samples],
                                        _orders(REF), jschema, n_out)
    got_b = tpart.compute_range_bounds([t for _j, t in samples],
                                       _orders(PORT), schema, n_out)
    assert got_b == want_b
    assert 0 < len(got_b) <= n_out - 1
    want = rpart.RangePartitioning(tuple(_orders(REF)), n_out, want_b)
    got = tpart.RangePartitioning(tuple(_orders(PORT)), n_out, got_b)
    np.testing.assert_array_equal(got.partition_ids(tb, schema).numpy(),
                                  np.asarray(want.partition_ids(jb,
                                                                jschema)))


def test_range_exchange_matches_reference():
    """A range ShuffleExchangeOp with no bounds in its plan samples them
    from the leading batches of its one pass (3 map partitions → 4
    reduce partitions): every partition gets the reference's rows in
    the reference's order, and the bounds it sampled are the
    reference's."""
    rbs = _record_batches(600, 50, seed=4)
    maps = [rbs[m::3] for m in range(3)]

    def plan(ns):
        scan = ns.Mem(maps, ns.bridge.schema_from_arrow(rbs[0].schema),
                      capacity=64)
        part = ns.part.RangePartitioning(tuple(_orders(ns)), 4, bounds=())
        return ns.Shuffle(scan, part, input_partitions=3)

    ref_op, port_op = plan(REF), plan(PORT)
    want = _run(REF, ref_op, 4)
    got = _run(PORT, port_op, 4)
    assert port_op.partitioning.bounds == ref_op.partitioning.bounds
    assert len(port_op.partitioning.bounds) == 3
    for g, w in zip(got, want):
        _same_rows(g, w)
    assert sum(t.num_rows for t in got) == 600


# ---------------------------------------------------------------------------
# Cast
# ---------------------------------------------------------------------------

CASTS = {
    "int64_to_float64": ("i64", "INT64", "FLOAT64"),
    "int32_to_float64": ("i32", "INT32", "FLOAT64"),
    "float64_to_int64": ("f64", "FLOAT64", "INT64"),
    "float64_to_int32": ("f64", "FLOAT64", "INT32"),
    "float32_to_int8": ("f32", "FLOAT32", "INT8"),
    "bool_to_int64": ("b", "BOOL", "INT64"),
    "bool_to_int32": ("b", "BOOL", "INT32"),
}


def _cast_columns():
    rng = np.random.default_rng(8)
    f = rng.normal(size=32) * 1e3
    f[:8] = [np.nan, np.inf, -np.inf, 2.0 ** 63, -2.9, 2.9, 3e9, -0.0]
    return {"i64": rng.integers(-10**15, 10**15, 32),
            "i32": rng.integers(-1000, 1000, 32).astype(np.int32),
            "f64": f, "f32": (f / 10).astype(np.float32),
            "b": rng.random(32) > 0.5}


@pytest.mark.parametrize("case", sorted(CASTS))
def test_cast_evaluates_as_reference(case):
    name, src, dst = CASTS[case]
    data = _cast_columns()[name]
    ok = _valid(32, 6)
    jb = JBatch((JCol(jnp.asarray(data), jnp.asarray(ok)),),
                jnp.asarray(30, jnp.int32))
    tb = batch_from_numpy([(data, ok)], 30, "cpu")
    jschema = JSchema((JField("x", getattr(JDT, src)),))
    tschema = Schema((Field("x", getattr(TDT, src)),))
    want = jeval.evaluate(rir.Cast(rir.ColumnRef(0), getattr(JDT, dst)), jb,
                          jschema)
    got = teval.evaluate(tir.Cast(tir.ColumnRef(0), getattr(TDT, dst)), tb,
                         tschema)
    assert got.dtype.value == want.dtype.value == getattr(TDT, dst).value
    assert teval.infer_dtype(tir.Cast(tir.ColumnRef(0), getattr(TDT, dst)),
                             tschema) == (getattr(TDT, dst), 0, 0)
    np.testing.assert_array_equal(got.validity.numpy(),
                                  np.asarray(want.validity))
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))


def test_cast_to_unported_types_raises():
    tb = batch_from_numpy([(np.arange(4), np.ones(4, bool))], 4, "cpu")
    schema = Schema((Field("x", TDT.INT64),))
    for dt in (TDT.LIST, TDT.STRUCT):
        with pytest.raises(NotImplementedError, match=f"cast.*{dt.value}"):
            teval.evaluate(tir.Cast(tir.ColumnRef(0), dt), tb, schema)


# ---------------------------------------------------------------------------
# decimal keys
# ---------------------------------------------------------------------------

from auron_tpu.columnar.decimal128 import Decimal128Column as JDec
from auron_tpu_torch.columnar import decimal128 as D


def _dec_edge(n: int = 24, seed: int = 5) -> tuple[np.ndarray, np.ndarray]:
    """Limbs of 128-bit values with their edges: ±(10^38 - 1), ±2^63,
    2^64 - 1, -1, 0, values that differ in the low limb only, ties."""
    rng = np.random.default_rng(seed)
    vals = [10 ** 38 - 1, -(10 ** 38 - 1), 2 ** 63, -(2 ** 63), 2 ** 64 - 1,
            -1, 0, 1, 2 ** 64, 2 ** 64 + 1, -(2 ** 64), 5, 5, -1]
    while len(vals) < n:
        vals.append(int(rng.integers(-3, 4)) * 2 ** 64
                    + int(rng.integers(-3, 4)))
    hi, lo, _ = D.limbs_from_ints(vals[:n], n)
    return hi, lo


@pytest.mark.parametrize("asc,nf", ORDERS,
                         ids=[f"{'asc' if a else 'desc'}-nulls_"
                              f"{'first' if f else 'last'}"
                              for a, f in ORDERS])
def test_decimal_sort_key_words_match_reference(asc, nf):
    hi, lo = _dec_edge()
    ok = _valid(hi.size, 1)
    jc = JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(ok))
    tc = D.Decimal128Column(torch.from_numpy(hi), torch.from_numpy(lo),
                            torch.from_numpy(ok))
    want = rsort.sort_key_words([jc], [(asc, nf)])
    got = tsort.sort_key_words([tc], [(asc, nf)])
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tsort.words_to_uint64(g),
                                      np.asarray(w))
    for g, w in zip(tsort.order_words(tc, asc, nf),
                    rsort.order_words(jc, asc, nf)):
        np.testing.assert_array_equal(tsort.words_to_uint64(g),
                                      np.asarray(w))


def test_decimal_sort_permutation_matches_reference():
    """A wide key, then a narrow one (int64 payload), over padding."""
    hi, lo = _dec_edge(64, 7)
    small = np.random.default_rng(8).integers(-3, 3, 64)
    v1, v2 = _valid(64, 2), _valid(64, 3)
    jb = JBatch((JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v1)),
                 JCol(jnp.asarray(small), jnp.asarray(v2))),
                jnp.asarray(57, jnp.int32))
    tb = batch_from_numpy([(hi, lo, v1), (small, v2)], 57, "cpu")
    for orders in ([(True, True), (False, False)],
                   [(False, True), (True, False)]):
        want = rsort.sort_permutation(jb, list(jb.columns), orders)
        got = tsort.sort_permutation(tb, list(tb.columns), orders)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _decimal_record_batches(rows: int, batch: int, seed: int = 9):
    import decimal
    rng = np.random.default_rng(seed)
    wide = [decimal.Decimal(int(rng.integers(-3, 4)) * 10 ** 20
                            + int(rng.integers(-5, 5))).scaleb(-2)
            for _ in range(rows)]
    narrow = [decimal.Decimal(int(x)).scaleb(-3)
              for x in rng.integers(-4, 4, rows)]
    wv, nv = _valid(rows, seed), _valid(rows, seed + 1)
    v = rng.integers(-100, 100, rows)
    return [pa.record_batch({
        "w": pa.array([x if ok else None for x, ok in
                       zip(wide[i:i + batch], wv[i:i + batch])],
                      pa.decimal128(30, 2)),
        "n": pa.array([x if ok else None for x, ok in
                       zip(narrow[i:i + batch], nv[i:i + batch])],
                      pa.decimal128(9, 3)),
        "v": pa.array(v[i:i + batch], pa.int64())})
        for i in range(0, rows, batch)]


def _dec_orders(ns):
    C = ns.ir.ColumnRef
    return [ns.ir.SortOrder(C(0), False, True),
            ns.ir.SortOrder(C(1), True, False)]


@pytest.mark.parametrize("fetch", [None, 7])
def test_decimal_sort_op_matches_reference(fetch):
    rbs = _decimal_record_batches(90, 30)

    def plan(ns):
        scan = ns.Mem([rbs], ns.bridge.schema_from_arrow(rbs[0].schema),
                      capacity=32)
        return ns.sort.SortOp(scan, _dec_orders(ns), fetch=fetch)

    want, = _run(REF, plan(REF))
    got, = _run(PORT, plan(PORT))
    assert want.num_rows == (fetch or 90)
    _same_rows(got, want)


def test_decimal_range_exchange_matches_reference():
    """A range exchange keyed on a wide and a narrow decimal samples the
    reference's bounds (two words for the wide key) and sends each
    partition the reference's rows in order."""
    rbs = _decimal_record_batches(300, 50, seed=4)
    maps = [rbs[m::3] for m in range(3)]

    def plan(ns):
        scan = ns.Mem(maps, ns.bridge.schema_from_arrow(rbs[0].schema),
                      capacity=64)
        part = ns.part.RangePartitioning(tuple(_dec_orders(ns)), 4,
                                         bounds=())
        return ns.Shuffle(scan, part, input_partitions=3)

    ref_op, port_op = plan(REF), plan(PORT)
    want = _run(REF, ref_op, 4)
    got = _run(PORT, port_op, 4)
    assert port_op.partitioning.bounds == ref_op.partitioning.bounds
    assert all(len(b) == 5 for b in port_op.partitioning.bounds)
    for g, w in zip(got, want):
        _same_rows(g, w)
