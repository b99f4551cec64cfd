"""The port's q01 operator pipeline against the JAX package's, on the CPU.

Scale 1 of the TPC-DS-class dataset (120,000 store_sales rows in 4
parquet files, 12 stores, seed 42), with ``auron.scan.batch_rows =
1024`` in both packages:

- the port's ``q01_pipeline_plan`` is the reference planner's physical
  tree for ``it.queries.q01_dataframe``, node by node (reprs, and the
  fields the operators run on);
- its collected table equals the reference ``Session``'s
  ``q01_dataframe(...).collect()`` in row order: keys and counts
  identical, float64 sums and means within 1e-12 of the store's sum of
  |v|; the same over device batches (``DeviceBatchScanOp``) with
  ``collect_numpy``;
- the dense plan (``key_domain``) equals the reference's plan with the
  same hint on its partial AggOp, float sums and means within 1e-5 of
  the store's sum of |v| (the dense kernel sums in f32);
- ``store_sales_columns`` equals the reference generator's parquet
  columns, and ``q01_oracle`` the reference's pandas oracle.
"""

import functools

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu import config as rcfg
from auron_tpu.frontend.session import Session
from auron_tpu.it import queries as rqueries
from auron_tpu.it import tpcds_data as rdata
from auron_tpu.runtime import executor as rexec
from auron_tpu_torch import config as tcfg
from auron_tpu_torch import entry
from auron_tpu_torch.it import tpcds_data as tdata
from auron_tpu_torch.runtime import executor as texec

SCALE, SEED, BATCH_ROWS = 1.0, 42, 1024
F64_TOL, DENSE_TOL = 1e-12, 1e-5
#: bucket_rows(n_stores): the dense hint over the 12 stores of scale 1
DENSE_DOMAIN = 16


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference side, once: the parquet files, its planned tree,
    its Session result and its dense-plan result."""
    root = str(tmp_path_factory.mktemp("tpcds"))
    tables = rdata.generate(root, SCALE, SEED)
    conf = rcfg.AuronConfig({rcfg.SCAN_BATCH_ROWS: BATCH_ROWS})
    session = Session(config=conf)
    df = rqueries.q01_dataframe(session, tables)
    plan = session.plan_physical(df)
    dense = session.plan_physical(df)
    dense.child.child.key_domain = DENSE_DOMAIN
    return {"tables": tables, "plan": plan, "result": df.collect(),
            "dense": rexec.collect(dense, 4, config=conf)}


@pytest.fixture(scope="module")
def conf():
    return tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS})


@pytest.fixture(scope="module")
def cols():
    return tdata.store_sales_columns(SCALE, SEED)


def _nodes(op):
    out = [op]
    while op.children:
        (op,) = op.children
        out.append(op)
    return out


#: per node type: the fields it runs on, compared by repr
FIELDS = {
    "AggOp": ("group_exprs", "aggs", "mode", "group_names", "agg_names",
              "initial_capacity", "key_domain"),
    "ShuffleExchangeOp": ("partitioning", "input_partitions"),
    "FilterOp": ("predicates",),
    "ParquetScanOp": ("files", "batch_rows"),
}


def test_plan_tree_equals_reference_planner(ref, conf):
    port = entry.q01_pipeline_plan(ref["tables"]["store_sales"],
                                   device="cpu", conf=conf)
    want, got = _nodes(ref["plan"]), _nodes(port)
    assert [repr(n) for n in got] == [repr(n) for n in want]
    assert repr(got[0]) == "AggOp[final: 1 keys; sum,count,avg]"
    for g, w in zip(got, want):
        for name in FIELDS[type(w).__name__]:
            assert repr(getattr(g, name)) == repr(getattr(w, name)), name
        assert [(f.name, f.dtype.value, f.nullable) for f in g.schema()] \
            == [(f.name, f.dtype.value, f.nullable) for f in w.schema()]
    # the port's scan reads every column and pushes no predicate down:
    # the reference planner's scan does the same for q01
    assert want[-1].columns is None and want[-1].predicates == []


def _assert_q01(got: dict, want: pa.Table, cols: dict, tol: float):
    """``got``: {column: (values, validity)}. Row order, keys, counts and
    null masks identical; floats within ``tol`` of the store's sum of
    |v| (the avg's bound divided by the store's rows)."""
    oracle = tdata.q01_oracle(cols)
    keys = want["ss_store_sk"].to_numpy()
    assert want.num_rows == len(oracle["ss_store_sk"])
    np.testing.assert_array_equal(got["ss_store_sk"][0], keys)
    np.testing.assert_array_equal(got["paid_cnt"][0],
                                  want["paid_cnt"].to_numpy())
    for name in want.column_names:
        assert got[name][1].all() and want[name].null_count == 0, name
    at = np.searchsorted(oracle["ss_store_sk"], keys)
    rows = np.bincount(cols["ss_store_sk"][0][cols["ss_quantity"][0] > 5])
    for name, scale in (("total", oracle["total_abs"][at]),
                        ("avg_profit", oracle["profit_abs"][at]
                         / rows[keys])):
        err = np.abs(got[name][0] - want[name].to_numpy())
        assert (err <= tol * scale).all(), name


def test_collect_equals_reference_session(ref, conf, cols):
    plan = entry.q01_pipeline_plan(ref["tables"]["store_sales"],
                                   device="cpu", conf=conf)
    table = texec.collect(plan, 4, conf)
    assert table.schema == ref["result"].schema
    got = {n: (table[n].to_numpy(), ~table[n].is_null().to_numpy())
           for n in table.column_names}
    _assert_q01(got, ref["result"], cols, F64_TOL)


def test_device_batches_equal_reference_session(ref, conf, cols):
    """The same plan over device batches cut at the files' row ranges,
    collected without pyarrow."""
    src = entry.store_sales_batches(cols, "cpu", conf=conf)
    rows = len(cols["ss_store_sk"][0])
    assert [len(p) for p in src] == [-(-(hi - lo) // BATCH_ROWS) for lo, hi
                                     in tdata.fact_file_bounds(rows)]
    metrics = {}
    got = entry.q01_pipeline(src, device="cpu", conf=conf, metrics=metrics)
    _assert_q01(got, ref["result"], cols, F64_TOL)
    assert metrics["agg"].snapshot()["dispatch_sort"] == 8
    assert metrics["device_scan"].snapshot()["output_rows"] == rows


def test_dense_plan_equals_reference_dense_plan(ref, conf, cols):
    metrics = {}
    got = entry.q01_pipeline(
        entry.store_sales_batches(cols, "cpu", conf=conf), device="cpu",
        key_domain=DENSE_DOMAIN, conf=conf, metrics=metrics)
    _assert_q01(got, ref["dense"], cols, DENSE_TOL)
    agg = metrics["agg"].snapshot()
    # the partial AggOp of each input partition ran dense; the final
    # AggOps of the four output partitions sorted
    assert agg["dispatch_cuda_dense"] == 4 and agg["dispatch_sort"] == 4


def test_store_sales_columns_equal_reference_files(ref, cols):
    tbl = pa.concat_tables(pq.read_table(f)
                           for f in ref["tables"]["store_sales"])
    assert tbl.column_names == list(cols)
    for name in tbl.column_names:
        values, valid = cols[name]
        np.testing.assert_array_equal(~tbl[name].is_null().to_numpy(),
                                      valid)
        np.testing.assert_array_equal(
            tbl[name].fill_null(0).to_numpy(), np.where(valid, values, 0))
    bounds = tdata.fact_file_bounds(tbl.num_rows)
    assert [hi - lo for lo, hi in bounds] == [
        pq.read_metadata(f).num_rows for f in ref["tables"]["store_sales"]]


def test_numpy_oracle_equals_reference_pandas_oracle(ref, cols):
    want = rqueries._q01_oracle(rdata.load_pandas(
        {"store_sales": ref["tables"]["store_sales"]}))
    got = tdata.q01_oracle(cols)
    np.testing.assert_array_equal(got["ss_store_sk"], want.ss_store_sk)
    np.testing.assert_array_equal(got["paid_cnt"], want.paid_cnt)
    np.testing.assert_allclose(got["total"], want.total, rtol=1e-12)
    np.testing.assert_allclose(got["avg_profit"], want.avg_profit,
                               rtol=1e-12)


def _batches_both(cols, n):
    import jax.numpy as jnp
    from auron_tpu.columnar.batch import DeviceBatch, PrimitiveColumn
    from auron_tpu_torch.columnar.batch import batch_from_numpy
    jb = DeviceBatch(tuple(PrimitiveColumn(jnp.asarray(d), jnp.asarray(v))
                           for d, v in cols), jnp.asarray(n, jnp.int32))
    return jb, batch_from_numpy(cols, n, "cpu")


def _same_batch(got, want):
    assert int(got.num_rows) == int(want.num_rows)
    assert got.capacity == want.capacity
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))


def test_batch_helpers_match_reference():
    """concat_batches, resize (grow and shrink) and mask_validity."""
    from auron_tpu.columnar import batch as rb
    from auron_tpu_torch.columnar import batch as tb
    rng = np.random.default_rng(2)
    a = [(rng.integers(-9, 9, 32), rng.random(32) > 0.2),
         (rng.normal(size=32), rng.random(32) > 0.2)]
    b = [(rng.integers(-9, 9, 16), rng.random(16) > 0.2),
         (rng.normal(size=16), rng.random(16) > 0.2)]
    ja, ta = _batches_both(a, 20)
    jb, tb_ = _batches_both(b, 9)
    _same_batch(tb.concat_batches(ta, tb_), rb.concat_batches(ja, jb))
    for cap in (64, 24):
        _same_batch(tb.resize(ta, cap), rb.resize(ja, cap))
    _same_batch(tb.mask_validity(ta), rb.mask_validity(ja))
    assert tb.batch_nbytes(ta) == rb.batch_nbytes(ja)


def test_arrow_bridge_round_trip_matches_reference():
    """to_device → to_arrow of every primitive type, with nulls, at a
    padded capacity: the same schema, device arrays and Arrow table."""
    import datetime
    rng = np.random.default_rng(6)
    n = 40
    mask = rng.random(n) < 0.2
    rbatch = pa.record_batch({
        "b": pa.array(rng.random(n) > 0.5, mask=mask),
        "i8": pa.array(rng.integers(-100, 100, n).astype(np.int8)),
        "i16": pa.array(rng.integers(-999, 999, n).astype(np.int16),
                        mask=mask),
        "i32": pa.array(rng.integers(-9, 9, n).astype(np.int32)),
        "i64": pa.array(rng.integers(-2**40, 2**40, n), mask=mask),
        "f32": pa.array(rng.normal(size=n).astype(np.float32)),
        "f64": pa.array(rng.normal(size=n), mask=mask),
        "d": pa.array([datetime.date(2000, 1, 1 + i % 28)
                       for i in range(n)], mask=mask),
        "ts": pa.array(rng.integers(0, 2**40, n), pa.timestamp("us")),
    })
    from auron_tpu.columnar import arrow_bridge as rbridge
    from auron_tpu_torch.columnar import arrow_bridge as tbridge
    want, wschema = rbridge.to_device(rbatch, capacity=64)
    got, gschema = tbridge.to_device(rbatch, capacity=64, device="cpu")
    assert [(f.name, f.dtype.value, f.nullable) for f in gschema] == \
        [(f.name, f.dtype.value, f.nullable) for f in wschema]
    _same_batch(got, want)
    assert tbridge.to_arrow(got, gschema).equals(
        rbridge.to_arrow(want, wschema))
    assert tbridge.schema_to_arrow(gschema) == \
        rbridge.schema_to_arrow(wschema)


def test_filter_and_project_match_reference():
    """FilterOp, ProjectOp and FilterProjectOp over the same batches."""
    from auron_tpu.columnar import arrow_bridge as rbridge
    from auron_tpu.columnar.schema import DataType as RT
    from auron_tpu.exprs import ir as rir
    from auron_tpu.io.parquet import MemoryScanOp as RMem
    from auron_tpu.ops import project as rproj
    from auron_tpu.ops.base import ExecContext as RCtx
    from auron_tpu_torch.columnar import arrow_bridge as tbridge
    from auron_tpu_torch.columnar.schema import DataType as TT
    from auron_tpu_torch.exprs import ir as tir
    from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
    from auron_tpu_torch.ops import project as tproj
    from auron_tpu_torch.ops.base import ExecContext as TCtx
    rng = np.random.default_rng(8)
    rbs = [pa.record_batch({
        "q": pa.array(rng.integers(0, 20, 50), mask=rng.random(50) < 0.1),
        "p": pa.array(rng.normal(size=50) * 10)}) for _ in range(3)]

    def run(ir, T, mem, proj, ctx, bridge):
        C = ir.ColumnRef
        pred = ir.BinaryExpr(">", C(0), ir.Literal(5, T.INT64))
        exprs = [ir.BinaryExpr("*", C(1), C(0)), C(0)]
        scan = mem([rbs], bridge.schema_from_arrow(rbs[0].schema),
                   capacity=64)
        out = []
        for op in (proj.FilterOp(scan, [pred]),
                   proj.ProjectOp(scan, exprs, ["pq", "q"]),
                   proj.FilterProjectOp(scan, [pred], exprs, ["pq", "q"])):
            out.append((repr(op), [bridge.to_arrow(b, op.schema()).to_pylist()
                                   for b in op.execute(0, ctx())]))
        return out

    want = run(rir, RT, RMem, rproj, RCtx, rbridge)
    got = run(tir, TT, functools.partial(TMem, device="cpu"), tproj,
              TCtx, tbridge)
    assert got == want
    assert sum(len(rows) for rows in want[0][1]) > 50
