"""Uncorrelated scalar subqueries in the port against the JAX package's,
on the CPU.

The same queries, built in both DSLs over the same tables, go through
``Session(device="cpu")`` and the reference ``Session``:

- the reference's own cases (``tests/test_subquery.py``): a filter by a
  subquery, an aggregated value, an empty subquery (NULL), a subquery of
  two rows (an error), one subquery used twice, a two-column subquery
  (refused), a nested subquery, and the expression's proto round trip;
- a subquery over a 4-file scan read as 4 partitions: one qualifying row
  in the last file gives its value on every outer row; 4 rows over two
  files raise the reference's message;
- one value of each type (int64, float64, bool, string, date, timestamp,
  decimal(7,2), decimal(38,6)) and a NULL of each: the port substitutes
  the reference's literal, and its output values and Arrow types are the
  reference's.

Rows are equal to the reference's (floats within 1e-12 relative: the
reference's averages sum in another order). Each query's task bytes
equal the reference's with every ``sid`` zeroed, and its operator tree
after resolution is the reference planner's. A 4-partition outer plan
runs its subquery's plan once.
"""

from types import SimpleNamespace
from unittest import mock

import datetime
import decimal

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir import planner as rplanner
from auron_tpu.ir import serde as rserde
from auron_tpu.ops.base import ExecContext as RExecContext
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import ParquetScanOp
from auron_tpu_torch.ir import auron_pb2 as tpb
from auron_tpu_torch.ir import planner as tplanner
from auron_tpu_torch.ir import serde as tserde
from auron_tpu_torch.ops.base import ExecContext as TExecContext
from auron_tpu_torch.ops.subquery import ScalarSubqueryError
from tests.test_torch_planner import _same_tree
from tests.torch_suite_cases import zero_sids

REF = SimpleNamespace(col=rdf.col, lit=rdf.lit, F=rdf.functions,
                      sub=rdf.scalar_subquery, DataType=RDT)
PORT = SimpleNamespace(col=tdf.col, lit=tdf.lit, F=tdf.functions,
                       sub=tdf.scalar_subquery, DataType=TDT)

MULTI_ROW = ("more than one row returned by a subquery used as an "
             "expression")
F64_REL_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# tables and queries, in either DSL
# ---------------------------------------------------------------------------

def _memory_tables() -> dict:
    rng = np.random.default_rng(11)
    return {
        "t": pa.table({
            "k": pa.array(rng.integers(0, 5, 200), pa.int64()),
            "v": pa.array(rng.normal(10.0, 3.0, 200), pa.float64())}),
        "thresh": pa.table({"cut": pa.array([12.0], pa.float64())}),
        "empty": pa.table({"cut": pa.array([], pa.float64())}),
        "multi": pa.table({"cut": pa.array([1.0, 2.0], pa.float64())}),
    }


#: one value of each type the subquery returns, and its Arrow type
TYPED = {
    "i": (pa.int64(), 42),
    "f": (pa.float64(), 2.5),
    "b": (pa.bool_(), True),
    "s": (pa.string(), "subquery"),
    "d": (pa.date32(), datetime.date(2001, 3, 17)),
    "ts": (pa.timestamp("us"), datetime.datetime(2001, 3, 17, 8, 9, 10,
                                                  123457)),
    "m": (pa.decimal128(7, 2), decimal.Decimal("12345.67")),
    "w": (pa.decimal128(38, 6), decimal.Decimal("123456.789012")),
}


def _typed_tables() -> dict:
    return {
        "typed": pa.table({c: pa.array([v], t)
                           for c, (t, v) in TYPED.items()}),
        "typed_null": pa.table({c: pa.array([None], t)
                                for c, (t, _v) in TYPED.items()}),
        "one": pa.table({"x": pa.array([1], pa.int64())}),
    }


def _partition_files(root) -> list:
    """4 files of (k, v): k = 99 only in the last file's row 3; k = 98 in
    two rows each of files 1 and 2."""
    files = []
    for i in range(4):
        k = np.arange(10, dtype=np.int64) + 10 * i
        if i == 3:
            k[3] = 99
        if i in (1, 2):
            k[[2, 5]] = 98
        path = str(root / f"t_{i}.parquet")
        pq.write_table(pa.table({
            "k": k, "v": np.arange(10, dtype=np.float64) + 100.0 * i}), path)
        files.append(path)
    return files


def _cases(d, s, files) -> dict:
    """{name: DataFrame} of every runnable case in DSL ``d``."""
    t = s.table("t")
    cut = d.sub(s.table("thresh").select("cut"))
    avg_v = d.sub(s.table("t").group_by().agg(
        d.F.avg(d.col("v")).alias("a")))
    min_k = d.sub(s.table("t").group_by().agg(
        d.F.min(d.col("k")).alias("m")))
    inner = (s.table("t").filter(d.col("k") > min_k)
             .group_by().agg(d.F.avg(d.col("v")).alias("a")))
    scan = s.read_parquet(files, partitions=4)
    last = d.sub(s.read_parquet(files, partitions=4)
                 .filter(d.col("k") == d.lit(99)).select("v"))
    return {
        "filter": t.filter(d.col("v") > cut),
        "aggregated": t.filter(d.col("v") > avg_v),
        "empty": t.filter(d.col("v") > d.sub(
            s.table("empty").select("cut"))),
        "projected": t.select(d.col("k"), (d.col("v") - cut).alias("d"),
                              (d.col("v") + cut).alias("u")),
        "nested": t.filter(d.col("v") > d.sub(inner)),
        "last_partition": scan.select(d.col("k"), last.alias("x")),
        "typed": s.table("one").select(*[
            d.sub(s.table("typed").select(c)).alias(c) for c in TYPED]),
        "typed_null": s.table("one").select(*[
            d.sub(s.table("typed_null").select(c)).alias(c)
            for c in TYPED]),
    }


def _raising_cases(d, s, files) -> dict:
    t = s.table("t")
    spread = d.sub(s.read_parquet(files, partitions=4)
                   .filter(d.col("k") == d.lit(98)).select("v"))
    return {
        "multi_row": t.filter(d.col("v") > d.sub(
            s.table("multi").select("cut"))),
        "spread_rows": s.read_parquet(files, partitions=4).select(
            d.col("k"), spread.alias("x")),
    }


NAMES = ("filter", "aggregated", "empty", "projected", "nested",
         "last_partition", "typed", "typed_null")


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    return _partition_files(tmp_path_factory.mktemp("subquery"))


@pytest.fixture(scope="module")
def sessions():
    tables = {**_memory_tables(), **_typed_tables()}
    rs, ts = RSession(), TSession(device="cpu")
    for name, table in tables.items():
        rs.register(name, table)
        ts.register(name, table)
    return rs, ts


def _capture_literals(planner_mod):
    """Patch ``substitute_subqueries`` of one package to record the
    literal ExprNodes it substitutes, by subquery key."""
    seen = {}
    real = planner_mod.substitute_subqueries

    def spy(node, values):
        out = real(node, values)
        # the schema's typed-NULL placeholders are substituted too; a
        # nested subquery's sid stays in its outer subquery's key
        seen.setdefault("calls", []).append(
            {zero_sids(k, tpb.ScalarSubqueryE): v.literal
             for k, v in values.items()})
        return out
    return mock.patch.object(planner_mod, "substitute_subqueries", spy), seen


@pytest.fixture(scope="module")
def results(sessions, files):
    """{name: (reference table, port table, reference literals, port
    literals)}: each case collected once in each Session."""
    rs, ts = sessions
    rcases, tcases = _cases(REF, rs, files), _cases(PORT, ts, files)
    out = {}
    for name in NAMES:
        rpatch, rseen = _capture_literals(rplanner)
        tpatch, tseen = _capture_literals(tplanner)
        with rpatch:
            want = rcases[name].collect()
        with tpatch:
            got = tcases[name].collect()
        out[name] = (want, got, rseen.get("calls", []),
                     tseen.get("calls", []))
    return out


# ---------------------------------------------------------------------------
# rows, types and literals
# ---------------------------------------------------------------------------

def _sorted_rows(table: pa.Table) -> list:
    return sorted(table.to_pylist(), key=lambda r: tuple(
        (v is None, v) for v in r.values()))


def _same_rows(got: pa.Table, want: pa.Table):
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for g, w in zip(_sorted_rows(got), _sorted_rows(want)):
        for c in want.column_names:
            if isinstance(w[c], float):
                assert g[c] == pytest.approx(w[c], rel=F64_REL_TOL), c
            else:
                assert g[c] == w[c], c


@pytest.mark.parametrize("name", NAMES)
def test_rows_equal_the_reference(name, results):
    want, got, _r, _t = results[name]
    _same_rows(got, want)


def _literal_fields(lit) -> tuple:
    """A LiteralE's type, nullness and value, a float64 value apart."""
    kind = lit.WhichOneof("value")
    return (lit.dtype, lit.precision, lit.scale, lit.is_null, kind,
            None if kind == "f64" else getattr(lit, kind or "is_null"))


@pytest.mark.parametrize("name", NAMES)
def test_substituted_literals_equal_the_reference(name, results):
    """The same literal for each subquery, of the reference's type; a
    float64 value (an average) within F64_REL_TOL, as the reference sums
    in another order."""
    _want, _got, rlits, tlits = results[name]
    assert tlits and len(tlits) == len(rlits)
    for got, want in zip(tlits, rlits):
        assert got.keys() == want.keys()
        for key, lit in want.items():
            assert _literal_fields(got[key]) == _literal_fields(lit)
            if lit.WhichOneof("value") == "f64":
                assert got[key].f64 == pytest.approx(lit.f64,
                                                     rel=F64_REL_TOL)


def test_reference_oracles(results, sessions):
    """The reference's own checks of each case, on the port's rows."""
    table = _memory_tables()["t"].to_pandas()
    got = {n: results[n][1].to_pandas() for n in NAMES}
    exp = table[table.v > 12.0]
    assert len(got["filter"]) == len(exp) > 0
    assert set(np.round(got["filter"].v, 9)) == set(np.round(exp.v, 9))
    assert len(got["aggregated"]) == (table.v > table.v.mean()).sum() > 0
    assert len(got["empty"]) == 0
    assert len(got["projected"]) == 200
    assert np.allclose(np.sort(got["projected"].d.values),
                       np.sort(table.v.values - 12.0))
    cut = table[table.k > table.k.min()].v.mean()
    assert len(got["nested"]) == (table.v > cut).sum() > 0


def test_one_row_in_the_last_partition_gives_its_value(results):
    _want, got, _r, _t = results["last_partition"]
    assert got.num_rows == 40
    assert got.column("x").to_pylist() == [303.0] * 40


@pytest.mark.parametrize("column", list(TYPED))
def test_each_type_gives_the_reference_value(column, results):
    want, got, _r, _t = results["typed"]
    arrow_type, value = TYPED[column]
    assert got.schema.field(column).type == arrow_type
    assert got.column(column).to_pylist() == [value]
    assert want.column(column).to_pylist() == [value]


@pytest.mark.parametrize("column", list(TYPED))
def test_each_type_gives_a_typed_null(column, results):
    want, got, _r, _t = results["typed_null"]
    assert got.schema.field(column).type == TYPED[column][0]
    assert got.schema.field(column).type == want.schema.field(column).type
    assert got.column(column).to_pylist() == [None]


# ---------------------------------------------------------------------------
# errors
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("multi_row", "spread_rows"))
def test_more_than_one_row_raises_the_reference_message(name, sessions,
                                                        files):
    rs, ts = sessions
    with pytest.raises(RuntimeError, match=MULTI_ROW):
        _raising_cases(REF, rs, files)[name].collect()
    with pytest.raises(ScalarSubqueryError, match=MULTI_ROW):
        _raising_cases(PORT, ts, files)[name].collect()


def test_multi_column_subquery_rejected(sessions):
    rs, ts = sessions
    for d, s in ((REF, rs), (PORT, ts)):
        with pytest.raises(ValueError, match="exactly one column"):
            d.sub(s.table("t"))


def test_unresolved_subquery_raises_in_evaluation():
    from auron_tpu_torch.exprs.eval import evaluate
    from auron_tpu_torch.columnar.batch import batch_from_numpy
    from auron_tpu_torch.columnar.schema import Field, Schema
    batch = batch_from_numpy([(np.zeros(4, np.int64), np.ones(4, bool))],
                             4, device="cpu")
    e = tir.ScalarSubquery(b"", TDT.INT64)
    with pytest.raises(RuntimeError, match="unresolved scalar subquery"):
        evaluate(e, batch, Schema((Field("a", TDT.INT64),)))


# ---------------------------------------------------------------------------
# serde, bytes and trees
# ---------------------------------------------------------------------------

def test_proto_round_trip():
    sub = tpb.PlanNode(memory_scan=tpb.MemoryScanNode(table_name="thresh"))
    e = tir.ScalarSubquery(sub.SerializeToString(), TDT.FLOAT64, sid=7)
    assert tserde.parse_expr(tserde.expr_to_proto(e)) == e
    r = rir.ScalarSubquery(sub.SerializeToString(), RDT.FLOAT64, sid=7)
    assert tserde.expr_to_proto(e).SerializeToString() == \
        rserde.expr_to_proto(r).SerializeToString()


@pytest.mark.parametrize("name", NAMES + ("multi_row", "spread_rows"))
def test_task_bytes_equal_the_reference_without_sids(name, sessions, files):
    rs, ts = sessions
    rcases = {**_cases(REF, rs, files), **_raising_cases(REF, rs, files)}
    tcases = {**_cases(PORT, ts, files), **_raising_cases(PORT, ts, files)}
    want, got = rcases[name].task_bytes(), tcases[name].task_bytes()
    assert zero_sids(got) == zero_sids(want)


@pytest.mark.parametrize("name", ("filter", "projected", "nested",
                                  "last_partition"))
def test_resolved_tree_equals_the_reference(name, sessions, files):
    rs, ts = sessions
    data = _cases(REF, rs, files)[name].task_bytes()
    want = rplanner.plan_from_bytes(data, rs.ctx)
    got = tplanner.plan_from_bytes(data, ts.ctx)
    assert repr(got) == repr(want) == "ScalarSubqueryBinderOp"
    # before resolution the schema comes from the typed-NULL placeholders
    assert [(f.name, f.dtype.value) for f in got.schema()] == \
        [(f.name, f.dtype.value) for f in want.schema()]
    _same_tree(got._resolved_inner(TExecContext()),
               want._resolved_inner(RExecContext()))


def test_subquery_plan_runs_once_per_task(sessions, files):
    """The outer plan's 4 partitions share one resolution, and the two
    equal subqueries (built apart, so with different sids) one more."""
    _rs, ts = sessions
    d = PORT
    sub = lambda: d.sub(ts.read_parquet(files[3:]).filter(  # noqa: E731
        d.col("k") == d.lit(99)).select("v"))
    df = ts.read_parquet(files, partitions=4).select(
        d.col("k"), sub().alias("x"), (sub() + d.col("v")).alias("y"))
    scans = []
    real = ParquetScanOp.execute

    def counting(self, partition, ctx):
        scans.append((tuple(self.files), partition, ctx.num_partitions))
        return real(self, partition, ctx)

    with mock.patch.object(ParquetScanOp, "execute", counting):
        got = df.collect()
    assert got.num_rows == 40
    assert got.column("x").to_pylist() == [303.0] * 40
    assert scans.count((tuple(files[3:]), 0, 1)) == 1
    assert sorted(p for f, p, _n in scans if f == tuple(files)) == \
        [0, 1, 2, 3]
