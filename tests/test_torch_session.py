"""The port's Session against the JAX package's, on the CPU.

Scale 1 of the TPC-DS-class dataset (120,000 store_sales rows in 4
parquet files, 12 stores, seed 42), ``auron.scan.batch_rows = 8192`` in
both packages. q01, q10, q11 and q13 (``it/queries.py``) and the
in-memory query ``store_quantity_dataframe`` run through
``Session(device="cpu")`` → DataFrame → TaskDefinition bytes → planner
→ ``collect``:

- the port returns the reference Session's rows in the same order: keys,
  counts and integer sums identical, float64 sums within 1e-12 of the
  group's sum of |v| (means within that over the group's rows);
- both results agree with the pandas oracle under the port's
  ``QueryResultComparator``;
- at scale 0.1 (seed 7), q02 and q12 (top-k), q02's full sort over 4
  partitions (a range exchange) and a keyless aggregate give the
  reference Session's rows in the same order, every value identical
  (the sums of one group arrive in the same order in both packages),
  and the keyless aggregate gives the reference's ``[{'q': 119671}]``;
- at scale 1, q05 co-partitioned and over a broadcast build side, and
  the broadcast form with a filtered probe side, give the reference
  Session's rows in the same order, bit for bit; so do right and full
  joins over a broadcast build side, whose rows are the reference's
  duplicated ones (``BROADCAST_OUTER_ROWS``), not pandas' (ROADMAP
  Queue 3 item 8). Every join query of ``torch_join_cases`` but those
  two (q09's semi and anti joins counted, and each join type over
  co-partitioned sides too) matches its pandas oracle. The reference
  Session runs only the first five: its programs' compiles cost ~30 s
  here, and the other queries' operators, task bytes and plan trees are
  held against the reference's in ``test_torch_joins.py``,
  ``test_torch_serde.py`` and ``test_torch_planner.py``;
- ``read_parquet(files, columns=...)`` of a file that holds strings
  gives the reference's schema and rows when no string is asked for,
  and so does reading every column, the strings included;
- a Session or an Arrow scan built without a device raises where CUDA is
  absent.
"""

from unittest import mock

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.it import queries as rqueries
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.it import queries as tqueries
from auron_tpu_torch.it.comparator import QueryResultComparator
from auron_tpu_torch.it.runner import run_query
from tests import torch_join_cases as join_cases

SCALE, SEED, BATCH_ROWS = 1.0, 42, 1 << 17
F64_TOL = 1e-12
NAMES = ("q01", "q10", "q11", "q13", "store_quantity")
#: per query: its group key, and each float column with the column of
#: store_sales whose |v| sets its bound (and whether it is a mean)
FLOATS = {"q01": ("ss_store_sk", {"total": ("ss_sales_price", False),
                                  "avg_profit": ("ss_net_profit", True)}),
          "q10": ("ss_quantity", {"avg_price": ("ss_sales_price", True)}),
          "q11": ("ss_store_sk", {}), "q13": ("ss_store_sk", {}),
          "store_quantity": ("ss_store_sk", {})}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The queries run many small torch ops. Where test workers share
    the CPU, torch's intra-op threads oversubscribe it (four workers ran
    this module's port queries ~30x slower than one), so the module runs
    on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _ref_dataframes(session, tables, table) -> dict:
    """The reference's own query functions, their ``collect`` replaced by
    the DataFrame itself, and the in-memory query in its DSL."""
    F = rdf.functions
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        return {"q01": rqueries.q01_dataframe(session, tables),
                "q10": rqueries._q10_run(session, tables),
                "q11": rqueries._q11_run(session, tables),
                "q13": rqueries._q13_run(session, tables),
                "store_quantity": session.from_arrow(table)
                .group_by("ss_store_sk")
                .agg(F.count_star().alias("n"),
                     F.sum(rdf.col("ss_quantity")).alias("qty"))}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds"))
    tables = rdata.generate(root, SCALE, SEED)
    table = pa.concat_tables(pq.read_table(f) for f in tables["store_sales"])
    return tables, table, table.to_pandas()


def _pandas_tables(data) -> dict:
    tables, _table, pdf = data
    out = {name: pq.read_table(files[0]).to_pandas()
           for name, files in tables.items() if name != "store_sales"}
    return {"store_sales": pdf, **out}


@pytest.fixture(scope="module")
def ref(data):
    """The reference Session's results, once."""
    tables, table, _pdf = data
    session = RSession(config=rcfg.AuronConfig(
        {rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    dfs = _ref_dataframes(session, tables, table)
    return {name: dfs[name].collect() for name in NAMES}


def _port_dataframes(session, tables, table) -> dict:
    return {"q01": tqueries.q01_dataframe(session, tables),
            "q10": tqueries.q10_dataframe(session, tables),
            "q11": tqueries.q11_dataframe(session, tables),
            "q13": tqueries.q13_dataframe(session, tables),
            "store_quantity": tqueries.store_quantity_dataframe(session,
                                                                table)}


@pytest.fixture(scope="module")
def port(data):
    tables, table, _pdf = data
    session = TSession(config=tcfg.AuronConfig(
        {tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}), device="cpu")
    dfs = _port_dataframes(session, tables, table)
    return {name: dfs[name].collect() for name in NAMES}


def _abs_sums(pdf, key: str, column: str, keys: np.ndarray, mean: bool):
    g = pdf.assign(_a=pdf[column].abs()).groupby(key)["_a"]
    scale = g.sum().reindex(keys).to_numpy()
    if mean:
        scale = scale / pdf.groupby(key).size().reindex(keys).to_numpy()
    return scale


@pytest.mark.parametrize("name", NAMES)
def test_rows_equal_reference_session_in_order(name, ref, port, data):
    got, want = port[name], ref[name]
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows > 0
    key, floats = FLOATS[name]
    keys = want[key].to_numpy()
    pdf = data[2]
    if name == "q13":
        assert len(keys) == pdf.ss_store_sk.nunique() >= 12
    for col in want.column_names:
        assert got[col].null_count == want[col].null_count, col
        if col not in floats:
            assert got[col].equals(want[col]), col
            continue
        source, mean = floats[col]
        bound = F64_TOL * _abs_sums(pdf, key, source, keys, mean)
        err = np.abs(got[col].to_numpy() - want[col].to_numpy())
        assert (err <= bound).all(), col


@pytest.mark.parametrize("name", NAMES)
def test_both_sessions_match_the_pandas_oracle(name, ref, port, data):
    oracles = {q.name.split("_")[0]: q for q in tqueries.QUERIES}
    pd_tables = {"store_sales": data[2]}
    if name == "store_quantity":
        expected = pa.Table.from_pandas(
            tqueries._store_quantity_oracle(pd_tables).reset_index(
                drop=True), preserve_index=False)
    else:
        expected = oracles[name].expected(pd_tables)
    comparator = QueryResultComparator()
    for side in (port, ref):
        res = comparator.compare(name, side[name], expected)
        assert res.ok, res.report()


def test_run_query_passes_every_query(data):
    tables = data[0]
    pd_tables = _pandas_tables(data)
    for q in tqueries.QUERIES:
        res = run_query(q, tables, pd_tables, device="cpu")
        assert res.ok, res.report()


def test_fusion_off_gives_the_same_rows(data, port):
    tables, table, _pdf = data
    conf = tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS,
                             tcfg.FUSION_ENABLED: False})
    session = TSession(config=conf, device="cpu")
    got = tqueries.q11_dataframe(session, tables).collect()
    assert "FusedStageOp" not in tqueries.q11_dataframe(
        session, tables).explain()
    assert got.equals(port["q11"])


def test_entry_points_without_a_device_raise_without_cuda(data,
                                                         monkeypatch):
    from auron_tpu_torch.columnar.arrow_bridge import schema_from_arrow
    from auron_tpu_torch.io.parquet import MemoryScanOp, ParquetScanOp
    tables, table, _pdf = data
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TSession()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ParquetScanOp(tables["store_sales"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MemoryScanOp([table.to_batches()], schema_from_arrow(table.schema))


SORT_SCALE, SORT_SEED = 0.1, 7
SORT_NAMES = ("q02", "q12", "q02_full_sort", "keyless")


def _sort_dataframes(session, tables, dsl, queries) -> dict:
    """q02, q12, q02 without its limit and a keyless aggregate, in either
    package's DSL (the reference's query functions collect: their
    ``collect`` is patched to return the DataFrame)."""
    sales = session.read_parquet(tables["store_sales"], partitions=4)
    out = {"q02_full_sort": sales.group_by("ss_customer_sk").agg(
        dsl.functions.sum(dsl.col("ss_net_paid")).alias("revenue")).sort(
        dsl.col("revenue").desc(), dsl.col("ss_customer_sk").asc()),
        "keyless": sales.group_by().agg(
            dsl.functions.sum(dsl.col("ss_quantity")).alias("q"))}
    if queries is rqueries:
        with mock.patch.object(rdf.DataFrame, "collect",
                               lambda self, *a, **k: self):
            out.update(q02=rqueries._q02_run(session, tables),
                       q12=rqueries._q12_run(session, tables))
    else:
        out.update(q02=tqueries.q02_dataframe(session, tables),
                   q12=tqueries.q12_dataframe(session, tables))
    return out


@pytest.fixture(scope="module")
def sort_results(tmp_path_factory):
    """{name: (port table, reference table)} and the pandas table."""
    from auron_tpu_torch.frontend import dataframe as tdf
    root = str(tmp_path_factory.mktemp("tpcds_sort"))
    tables = {"store_sales": rdata.generate(root, SORT_SCALE,
                                            SORT_SEED)["store_sales"]}
    rs = RSession(config=rcfg.AuronConfig(
        {rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig(
        {tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}), device="cpu")
    ref = _sort_dataframes(rs, tables, rdf, rqueries)
    port = _sort_dataframes(ts, tables, tdf, tqueries)
    for name in SORT_NAMES:
        assert port[name].task_bytes() == ref[name].task_bytes(), name
    pdf = pa.concat_tables(pq.read_table(f)
                           for f in tables["store_sales"]).to_pandas()
    return {n: (port[n].collect(), ref[n].collect())
            for n in SORT_NAMES}, pdf


@pytest.mark.parametrize("name", SORT_NAMES)
def test_sorts_equal_reference_session_in_order(name, sort_results):
    got, want = sort_results[0][name]
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want), name
    if name == "keyless":
        assert got.to_pylist() == [{"q": 119671}]
    if name == "q02_full_sort":
        pdf = sort_results[1]
        assert got.num_rows == pdf.ss_customer_sk.nunique()


@pytest.mark.parametrize("name", ["q02", "q12"])
def test_top_k_matches_the_pandas_oracle_in_order(name, sort_results):
    """The sort keys in the oracle's order (pandas sorts the same float
    values, so the keys are identical), the other columns within the
    comparator's tolerance."""
    got = sort_results[0][name][0]
    query = {q.name.split("_")[0]: q for q in tqueries.QUERIES}[name]
    want = query.expected({"store_sales": sort_results[1]})
    keys = {"q02": "ss_customer_sk", "q12": "ss_item_sk"}[name]
    assert got[keys].to_pylist() == want[keys].to_pylist()
    np.testing.assert_allclose(got["revenue"].to_numpy(),
                               want["revenue"].to_numpy(), rtol=1e-12)
    res = QueryResultComparator().compare(name, got, want)
    assert res.ok, res.report()


# ---------------------------------------------------------------------------
# joins
# ---------------------------------------------------------------------------

#: the join queries the reference Session also runs
REF_JOINS = ("q05", "q05_broadcast", "filtered_probe", "broadcast_right",
             "broadcast_full")


@pytest.fixture(scope="module")
def join_results(data):
    """{name: (port table, reference table or None)} of the join
    queries."""
    tables = data[0]
    rs = RSession(config=rcfg.AuronConfig(
        {rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig(
        {tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}), device="cpu")
    ref = join_cases.reference_dataframes(rs, tables)
    port = join_cases.port_dataframes(ts, tables)
    return {n: (port[n].collect(),
                ref[n].collect() if n in REF_JOINS else None)
            for n in join_cases.NAMES}


@pytest.mark.parametrize("name", REF_JOINS)
def test_joins_equal_reference_session_in_order(name, join_results):
    got, want = join_results[name]
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want), name
    if name.startswith("q05"):
        assert sorted(got["d_moy"].to_pylist()) == list(range(1, 13))


def _join_oracle(name: str, p: dict):
    """The pandas rows of a join query (any order)."""
    if name.startswith("q05"):
        return tqueries._q05_oracle(p)
    if name == "filtered_probe":
        ss = p["store_sales"]
        return tqueries._q05_oracle({**p, "store_sales":
                                     ss[ss.ss_quantity > 10]})
    if name.startswith("q09_"):
        return tqueries._cheap_sales_items_oracle(p, name[4:])
    return tqueries._outer_join_oracle(p, name)


@pytest.mark.parametrize("name", [n for n in join_cases.NAMES
                                  if not n.startswith("broadcast_")])
def test_joins_match_the_pandas_oracle(name, join_results, data):
    got = join_results[name][0]
    expected = pa.Table.from_pandas(
        _join_oracle(name, _pandas_tables(data)).reset_index(drop=True),
        preserve_index=False)
    res = QueryResultComparator().compare(name, got, expected)
    assert res.ok, res.report()
    if name in ("left", "right", "full", "existence", "q09_anti"):
        # the oracle has rows that only an outer, anti or existence
        # join keeps
        assert got.num_rows > join_results["inner"][0].num_rows or \
            name == "q09_anti"


@pytest.mark.parametrize("how", ["right", "full"])
def test_broadcast_outer_joins_keep_the_reference_rows(how, join_results):
    """Over a broadcast build side, every probe partition emits the
    build rows it did not match (ROADMAP Queue 3 item 8): the port gives
    the reference's rows, which are not the co-partitioned answer."""
    got, want = join_results[f"broadcast_{how}"]
    rows = [tuple(r.values()) for r in got.to_pylist()]
    assert rows == [tuple(r.values()) for r in want.to_pylist()]
    assert rows == tqueries.BROADCAST_OUTER_ROWS[how]
    import pandas as pd
    a = pd.DataFrame({"k": [1, 2, 3, 4], "x": [10, 20, 30, 40]})
    b = pd.DataFrame({"k": [2, 5], "y": [7, 8]})
    sql = a.merge(b, on="k", how={"full": "outer"}.get(how, how))
    assert len(sql) == {"right": 2, "full": 5}[how] < len(rows)


def test_read_parquet_prunes_before_converting(data):
    """item holds strings; asking for its integer and float columns only
    gives the reference's schema and rows, and so does asking for every
    column (its strings included)."""
    tables = data[0]
    cols = ["i_current_price", "i_item_sk"]
    rs = RSession()
    ts = TSession(device="cpu")
    want = rs.read_parquet(tables["item"], columns=cols)
    got = ts.read_parquet(tables["item"], columns=cols)
    assert [(f.name, f.dtype.value, f.nullable) for f in got.schema] == \
        [(f.name, f.dtype.value, f.nullable) for f in want.schema]
    assert got.collect().equals(want.collect())
    whole = ts.read_parquet(tables["item"])
    ref_whole = rs.read_parquet(tables["item"])
    assert [(f.name, f.dtype.value) for f in whole.schema] == \
        [(f.name, f.dtype.value) for f in ref_whole.schema]
    assert whole.collect().equals(ref_whole.collect())
