"""q15 and the decimal money queries through the port's Session against
the JAX package's, on the CPU.

Scale 0.1 of the TPC-DS-class dataset (12,000 store_sales rows, seed 7),
through ``Session(device="cpu")`` → DataFrame → TaskDefinition bytes →
planner → ``collect``:

- q15: decimal(25,2) × decimal(20,0) on the limbs (Spark's type
  decimal(38,2)), a filter, a top-25 sort on the product;
- ``decimal_money``: narrow and wide sums and averages, wide min and
  max, a count and a narrow product whose sum moves to the limbs, per
  store;
- ``decimal_price_key``: a decimal(20,2) group key through the hash
  table, a top-100 sort on it.

For each, the port's task bytes equal the reference DataFrame's,
``plan_from_bytes`` gives the reference planner's tree, the result
fields' (precision, scale) are the reference's, and the rows equal the
reference Session's in order, exactly; each also equals its oracle in
Python's ``decimal``.
"""

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.it import queries as tqueries
from auron_tpu_torch.it.comparator import compare_cells
from tests import torch_decimal_cases as cases
from tests.test_torch_planner import _same_tree

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17
NAMES = cases.NAMES

ORACLES = {"q15": tqueries._q15_oracle,
           "decimal_money": tqueries._decimal_money_oracle,
           "decimal_price_key": tqueries._decimal_price_key_oracle}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds_decimal"))
    return rdata.generate(root, SCALE, SEED)


@pytest.fixture(scope="module")
def frames(data):
    rs = RSession(config=rcfg.AuronConfig({rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}),
                  device="cpu")
    return (rs, cases.reference_dataframes(rs, data),
            cases.port_dataframes(ts, data))


@pytest.fixture(scope="module")
def results(frames):
    _rs, ref, port = frames
    return {n: (ref[n].collect(), port[n].collect()) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_task_bytes_and_tree_equal_reference(name, frames):
    rs, ref, port = frames
    data = port[name].task_bytes()
    assert data == ref[name].task_bytes()
    want = rplan_from_bytes(data, rs.ctx)
    got = plan_from_bytes(data, PlannerContext(device="cpu"))
    _same_tree(got, want)


@pytest.mark.parametrize("name", NAMES)
def test_rows_and_types_equal_reference_session(name, results):
    want, got = results[name]
    assert got.num_rows == want.num_rows > 0
    assert got.schema.equals(want.schema)
    bad, _ = compare_cells(want, got)
    assert not bad, bad


@pytest.mark.parametrize("name", NAMES)
def test_rows_equal_decimal_oracle(name, results, data):
    _want, got = results[name]
    pdf = {"store_sales": pa.concat_tables(
        [pq.read_table(f) for f in data["store_sales"]]).to_pandas()}
    assert got.to_pylist() == pa.Table.from_pandas(
        ORACLES[name](pdf).reset_index(drop=True),
        preserve_index=False).to_pylist()


def test_result_types_are_sparks(results):
    _want, got = results["q15"]
    assert got.schema.field("rev_dec").type == pa.decimal128(38, 2)
    _want, got = results["decimal_money"]
    for name, (p, s) in tqueries.DECIMAL_MONEY_TYPES.items():
        assert got.schema.field(name).type == pa.decimal128(p, s), name
    _want, got = results["decimal_price_key"]
    assert got.schema.field("price_key").type == pa.decimal128(20, 2)


def test_parquet_decimal_columns_equal_reference(tmp_path):
    """Arrow decimal128 columns, narrow and wide, through parquet: a scan
    gives back the file's values exactly, and an aggregate over them
    gives Spark's types and the exact values of Python's ``decimal``
    (sum, min and max exact, avg rounded HALF_UP to its scale), as the
    reference computes them (its aggregates are held against the port's
    in ``test_torch_agg.py``; this module's reference Session compiles
    only the three queries)."""
    import decimal

    import numpy as np

    from auron_tpu_torch.frontend import dataframe as tdf

    rng = np.random.default_rng(3)
    n = 500
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        narrow = [decimal.Decimal(int(x)).scaleb(-2) if x % 11 else None
                  for x in rng.integers(-10 ** 6, 10 ** 6, n)]
        wide = [decimal.Decimal(int(x) * 10 ** 20 + int(y)).scaleb(-4)
                if y % 13 else None for x, y in zip(
                    rng.integers(-10 ** 5, 10 ** 5, n),
                    rng.integers(-10 ** 9, 10 ** 9, n))]
    keys = rng.integers(0, 9, n)
    table = pa.table({"k": pa.array(keys, pa.int64()),
                      "n": pa.array(narrow, pa.decimal128(9, 2)),
                      "w": pa.array(wide, pa.decimal128(30, 4))})
    files = []
    for i in range(2):
        path = str(tmp_path / f"dec_{i}.parquet")
        pq.write_table(table.slice(i * 250, 250), path)
        files.append(path)
    ts = TSession(device="cpu")
    scanned = ts.read_parquet(files).collect()
    assert scanned.equals(table)

    F, col = tdf.functions, tdf.col
    got = (ts.read_parquet(files, partitions=2).group_by("k")
           .agg(F.sum(col("n")).alias("sn"), F.sum(col("w")).alias("sw"),
                F.min(col("w")).alias("lw"), F.max(col("n")).alias("hn"),
                F.avg(col("w")).alias("aw"))
           .sort(col("k").asc())).collect()
    want = {c: [] for c in ("k", "sn", "sw", "lw", "hn", "aw")}
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        for k in range(9):
            ns = [v for v, kk in zip(narrow, keys)
                  if kk == k and v is not None]
            ws = [v for v, kk in zip(wide, keys)
                  if kk == k and v is not None]
            want["k"].append(k)
            want["sn"].append(sum(ns))
            want["sw"].append(sum(ws))
            want["lw"].append(min(ws))
            want["hn"].append(max(ns))
            want["aw"].append((sum(ws) / len(ws)).quantize(
                decimal.Decimal(1).scaleb(-8), decimal.ROUND_HALF_UP))
    types = {"k": pa.int64(), "sn": pa.decimal128(19, 2),
             "sw": pa.decimal128(38, 4), "lw": pa.decimal128(30, 4),
             "hn": pa.decimal128(9, 2), "aw": pa.decimal128(34, 8)}
    assert got.equals(pa.table({c: pa.array(v, types[c])
                                for c, v in want.items()}))
