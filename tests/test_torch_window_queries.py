"""q16 and the rollup → rank query through the port's Session against
the JAX package's, on the CPU.

Scale 0.1 of the TPC-DS-class dataset (seed 7), through
``Session(device="cpu")`` → DataFrame → TaskDefinition bytes → planner →
``collect``:

- q16 (``it/queries.q16_dataframe``): a sum per (store, item), ``rank()``
  within the store by the sum descending, the top 3, a sort;
- ``rollup_rank`` (``it/queries.rollup_rank_dataframe``, q67's shape):
  store_sales joined with a broadcast item, ``rollup(i_category,
  i_brand)`` of a float64 revenue, ``rank()`` within the category, the
  top 5, a sort.

For each, the port's task bytes equal the reference DataFrame's and
``plan_from_bytes`` gives the reference planner's tree. q16's rows and
Arrow types equal the reference Session's, in order: keys and ranks
exactly, float64 sums within 1e-12 of their group's Σ|v| (the reference
sums in another order). Both equal their pandas oracles the same way.
The reference Session does not run ``rollup_rank``: its programs for the
join, the expand and the window compile for ~30 s on the CPU, and the
pandas oracle decides its rows.
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
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import queries as rqueries
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.it import queries as tqueries
from tests.test_torch_planner import _same_tree
from tests.torch_expression_cases import REFERENCE_DSL

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17
NAMES = ("q16", "rollup_rank")

#: float64 sums: within this share of the group's Σ|v|
F64_SUM_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return rdata.generate(str(tmp_path_factory.mktemp("tpcds_window")),
                          SCALE, SEED)


@pytest.fixture(scope="module")
def pdf(data):
    return {name: pa.concat_tables([pq.read_table(f) for f in files])
            .to_pandas() for name, files in data.items()
            if name in ("store_sales", "item")}


@pytest.fixture(scope="module")
def queries(data):
    """{name: (reference Session, reference DataFrame, port DataFrame,
    reference rows, port rows)}."""
    rs = RSession(config=rcfg.AuronConfig({rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}),
                  device="cpu")
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        ref = {"q16": rqueries._q16_run(rs, data)}
    ref["rollup_rank"] = tqueries.rollup_rank_dataframe(rs, data,
                                                        dsl=REFERENCE_DSL)
    port = {"q16": tqueries.q16_dataframe(ts, data),
            "rollup_rank": tqueries.rollup_rank_dataframe(ts, data)}
    return {n: (rs, ref[n], port[n],
                ref[n].collect() if n == "q16" else None, port[n].collect())
            for n in NAMES}


def _abs_sums(pdf) -> dict:
    """Σ|v| of each query's float sum column, per output row's group, as
    the oracle keys it."""
    ss, it = pdf["store_sales"], pdf["item"]
    per_item = ss.assign(a=ss.ss_sales_price.abs()).groupby(
        ["ss_store_sk", "ss_item_sk"]).a.sum()
    j = ss.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    a = (j.ss_sales_price * j.ss_quantity).abs()
    j = j.assign(a=a)
    rolled = {**j.groupby(["i_category", "i_brand"]).a.sum().to_dict(),
              **{(c, None): v for c, v in
                 j.groupby("i_category").a.sum().items()},
              (None, None): a.sum()}
    return {"q16": lambda r: per_item[(r["ss_store_sk"], r["ss_item_sk"])],
            "rollup_rank": lambda r: rolled[(r["i_category"],
                                             r["i_brand"])]}


_SUM = {"q16": "rev", "rollup_rank": "total"}


@pytest.mark.parametrize("name", NAMES)
def test_task_bytes_and_tree_equal_reference(name, queries):
    rs, ref, port, _want, _got = queries[name]
    data = port.task_bytes()
    assert data == ref.task_bytes()
    _same_tree(plan_from_bytes(data, PlannerContext(device="cpu")),
               rplan_from_bytes(data, rs.ctx))


def test_q16_rows_and_types_equal_reference_session(queries, pdf):
    name = "q16"
    _rs, _ref, _port, want, got = queries[name]
    assert got.num_rows == want.num_rows > 0
    assert got.schema.equals(want.schema)
    scale = _abs_sums(pdf)[name]
    s = _SUM[name]
    for g, w in zip(got.to_pylist(), want.to_pylist()):
        assert {k: v for k, v in g.items() if k != s} == \
            {k: v for k, v in w.items() if k != s}
        assert abs(g[s] - w[s]) <= F64_SUM_TOL * scale(w)


@pytest.mark.parametrize("name", NAMES)
def test_rows_equal_oracle(name, queries, pdf):
    _rs, _ref, _port, _want, got = queries[name]
    oracle = {"q16": tqueries._q16_oracle,
              "rollup_rank": tqueries._rollup_rank_oracle}[name]
    want = pa.Table.from_pandas(oracle(pdf).reset_index(drop=True),
                                preserve_index=False)
    assert got.column_names == want.column_names
    scale = _abs_sums(pdf)[name]
    s = _SUM[name]
    for g, w in zip(got.to_pylist(), want.to_pylist()):
        assert {k: v for k, v in g.items() if k != s} == \
            {k: v for k, v in w.items() if k != s}
        assert abs(g[s] - w[s]) <= F64_SUM_TOL * scale(w)
    assert got.num_rows == want.num_rows


def test_rollup_rank_has_the_rolled_up_rows(queries):
    """Each category's rolled-up row (brand null, grouping id 1) ranks 1
    in its category; the grand total (both null, id 3) is the null
    category's one row; every other row is a (category, brand) group of
    id 0 and rank 2 to 5."""
    _rs, _ref, _port, _want, got = queries["rollup_rank"]
    rows = got.to_pylist()
    cats = {r["i_category"] for r in rows if r["i_category"] is not None}
    assert rows[0]["i_category"] is None and rows[0]["i_brand"] is None
    assert (rows[0]["spark_grouping_id"], rows[0]["rk"]) == (3, 1)
    for c in cats:
        part = [r for r in rows if r["i_category"] == c]
        assert (part[0]["i_brand"], part[0]["spark_grouping_id"],
                part[0]["rk"]) == (None, 1, 1)
        assert [r["spark_grouping_id"] for r in part[1:]] == \
            [0] * (len(part) - 1)
        assert 1 < min(r["rk"] for r in part[1:]) and \
            max(r["rk"] for r in part) <= tqueries.ROLLUP_RANK_TOP
    assert got.schema.field("spark_grouping_id").type == pa.int32()
    assert np.all(np.diff([r["rk"] for r in rows[1:6]]) >= 0)
