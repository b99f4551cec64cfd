"""q14 through the port's Session against the JAX package's, on the CPU.

Scale 0.1 of the TPC-DS-class dataset (100 items, seed 7). q14
(``it/queries.py``: ``initcap``, ``substring_index`` and ``concat_ws``
over item, a filter, ``count(*)`` and ``min`` of a string per derived
string key, a sort) goes through ``Session(device="cpu")`` → DataFrame
→ TaskDefinition bytes → planner → ``collect``:

- the port's task bytes equal the reference DataFrame's;
- ``plan_from_bytes`` gives the reference planner's tree, node by node;
- the rows equal the reference Session's in order, bit for bit, and
  agree with the pandas oracle under ``QueryResultComparator``.

The expression sweep, through the same path, is ``test_torch_sweep.py``.
"""

import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.it import queries as tqueries
from auron_tpu_torch.it.comparator import QueryResultComparator
from tests import torch_expression_cases as cases
from tests.test_torch_planner import _same_tree

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17
NAMES = ("q14",)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds_q14"))
    return rdata.generate(root, SCALE, SEED)


@pytest.fixture(scope="module")
def frames(data):
    rs = RSession(config=rcfg.AuronConfig({rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}),
                  device="cpu")
    return (rs, cases.reference_dataframes(rs, data, NAMES),
            cases.port_dataframes(ts, data, NAMES))


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


def test_q14_equals_reference_session(results, data):
    want, got = results["q14"]
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want)
    query = next(q for q in tqueries.QUERIES if q.name.startswith("q14"))
    pdf = {"item": pq.read_table(data["item"][0]).to_pandas()}
    res = QueryResultComparator().compare("q14", got, query.expected(pdf))
    assert res.ok, res.report()
