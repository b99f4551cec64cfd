"""The expression sweep through the port's Session against the JAX
package's, on the CPU.

Scale 0.1 of the TPC-DS-class dataset (400 customers and 100 items,
seed 7). The sweep over customer and over item
(``it/queries.expression_sweep_dataframe``: every scalar function and
node the port evaluates) goes through ``Session(device="cpu")`` →
DataFrame → TaskDefinition bytes → planner → ``collect``:

- the port's task bytes equal the reference DataFrame's;
- ``plan_from_bytes`` gives the reference planner's tree, node by node;
- the rows equal the reference Session's cell by cell in order,
  exactly, but its transcendental columns (``ULP_PREFIX``), which may
  differ by at most ``ULP_BOUND`` units in the last place; a float
  division by a constant is compiled by the reference as a
  multiplication by the reciprocal, and the port computes it so.
"""

import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.it.comparator import compare_cells
from tests import torch_expression_cases as cases
from tests.test_torch_planner import _same_tree

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17
NAMES = ("sweep_customer", "sweep_item")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds_sweep"))
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


@pytest.mark.parametrize("name", NAMES)
def test_sweep_equals_reference_session(name, results):
    want, got = results[name]
    assert got.num_rows == want.num_rows > 0
    bad, seen = compare_cells(want, got)
    assert not bad, bad
    assert seen or name == "sweep_customer"
