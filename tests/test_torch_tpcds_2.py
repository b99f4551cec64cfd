"""The TPC-DS suite through the port on the CPU, second third (queries
1, 4, 7, ... of ``QUERIES``): the checks of ``test_torch_tpcds_1.py``
but the suite-wide ones and the
four DISTINCT queries'.
"""

import pytest

from auron_tpu.it import tpcds_queries as rqueries
from auron_tpu_torch.it import runner
from auron_tpu_torch.it import tpcds
from auron_tpu_torch.it.tpcds_queries import QUERIES
from tests.torch_suite_cases import (DISTINCT, TPCDS_SCALE,  # noqa: F401
                                     _one_torch_thread, first_task,
                                     suite_results, zero_sids)

THIRD = QUERIES[1::3]
RUNNABLE = [q.name for q in THIRD if q.name not in DISTINCT]


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return tpcds.generate(str(tmp_path_factory.mktemp("tpcds")),
                          scale=TPCDS_SCALE)


@pytest.fixture(scope="module")
def results(tables):
    return suite_results([q for q in THIRD if q.name in RUNNABLE], tables,
                         tpcds.load_arrow(tables), runner.TPCDS_TOLERANCE)


@pytest.mark.parametrize("qname", RUNNABLE)
def test_query_matches_oracle(results, qname):
    r = results[qname]
    assert r.ok, r.report()


@pytest.mark.parametrize("qname", RUNNABLE)
def test_query_returns_rows(results, qname):
    assert results[qname].rows > 0, \
        f"{qname} returned 0 rows at scale {TPCDS_SCALE}"


@pytest.mark.parametrize("qname", RUNNABLE)
def test_first_task_equals_the_reference(tables, qname):
    (got,) = [q for q in THIRD if q.name == qname]
    (want,) = [q for q in rqueries.QUERIES if q.name == qname]
    assert zero_sids(first_task(got.run, tables, reference=False)) == \
        zero_sids(first_task(want.run, tables, reference=True))
