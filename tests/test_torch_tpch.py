"""The TPC-H suite through the port on the CPU.

At the reference's CI scale (0.3, 18,000 lineitems), through
``Session(device="cpu")`` and the port's runner: each of the six
queries (q1, q3, q5, q6, q9, q18) matches its pandas oracle with the
reference's comparator (1e-7 relative, 1e-5 absolute over decimals cast
to float64) and returns rows, and its first TaskDefinition equals the
reference DSL's. ``QUERIES``' names, order and descriptions equal the
reference's, and the port's generator writes tables equal to the
reference's.
"""

import pytest

from auron_tpu.it import tpch as rtpch
from auron_tpu.it import tpch_queries as rqueries
from auron_tpu_torch.it import runner
from auron_tpu_torch.it import tpch
from auron_tpu_torch.it.tpch_queries import QUERIES
from tests.torch_suite_cases import (TPCH_SCALE,  # noqa: F401
                                     _one_torch_thread, first_task,
                                     suite_results)

NAMES = [q.name for q in QUERIES]
TABLES = ("nation", "region", "supplier", "part", "partsupp", "customer",
          "orders", "lineitem")


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    return tpch.generate(str(tmp_path_factory.mktemp("tpch")),
                         scale=TPCH_SCALE)


@pytest.fixture(scope="module")
def results(tables):
    return suite_results(QUERIES, tables, tpch.load_arrow(tables),
                         runner.TPCH_TOLERANCE)


@pytest.mark.parametrize("qname", NAMES)
def test_query_matches_oracle(results, qname):
    r = results[qname]
    assert r.ok, r.report()


@pytest.mark.parametrize("qname", NAMES)
def test_query_returns_rows(results, qname):
    assert results[qname].rows > 0, \
        f"{qname} returned 0 rows at scale {TPCH_SCALE}"


@pytest.mark.parametrize("qname", NAMES)
def test_first_task_equals_the_reference(tables, qname):
    (got,) = [q for q in QUERIES if q.name == qname]
    (want,) = [q for q in rqueries.QUERIES if q.name == qname]
    assert first_task(got.run, tables, reference=False) == \
        first_task(want.run, tables, reference=True)


def test_queries_equal_the_reference():
    assert len(QUERIES) == 6
    assert [(q.name, q.description) for q in QUERIES] == \
        [(q.name, q.description) for q in rqueries.QUERIES]


@pytest.fixture(scope="module")
def reference_tables(tmp_path_factory):
    files = rtpch.generate(str(tmp_path_factory.mktemp("tpch_ref")),
                           scale=TPCH_SCALE)
    return rtpch.load_arrow(files)


@pytest.mark.parametrize("name", TABLES)
def test_generator_tables_equal_the_reference(tables, reference_tables,
                                              name):
    got = tpch.load_arrow({name: tables[name]})[name]
    assert got.equals(reference_tables[name])
