"""The TPC-DS suite through the port on the CPU, first third (queries
0, 3, 6, ... of ``QUERIES``; ``test_torch_tpcds_2.py`` and ``_3.py``
hold the others).

At the reference's CI scale (0.05, 50,000 store_sales rows), through
``Session(device="cpu")`` and the port's runner:

- each runnable query matches its pyarrow/pandas oracle with the
  reference's comparator (1e-7 relative, 1e-6 absolute over decimals
  cast to float64) and returns rows; among them q16, q94, q95 and q28,
  whose DISTINCT aggregates ride the collect_set accumulator, which are
  also run and held against their oracles on their own here;
- each runnable query's first TaskDefinition equals the reference DSL's
  with every scalar subquery's ``sid`` zeroed;
- ``QUERIES``' names, order and descriptions equal the reference's, and
  the port's generator writes tables equal to the reference's.
"""

import pytest

from auron_tpu.it import tpcds as rtpcds
from auron_tpu.it import tpcds_queries as rqueries
from auron_tpu_torch.it import runner
from auron_tpu_torch.it import tpcds
from auron_tpu_torch.it.tpcds_queries import QUERIES
from tests.torch_suite_cases import (TPCDS_SCALE,  # noqa: F401
                                     _one_torch_thread, first_task,
                                     suite_results, zero_sids)

THIRD = QUERIES[0::3]
RUNNABLE = [q.name for q in THIRD]


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


#: the TPC-DS queries with a DISTINCT aggregate
DISTINCT = ("q16", "q94", "q95", "q28")


@pytest.fixture(scope="module")
def distinct_results(tables):
    return suite_results([q for q in QUERIES if q.name in DISTINCT], tables,
                         tpcds.load_arrow(tables), runner.TPCDS_TOLERANCE)


@pytest.mark.parametrize("qname", DISTINCT)
def test_distinct_query_raises_naming_16f_c(distinct_results, qname):
    """Once refused naming ROADMAP item 16f-c; now each matches its
    oracle and returns rows."""
    r = distinct_results[qname]
    assert r.ok, r.report()
    assert r.rows > 0


def test_queries_equal_the_reference():
    assert len(QUERIES) == 99
    assert [(q.name, q.description) for q in QUERIES] == \
        [(q.name, q.description) for q in rqueries.QUERIES]


@pytest.fixture(scope="module")
def reference_tables(tmp_path_factory):
    files = rtpcds.generate(str(tmp_path_factory.mktemp("tpcds_ref")),
                            scale=TPCDS_SCALE)
    return rtpcds.load_arrow(files)


@pytest.mark.parametrize("name", [
    "date_dim", "time_dim", "item", "customer", "customer_address",
    "customer_demographics", "household_demographics", "store",
    "promotion", "warehouse", "ship_mode", "call_center", "web_site",
    "web_page", "income_band", "store_sales", "store_returns",
    "catalog_sales", "catalog_returns", "web_sales", "web_returns",
    "reason", "inventory"])
def test_generator_tables_equal_the_reference(tables, reference_tables,
                                              name):
    got = tpcds.load_arrow({name: tables[name]})[name]
    assert got.equals(reference_tables[name])
