"""Shared pieces of the TPC-DS and TPC-H suite tests of the port
(``tests/test_torch_tpcds_*.py``, ``tests/test_torch_tpch.py``): the
generated data, the per-query results through the port's runner on the
CPU, and the first TaskDefinition of a query in either package's DSL.
"""

from unittest import mock

import pytest
import torch

from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.ir import auron_pb2 as tpb
from auron_tpu_torch.it import runner

#: the reference's CI scales (tests/test_tpcds_real.py,
#: tests/test_tpch.py)
TPCDS_SCALE = 0.05
TPCH_SCALE = 0.3

#: the TPC-DS queries with a DISTINCT aggregate: their collect_set state
#: needs the list columns of ROADMAP item 16f-c
DISTINCT = ("q16", "q94", "q95", "q28")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def suite_results(queries, tables, arrow, tolerance) -> dict:
    """{name: ComparisonResult} of ``queries`` over ``tables`` ({name:
    files}) through the port's runner on the CPU, diffed against their
    oracles over ``arrow`` ({name: Table}), run in this process, with
    the suite's tolerance."""
    expected = {q.name: (q.oracle(arrow), 0.0) for q in queries}
    return {r.name: r for r in runner._run_suite(
        queries, tables, expected,
        runner.QueryResultComparator(**tolerance), device="cpu",
        verbose=False)}


class _FirstCollect(Exception):
    pass


def first_task(query_run, tables, reference: bool) -> bytes:
    """The TaskDefinition bytes of the first ``collect()`` a query's
    ``run`` makes, in the reference's DSL or the port's: ``collect`` is
    patched to save them and stop the query, so nothing executes."""
    dsl = rdf if reference else tdf
    session = RSession() if reference else TSession(device="cpu")
    seen = []

    def collect(self, *a, **k):
        seen.append(self.task_bytes())
        raise _FirstCollect

    with mock.patch.object(dsl.DataFrame, "collect", collect):
        with pytest.raises(_FirstCollect):
            query_run(session, tables)
    return seen[0]


def zero_sids(data: bytes, message=tpb.TaskDefinition) -> bytes:
    """``data`` (a serialized ``message``: a TaskDefinition, or a
    ScalarSubqueryE such as a ``subquery_key``) with every
    ScalarSubqueryE's ``sid`` zeroed, nested ones included. Each DSL
    stamps subqueries from its own process-wide counter, so the bytes
    agree only without them."""
    msg = message.FromString(data)

    def walk(m):
        if isinstance(m, tpb.ScalarSubqueryE):
            m.sid = 0
        for fd, val in m.ListFields():
            if fd.type == fd.TYPE_MESSAGE:
                for v in (val if fd.is_repeated else [val]):
                    walk(v)
    walk(msg)
    return msg.SerializeToString()
