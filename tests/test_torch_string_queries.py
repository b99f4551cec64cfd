"""The string queries through the port's Session against the JAX
package's, on the CPU.

Scale 0.1 of the TPC-DS-class dataset (12,000 store_sales rows in 4
parquet files; 400 customers, 100 items and 2 stores, whose
``c_state``, ``c_email``, ``i_category`` and ``s_state`` are strings;
seed 7), ``auron.scan.batch_rows = 2^17`` in both packages. q03, q04
and q06 to q09 (``it/queries.py``) run through ``Session(device="cpu")``
→ DataFrame → TaskDefinition bytes → planner → ``collect``, and:

- the port returns the reference Session's rows in the same order, bit
  for bit (``pyarrow.Table.equals``: the float sums of a group add in
  the same order in both packages);
- the port's result agrees with the pandas oracle under the port's
  ``QueryResultComparator``;
- ``read_parquet`` of the customer table gives the reference's schema,
  ``c_state`` and ``c_email`` as strings, and its rows.

The task bytes and the planned trees of the same queries are held
against the reference's in ``test_torch_serde.py`` and
``test_torch_planner.py``.
"""

import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.it.comparator import QueryResultComparator
from tests import torch_string_cases as string_cases

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds_strings"))
    return rdata.generate(root, SCALE, SEED)


@pytest.fixture(scope="module")
def sessions():
    return (RSession(config=rcfg.AuronConfig(
        {rcfg.SCAN_BATCH_ROWS: BATCH_ROWS})),
        TSession(config=tcfg.AuronConfig(
            {tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}), device="cpu"))


def _pandas(tables) -> dict:
    import pandas as pd
    return {name: pd.concat(pq.read_table(f).to_pandas() for f in files)
            .reset_index(drop=True) for name, files in tables.items()}


@pytest.mark.parametrize("name", string_cases.NAMES)
def test_string_query_equals_reference_session(name, data, sessions):
    rs, ts = sessions
    want = string_cases.reference_dataframes(rs, data)[name].collect()
    got = string_cases.port_dataframes(ts, data)[name].collect()
    assert got.num_rows == want.num_rows > 0
    assert got.equals(want)
    query = string_cases.oracle(name)
    res = QueryResultComparator().compare(name, got,
                                          query.expected(_pandas(data)))
    assert res.ok, res.report()


def test_read_parquet_of_strings_equals_reference(data, sessions):
    rs, ts = sessions
    want = rs.read_parquet(data["customer"])
    got = ts.read_parquet(data["customer"])
    assert [(f.name, f.dtype.value, f.nullable) for f in got.schema] == \
        [(f.name, f.dtype.value, f.nullable) for f in want.schema]
    assert {f.name: f.dtype.value for f in got.schema}["c_email"] \
        == "string"
    table = got.collect()
    assert table.equals(want.collect())
    assert table.num_rows == 400 and table["c_email"].null_count > 0
