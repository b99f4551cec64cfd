"""The string queries of ``auron_tpu_torch.it.queries`` (q03, q04 and
q06 to q09) and their counterparts in the JAX package, for the
``test_torch_*`` files that hold the port's front end against the
reference's.

``reference_dataframes`` builds each query through the reference's own
query function, its ``collect`` replaced by the DataFrame itself;
``port_dataframes`` calls the port's query functions. The two must give
identical task bytes, plan trees and rows.
"""

from unittest import mock

from auron_tpu.frontend import dataframe as rdf
from auron_tpu.it import queries as rqueries
from auron_tpu_torch.it import queries as tqueries

NAMES = ("q03", "q04", "q06", "q07", "q08", "q09")


def reference_dataframes(s, t) -> dict:
    """{name: reference DataFrame} over the tables ``t`` ({name: files};
    store_sales, customer, item and store)."""
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        return {n: getattr(rqueries, f"_{n}_run")(s, t) for n in NAMES}


def port_dataframes(s, t) -> dict:
    """The same queries through ``auron_tpu_torch.it.queries``."""
    return {n: getattr(tqueries, f"{n}_dataframe")(s, t) for n in NAMES}


def oracle(name: str):
    """The query's pandas oracle, as ``it.queries.QUERIES`` holds it."""
    return next(q for q in tqueries.QUERIES if q.name.startswith(name))
