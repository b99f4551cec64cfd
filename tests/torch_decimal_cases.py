"""q15 and the two decimal money queries of ``auron_tpu_torch.it.queries``
and their counterparts in the JAX package, for
``test_torch_decimal_queries.py`` and the serde and planner files.

``reference_dataframes`` builds q15 through the reference's own query
function, its ``collect`` replaced by the DataFrame itself, and the
money queries through the port's query functions written in the
reference's DataFrame DSL; ``port_dataframes`` builds the same through
the port. The two must give identical task bytes, plan trees, result
types and rows.
"""

from unittest import mock

from auron_tpu.frontend import dataframe as rdf
from auron_tpu.it import queries as rqueries
from auron_tpu_torch.it import queries as tqueries
from tests.torch_expression_cases import REFERENCE_DSL

NAMES = ("q15", "decimal_money", "decimal_price_key")

_PORT = {"q15": tqueries.q15_dataframe,
         "decimal_money": tqueries.decimal_money_dataframe,
         "decimal_price_key": tqueries.decimal_price_key_dataframe}


def reference_dataframes(s, t) -> dict:
    """{name: reference DataFrame} over the tables ``t`` ({name: files})."""
    out = {}
    for name in NAMES:
        if name == "q15":
            with mock.patch.object(rdf.DataFrame, "collect",
                                   lambda self, *a, **k: self):
                out[name] = rqueries._q15_run(s, t)
        else:
            out[name] = _PORT[name](s, t, dsl=REFERENCE_DSL)
    return out


def port_dataframes(s, t) -> dict:
    """The same queries through ``auron_tpu_torch.it.queries``."""
    return {name: _PORT[name](s, t) for name in NAMES}
