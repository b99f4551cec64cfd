"""q14 and the expression sweep of ``auron_tpu_torch.it.queries`` and
their counterparts in the JAX package, for ``test_torch_q14.py`` and
``test_torch_sweep.py``.

``reference_dataframes`` builds q14 through the reference's own query
function, its ``collect`` replaced by the DataFrame itself, and the
sweep through the port's query function written in the reference's
DataFrame DSL; ``port_dataframes`` builds the same through the port.
The two must give identical task bytes, plan trees and rows (the
sweep's transcendental columns, named with ``ULP_PREFIX``, within a
few units in the last place).
"""

from types import SimpleNamespace
from unittest import mock

from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.it import queries as rqueries
from auron_tpu_torch.it import queries as tqueries

NAMES = ("q14", "sweep_customer", "sweep_item")

#: the reference's DataFrame DSL, for the port's sweep
REFERENCE_DSL = SimpleNamespace(col=rdf.col, lit=rdf.lit, F=rdf.functions,
                                ir=rir, Col=rdf.Col, DataType=RDT)


def reference_dataframes(s, t, names=NAMES) -> dict:
    """{name: reference DataFrame} over the tables ``t`` ({name: files};
    customer and item)."""
    out = {}
    if "q14" in names:
        with mock.patch.object(rdf.DataFrame, "collect",
                               lambda self, *a, **k: self):
            out["q14"] = rqueries._q14_run(s, t)
    for table in ("customer", "item"):
        if f"sweep_{table}" in names:
            out[f"sweep_{table}"] = tqueries.expression_sweep_dataframe(
                s, t, table, dsl=REFERENCE_DSL)
    return out


def port_dataframes(s, t, names=NAMES) -> dict:
    """The same queries through ``auron_tpu_torch.it.queries``."""
    out = {}
    if "q14" in names:
        out["q14"] = tqueries.q14_dataframe(s, t)
    for table in ("customer", "item"):
        if f"sweep_{table}" in names:
            out[f"sweep_{table}"] = tqueries.expression_sweep_dataframe(
                s, t, table)
    return out
