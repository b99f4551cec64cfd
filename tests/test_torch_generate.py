"""The port's GenerateOp against the JAX package's, on the CPU.

The cases of ``tests/test_generate.py`` and ``test_string_lists.py``'s
explodes, at a small size: a batch of list<int64> and list<string>
with a null list, an empty list and null elements.

- ``explode`` and ``posexplode``, plain and ``outer``, over each list
  type: the reference's rows in the reference's order, the position and
  element null on an outer row;
- ``json_tuple`` through the host generator: the reference's rows;
- the DSL's ``explode`` serializes to the reference's plan bytes, and an
  explode of a per-customer ``collect_set`` through the Session gives
  one row per distinct (customer, item) (``it/nested.py``'s oracle);
- a UDTF raises naming ROADMAP item 17b.
"""

from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops.generate import GenerateOp as RGen
from auron_tpu.runtime.executor import collect as rcollect
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.it import nested, tpcds_data
from auron_tpu_torch.ops.generate import GenerateOp as TGen
from auron_tpu_torch.runtime.executor import collect as tcollect


def _rb():
    return pa.record_batch({
        "k": pa.array([1, 2, 3, 4, 5, 6], pa.int64()),
        "li": pa.array([[10, None, 30], [], None, [40], [50, 60], None],
                       pa.list_(pa.int64())),
        "ls": pa.array([["a", None], None, [], ["xyz", "q"], ["bb"], []],
                       pa.list_(pa.string())),
        "j": pa.array(['{"a": 1, "b": "x"}', None, "not json",
                       '{"b": [1, 2]}', '{"a": null}', "[]"], pa.string()),
    })


def _run(pkg, kind, gen_col, outer, json_fields=None):
    rb = _rb()
    if pkg == "port":
        scan = TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                    capacity=8, device="cpu")
        op = TGen(scan, kind, tir.ColumnRef(gen_col), json_fields,
                  required_child_output=[0], outer=outer)
        return tcollect(op)
    scan = RMem([[rb]], rbridge.schema_from_arrow(rb.schema), capacity=8)
    op = RGen(scan, kind, rir.ColumnRef(gen_col), json_fields,
              required_child_output=[0], outer=outer)
    return rcollect(op)


@pytest.mark.parametrize("kind", ["explode", "posexplode"])
@pytest.mark.parametrize("gen_col", [1, 2], ids=["ints", "strings"])
@pytest.mark.parametrize("outer", [False, True], ids=["inner", "outer"])
def test_explode_matches_reference(kind, gen_col, outer):
    got = _run("port", kind, gen_col, outer)
    want = _run("ref", kind, gen_col, outer)
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()
    assert got.num_rows > 0


def test_outer_rows_have_null_position_and_element():
    got = _run("port", "posexplode", 1, True).to_pylist()
    outer = [r for r in got if r["k"] in (2, 3, 6)]
    assert outer == [{"k": k, "pos": None, "col": None} for k in (2, 3, 6)]


def test_json_tuple_matches_reference():
    got = _run("port", "json_tuple", 3, False, ["a", "b"])
    want = _run("ref", "json_tuple", 3, False, ["a", "b"])
    assert got.to_pylist() == want.to_pylist()


def test_udtf_raises_naming_17b():
    rb = _rb()
    scan = TMem([[rb]], tbridge.schema_from_arrow(rb.schema), device="cpu")
    with pytest.raises(NotImplementedError, match="17b"):
        TGen(scan, "udtf", udtf_name="u")


@pytest.fixture(scope="module")
def sales(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sales"))
    files = tpcds_data.generate(root, 0.05)["store_sales"]
    ss = pa.concat_tables([pq.read_table(f) for f in files]).to_pandas()
    return {"store_sales": files}, ss


def test_dsl_explode_of_a_set_matches_the_oracle(sales):
    t, ss = sales
    tdf_ = nested.exploded_sets_dataframe(TSession(device="cpu"), t)
    rdsl = SimpleNamespace(col=rdf.col, lit=rdf.lit, F=rdf.functions)
    rdf_ = nested.exploded_sets_dataframe(RSession(), t, dsl=rdsl)
    assert tdf_.task_bytes() == rdf_.task_bytes()
    assert nested.check_exploded(tdf_.collect(), ss) == []
    pos = nested.exploded_sets_dataframe(TSession(device="cpu"), t, pos=True)
    assert nested.check_exploded(pos.collect(), ss, pos=True) == []
    assert np.array_equal(tdf_.collect().column_names,
                          ["ss_customer_sk", "col"])


def test_explode_keeps_a_decimal_elements_precision():
    """A departure (ROADMAP Queue 3): the element of an exploded
    list<decimal(p, s)> keeps (p, s), and a list<decimal(p > 18)>
    explodes too; the reference types the element decimal(0, 0)."""
    import decimal
    D = decimal.Decimal
    for p in (7, 25):
        rb = pa.record_batch({
            "k": pa.array([1, 2, 3], pa.int64()),
            "l": pa.array([[D("1.25"), None], None, [D("-3.50")]],
                          pa.list_(pa.decimal128(p, 2)))})
        scan = TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                    capacity=4, device="cpu")
        got = tcollect(TGen(scan, "posexplode", tir.ColumnRef(1),
                            outer=True, required_child_output=[0]))
        assert got.schema.field("col").type == pa.decimal128(p, 2)
        assert got.to_pylist() == [
            {"k": 1, "pos": 0, "col": D("1.25")},
            {"k": 1, "pos": 1, "col": None},
            {"k": 2, "pos": None, "col": None},
            {"k": 3, "pos": 0, "col": D("-3.50")}]
