"""The port's protobuf IR and serde against the JAX package's, on the CPU.

- expressions, aggregates, sort orders and schemas of the port's IR
  round-trip through the port's messages and serialize to the same
  bytes as the same trees in the reference's IR;
- for q01, q02, q10, q11, q12, q13 (``it/queries.py``), q02's full
  sort (no limit: a range exchange), a keyless aggregate, the in-memory
  query ``store_quantity_dataframe``, a scan of two columns and the join
  queries (``torch_join_cases``: q05 co-partitioned and over a broadcast
  build side, semi and anti against a broadcast, each join type
  co-partitioned, right and full over a broadcast) and the string
  queries (``torch_string_cases``: q03, q04 and q06 to q09, with an
  ``IN`` list and string comparisons) and the decimal queries
  (``torch_decimal_cases``: q15 and the two money queries, with casts
  to decimals of both representations), the port DataFrame's
  ``task_bytes()`` equals the reference DataFrame's byte for byte;
- decimal literals and casts keep their precision and scale;
- ``InList`` over strings and numbers round-trips to the reference's
  bytes; the nodes of ROADMAP item 17b raise naming it, and
  ``get_struct_field`` parses;
- ``DataFrame.partitioning`` equals the reference's after every
  transform that carries, sets or drops it;
- reference bytes parse in the port and port bytes in the reference;
- the port's messages are its own classes, not the reference's.
"""

from unittest import mock

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu.columnar import schema as rschema
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir import auron_pb2 as rpb
from auron_tpu.ir import serde as rserde
from auron_tpu.it import queries as rqueries
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch.columnar import schema as tschema
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.ir import auron_pb2 as tpb
from auron_tpu_torch.ir import serde as tserde
from auron_tpu_torch.it import queries as tqueries
from tests import torch_join_cases as join_cases
from tests import torch_decimal_cases as decimal_cases
from tests import torch_string_cases as string_cases

NAMES = ("q01", "q02", "q10", "q11", "q12", "q13", "q02_full_sort",
         "keyless", "store_quantity", "pruned") + join_cases.NAMES \
    + string_cases.NAMES + decimal_cases.NAMES


def _exprs(ir, DT):
    """The same expression trees, built in either package's IR."""
    C, L, B = ir.ColumnRef, ir.Literal, ir.BinaryExpr
    return [
        C(3, "ss_store_sk"), C(0),
        L(5, DT.INT64), L(-7, DT.INT32), L(2.5, DT.FLOAT64),
        L(True, DT.BOOL), L(None, DT.FLOAT64), L(None, DT.NULL),
        L(123, DT.DECIMAL, 10, 2), L("CA", DT.STRING),
        B(">", C(4), L(5, DT.INT64)),
        B("and", B("<", C(5), L(10.0, DT.FLOAT64)),
          ir.Not(ir.IsNull(C(7)))),
        B("or", ir.IsNotNull(C(1)), B("==", B("+", C(2), C(3)),
                                      B("%", C(0), L(3, DT.INT64)))),
        B("*", C(5), ir.Cast(C(4, "ss_quantity"), DT.FLOAT64)),
        ir.Cast(C(2), DT.INT32, safe=False),
        ir.Cast(ir.Cast(C(0), DT.DECIMAL, 12, 2), DT.FLOAT32),
        ir.InList(C(1, "i_category"), ("Books", "Music", "日本")),
        ir.InList(C(0), (1, 2, 3), True),
        B("<", C(1), L("Electronics", DT.STRING)),
        L(-123456789012345678, DT.DECIMAL, 30, 4),
        ir.Cast(C(5), DT.DECIMAL, 25, 2),
        B("*", ir.Cast(C(5), DT.DECIMAL, 25, 2),
          ir.Cast(C(4), DT.DECIMAL, 20, 0)),
    ]


def _aggs(ir):
    C = ir.ColumnRef
    return [ir.AggFunction("sum", C(5)), ir.AggFunction("count", C(7)),
            ir.AggFunction("avg", C(6)), ir.AggFunction("count_star"),
            ir.AggFunction("min", C(1), True),
            ir.AggFunction("max", C(2), False, 100, 0.01)]


def _schema(S):
    DT = S.DataType
    return S.Schema((S.Field("a", DT.INT64, False),
                     S.Field("b", DT.FLOAT64),
                     S.Field("d", DT.DECIMAL, True, 12, 3),
                     S.Field("l", DT.LIST, True, elem=DT.INT32),
                     S.Field("m", DT.MAP, True, elem=DT.FLOAT64,
                             key=DT.INT64),
                     S.Field("s", DT.STRUCT, True, children=(
                         S.Field("x", DT.INT32), S.Field("y", DT.STRING)))))


@pytest.mark.parametrize("i", range(22))
def test_expression_round_trip_and_bytes(i):
    got = _exprs(tir, tschema.DataType)[i]
    want = _exprs(rir, rschema.DataType)[i]
    data = tserde.expr_to_proto(got).SerializeToString()
    assert data == rserde.expr_to_proto(want).SerializeToString()
    assert tserde.parse_expr(tpb.ExprNode.FromString(data)) == got
    assert repr(rserde.parse_expr(rpb.ExprNode.FromString(data))) == \
        repr(want)


def test_aggregates_and_sort_orders_round_trip():
    for got, want in zip(_aggs(tir), _aggs(rir)):
        data = tserde.agg_to_proto(got).SerializeToString()
        assert data == rserde.agg_to_proto(want).SerializeToString()
        assert tserde.parse_agg(tpb.AggFunctionP.FromString(data)) == got
    for asc, nf in ((True, True), (False, False), (True, False)):
        o = tir.SortOrder(tir.ColumnRef(2, "k"), asc, nf)
        data = tserde.sort_order_to_proto(o).SerializeToString()
        assert data == rserde.sort_order_to_proto(rir.SortOrder(
            rir.ColumnRef(2, "k"), asc, nf)).SerializeToString()
        assert tserde.parse_sort_order(tpb.SortOrderP.FromString(data)) == o


def test_schema_round_trip():
    got, want = _schema(tschema), _schema(rschema)
    data = tserde.schema_to_proto(got).SerializeToString()
    assert data == rserde.schema_to_proto(want).SerializeToString()
    assert tserde.parse_schema(tpb.SchemaP.FromString(data)) == got


def test_unported_expressions_raise_naming_the_node():
    row_num = tpb.ExprNode(nullary=tpb.NullaryE(kind="row_num"))
    with pytest.raises(NotImplementedError, match="nullary.*item 17b"):
        tserde.parse_expr(row_num)
    gsf = tpb.ExprNode(get_struct_field=tpb.GetStructFieldE(
        child=tserde.expr_to_proto(tir.ColumnRef(0)), ordinal=1))
    assert tserde.parse_expr(gsf) == tir.GetStructField(tir.ColumnRef(0), 1)
    with pytest.raises(NotImplementedError, match="SortOrder"):
        tserde.expr_to_proto(tir.SortOrder(tir.ColumnRef(0)))


def test_port_messages_are_its_own():
    assert tpb.PlanNode is not rpb.PlanNode
    assert tpb.DESCRIPTOR.package == "auron_tpu_torch.ir"
    assert [m for m in tpb.DESCRIPTOR.message_types_by_name] == \
        [m for m in rpb.DESCRIPTOR.message_types_by_name]


def _pruned(session, tables, dsl):
    """Two of the file's columns, in another order, over 2 partitions."""
    return (session.read_parquet(tables["store_sales"],
                                 columns=["ss_quantity", "ss_store_sk"],
                                 partitions=2)
            .filter(dsl.col("ss_quantity") > 3)
            .group_by("ss_store_sk")
            .agg(dsl.functions.max(dsl.col("ss_quantity")).alias("top")))


def _full_sort(session, tables, dsl):
    """q02 without its limit, in either package's DSL: the full sort
    through a range exchange."""
    return (session.read_parquet(tables["store_sales"], partitions=4)
            .group_by("ss_customer_sk")
            .agg(dsl.functions.sum(dsl.col("ss_net_paid")).alias("revenue"))
            .sort(dsl.col("revenue").desc(), dsl.col("ss_customer_sk").asc()))


def _keyless(session, tables, dsl):
    """A global aggregate over 4 partitions: partial → single exchange →
    final."""
    return (session.read_parquet(tables["store_sales"], partitions=4)
            .group_by()
            .agg(dsl.functions.sum(dsl.col("ss_quantity")).alias("q")))


@pytest.fixture(scope="module")
def task_bytes(tmp_path_factory):
    """Each query's task bytes from both packages' DataFrames."""
    root = str(tmp_path_factory.mktemp("tpcds"))
    tables = rdata.generate(root, 0.05, 42)
    table = pa.concat_tables(pq.read_table(f) for f in tables["store_sales"])
    rs, ts = RSession(), TSession(device="cpu")
    F = rdf.functions
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        ref = {"q01": rqueries.q01_dataframe(rs, tables),
               "q02": rqueries._q02_run(rs, tables),
               "q10": rqueries._q10_run(rs, tables),
               "q11": rqueries._q11_run(rs, tables),
               "q12": rqueries._q12_run(rs, tables),
               "q13": rqueries._q13_run(rs, tables),
               "q02_full_sort": _full_sort(rs, tables, rdf),
               "keyless": _keyless(rs, tables, rdf),
               "store_quantity": rs.from_arrow(table)
               .group_by("ss_store_sk")
               .agg(F.count_star().alias("n"),
                    F.sum(rdf.col("ss_quantity")).alias("qty")),
               "pruned": _pruned(rs, tables, rdf)}
    ref.update(join_cases.reference_dataframes(rs, tables))
    ref.update(string_cases.reference_dataframes(rs, tables))
    ref.update(decimal_cases.reference_dataframes(rs, tables))
    port = {"q01": tqueries.q01_dataframe(ts, tables),
            "q02": tqueries.q02_dataframe(ts, tables),
            "q10": tqueries.q10_dataframe(ts, tables),
            "q11": tqueries.q11_dataframe(ts, tables),
            "q12": tqueries.q12_dataframe(ts, tables),
            "q13": tqueries.q13_dataframe(ts, tables),
            "q02_full_sort": tqueries.q02_dataframe(ts, tables, limit=None),
            "keyless": _keyless(ts, tables, tdf),
            "store_quantity": tqueries.store_quantity_dataframe(ts, table),
            "pruned": _pruned(ts, tables, tdf)}
    port.update(join_cases.port_dataframes(ts, tables))
    port.update(string_cases.port_dataframes(ts, tables))
    port.update(decimal_cases.port_dataframes(ts, tables))
    return {n: (port[n].task_bytes(), ref[n].task_bytes(),
                port[n], ref[n]) for n in NAMES}


@pytest.mark.parametrize("name", NAMES)
def test_task_bytes_equal_reference(name, task_bytes):
    got, want, port_df, ref_df = task_bytes[name]
    assert got == want
    assert port_df.num_partitions == ref_df.num_partitions
    assert [(f.name, f.dtype.value, f.nullable) for f in port_df.schema] \
        == [(f.name, f.dtype.value, f.nullable) for f in ref_df.schema]
    for pid in (1, 3):
        assert port_df.task_bytes(pid) == ref_df.task_bytes(pid)


@pytest.mark.parametrize("name", NAMES)
def test_bytes_parse_across_packages(name, task_bytes):
    got, want, _t, _r = task_bytes[name]
    t = tpb.TaskDefinition.FromString(want)
    r = rpb.TaskDefinition.FromString(got)
    assert t.SerializeToString() == want and r.SerializeToString() == got
    assert t.num_partitions == r.num_partitions
    assert t.plan.WhichOneof("node") == r.plan.WhichOneof("node")


def test_distinct_aggregates_raise():
    """DISTINCT aggregates once raised; now their plans, over one
    partition and over two, serialize to the reference's bytes."""
    table = pa.table({"k": pa.array(np.arange(4)), "v": pa.array([1] * 4)})

    def plan(dsl, session, parts):
        df = session.from_arrow(table, name="t")
        if parts > 1:
            df = df.repartition(parts)
        F, col = dsl.functions, dsl.col
        return df.group_by("k").agg(
            F.count(col("v"), distinct=True), F.sum(col("v"), distinct=True),
            F.collect_set(col("v")), F.collect_list(col("k"))).plan

    for parts in (1, 2):
        assert plan(tdf, TSession(device="cpu"), parts).SerializeToString() \
            == plan(rdf, RSession(), parts).SerializeToString()


def _provenance_chain(session, tables, dsl) -> dict:
    """{step: DataFrame} through every transform that carries, sets or
    drops the partitioning provenance, in either package's DSL."""
    col, F = dsl.col, dsl.functions
    sales = session.read_parquet(tables["store_sales"], partitions=4)
    by_item = sales.repartition(4, "ss_item_sk")
    renamed = by_item.select(col("ss_item_sk").alias("item"),
                             col("ss_quantity"))
    one = session.read_parquet(tables["item"], columns=["i_item_sk"])
    out = {
        "scan": sales,
        "hash_repartition": by_item,
        "round_robin": sales.repartition(3),
        "round_robin_to_one": sales.repartition(1),
        "filter": by_item.filter(col("ss_quantity") > 3),
        "select_renaming_the_key": renamed,
        "select_dropping_the_key": by_item.select(col("ss_quantity")),
        "select_computing_the_key": by_item.select(
            (col("ss_item_sk") + 1).alias("ss_item_sk")),
        "with_column": by_item.with_column("q2", col("ss_quantity") * 2),
        "keyed_agg": sales.group_by("ss_store_sk").agg(
            F.count_star().alias("n")),
        "keyless_agg": sales.group_by().agg(F.count_star().alias("n")),
        "one_partition_agg": one.group_by("i_item_sk").agg(
            F.count_star().alias("n")),
        "agg_over_hash": renamed.group_by("item").agg(
            F.sum(col("ss_quantity")).alias("q")),
        "top_k": by_item.sort(col("ss_quantity").desc(), limit=5),
        "full_sort": by_item.sort(col("ss_quantity").asc()),
        "one_partition_sort": one.repartition(1, "i_item_sk").sort(
            col("i_item_sk").asc()),
        "limit": by_item.limit(7),
        "one_partition_limit": one.repartition(1, "i_item_sk").limit(7),
        "union": by_item.union(by_item),
        "semi_join": by_item.join(by_item, on="ss_item_sk", how="semi"),
        "existence_join": by_item.join(by_item.select(col("ss_item_sk")),
                                       on="ss_item_sk", how="existence"),
        "inner_join": by_item.join(
            by_item.select(col("ss_item_sk"),
                           col("ss_store_sk").alias("store")),
            on="ss_item_sk"),
    }
    return out


def test_partitioning_provenance_equals_reference(tmp_path):
    tables = rdata.generate(str(tmp_path), 0.02, 42)
    ref = _provenance_chain(RSession(), tables, rdf)
    port = _provenance_chain(TSession(device="cpu"), tables, tdf)
    seen = set()
    for step, want in ref.items():
        got = port[step]
        assert got.partitioning == want.partitioning, step
        assert got.num_partitions == want.num_partitions, step
        assert got.task_bytes() == want.task_bytes(), step
        seen.add(want.partitioning)
    # every kind of provenance occurs
    assert {p[0] if p else None for p in seen} == {None, "hash", "single"}
    assert port["select_renaming_the_key"].partitioning == \
        ("hash", ("item",), 4)
    # co-partitioned sides need no broadcast; q05 without its
    # repartitions does
    assert "broadcast_exchange" not in str(port["inner_join"].plan)
    assert "broadcast_exchange" in str(tqueries.q05_dataframe(
        TSession(device="cpu"), tables, co_partitioned=False).plan)
