"""The port's physical planner against the JAX package's, on the CPU.

``plan_from_bytes`` of the reference DataFrame's task bytes gives, in
the port, the reference planner's operator tree node by node (operator,
repr, mode, keys, aggregates, sort orders and fetch, partitioning,
``key_domain``, scan fields, fused members), with
``auron.fusion.enabled`` on and off, for q01, q02, q10, q11, q12, q13,
q02's full sort (a range exchange), a keyless aggregate, the in-memory
query, a filtered global limit, a scan of two columns, a rename over a
coalesce over a limit, and the join queries of ``torch_join_cases``
(hash joins over hash exchanges and over broadcast exchanges, a
filtered probe side wrapped in a stage of its own) and the string
queries of ``torch_string_cases`` (q03, q04 and q06 to q09) and the
decimal queries of ``torch_decimal_cases`` (q15, whose top-k sorts on a
wide decimal, and the money queries, whose partial aggs the reference
would fold a combine into: their lone projection is wrapped in a stage
of its own). The dense key
domain the planner derives over an in-memory table equals the
reference's, and is None on a float sum. Nodes the port has no
operator for raise ``NotImplementedError`` naming them.
"""

from unittest import mock

import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.ir import auron_pb2 as rpb
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import queries as rqueries
from auron_tpu.it import tpcds_data as rdata
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.ir import auron_pb2 as tpb
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.runtime.executor import collect
from tests import torch_join_cases as join_cases
from tests import torch_decimal_cases as decimal_cases
from tests import torch_string_cases as string_cases

NAMES = ("q01", "q02", "q10", "q11", "q12", "q13", "q02_full_sort",
         "keyless", "store_quantity", "float_sum", "limit", "rename",
         "pruned") + join_cases.NAMES + string_cases.NAMES \
    + decimal_cases.NAMES

#: per operator: the fields it runs on, compared by repr
FIELDS = {
    "AggOp": ("mode", "group_exprs", "aggs", "group_names", "agg_names",
              "initial_capacity", "key_domain"),
    "ShuffleExchangeOp": ("partitioning", "input_partitions",
                          "num_partitions"),
    "FilterOp": ("predicates",),
    "ProjectOp": ("exprs", "names"),
    "ParquetScanOp": ("files", "batch_rows", "columns"),
    "MemoryScanOp": ("capacity",),
    "SortOp": ("sort_exprs", "fetch"),
    "LimitOp": ("limit",),
    "CoalesceBatchesOp": ("target_rows",),
    "RenameColumnsOp": ("names",),
    "UnionOp": (),
    "FusedStageOp": (),
    "HashJoinOp": ("join_type", "probe_keys", "build_keys"),
    "BroadcastExchangeOp": ("input_partitions",),
    "WindowOp": ("partition_by", "order_by", "functions", "output_names",
                 "group_limit"),
    "ExpandOp": ("projections", "names", "fusion_fanout"),
}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The queries run many small torch ops. Where test workers share
    the CPU, torch's intra-op threads oversubscribe it (four workers ran
    this module's port queries ~30x slower than one), so the module runs
    on one thread."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _rename_plan(pb, table_name: str):
    """rename ← coalesce ← limit ← memory scan, in either package's
    messages."""
    scan = pb.PlanNode(memory_scan=pb.MemoryScanNode(table_name=table_name))
    lim = pb.PlanNode(limit=pb.LimitNode(child=scan, limit=1000))
    co = pb.PlanNode(coalesce_batches=pb.CoalesceBatchesNode(
        child=lim, target_rows=4096))
    return pb.PlanNode(rename_columns=pb.RenameColumnsNode(
        child=co, names=[f"c{i}" for i in range(8)]))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("tpcds"))
    tables = rdata.generate(root, 0.2, 42)
    table = pa.concat_tables(pq.read_table(f) for f in tables["store_sales"])
    return tables, table


def _ref_dataframes(session, tables, table) -> dict:
    F, col = rdf.functions, rdf.col
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        out = {"q01": rqueries.q01_dataframe(session, tables),
               "q02": rqueries._q02_run(session, tables),
               "q10": rqueries._q10_run(session, tables),
               "q11": rqueries._q11_run(session, tables),
               "q12": rqueries._q12_run(session, tables),
               "q13": rqueries._q13_run(session, tables)}
    sales = session.read_parquet(tables["store_sales"], partitions=4)
    out["q02_full_sort"] = sales.group_by("ss_customer_sk").agg(
        F.sum(col("ss_net_paid")).alias("revenue")).sort(
        col("revenue").desc(), col("ss_customer_sk").asc())
    out["keyless"] = sales.group_by().agg(
        F.sum(col("ss_quantity")).alias("q"))
    mem = session.from_arrow(table, name="store_sales")
    out["store_quantity"] = mem.group_by("ss_store_sk").agg(
        F.count_star().alias("n"), F.sum(col("ss_quantity")).alias("qty"))
    out["float_sum"] = mem.group_by("ss_store_sk").agg(
        F.sum(col("ss_sales_price")).alias("total"))
    out["limit"] = session.read_parquet(
        tables["store_sales"], partitions=4).filter(
        col("ss_quantity") > 15).limit(25)
    out["pruned"] = session.read_parquet(
        tables["store_sales"], columns=["ss_quantity", "ss_store_sk"],
        partitions=2).group_by("ss_store_sk").agg(
        F.max(col("ss_quantity")).alias("top"))
    out.update(join_cases.reference_dataframes(session, tables))
    out.update(string_cases.reference_dataframes(session, tables))
    out.update(decimal_cases.reference_dataframes(session, tables))
    return out


def _task_bytes(df_or_plan) -> bytes:
    if isinstance(df_or_plan, rpb.PlanNode):
        return rpb.TaskDefinition(plan=df_or_plan).SerializeToString()
    return df_or_plan.task_bytes()


@pytest.fixture(scope="module", params=[True, False],
                ids=["fusion_on", "fusion_off"])
def trees(request, data):
    """{name: (reference tree, port tree, task bytes)} with fusion on or
    off in both packages."""
    tables, table = data
    fusion = request.param
    rs = RSession(config=rcfg.AuronConfig({rcfg.FUSION_ENABLED: fusion}))
    dfs = _ref_dataframes(rs, tables, table)
    dfs["rename"] = _rename_plan(rpb, "store_sales")
    tctx = PlannerContext(
        # the in-memory tables the reference session registered
        catalog={**rs.ctx.catalog, "store_sales": table},
        config=tcfg.AuronConfig({tcfg.FUSION_ENABLED: fusion}),
        device="cpu")
    out = {}
    for name, df in dfs.items():
        data_ = _task_bytes(df)
        out[name] = (rplan_from_bytes(data_, rs.ctx),
                     plan_from_bytes(data_, tctx), data_)
    return out


def _same_tree(got, want, path="root"):
    assert type(got).__name__ == type(want).__name__, path
    assert repr(got) == repr(want), path
    for field in FIELDS[type(want).__name__]:
        assert repr(getattr(got, field)) == repr(getattr(want, field)), \
            f"{path}.{field}"
    assert [(f.name, f.dtype.value, f.nullable) for f in got.schema()] == \
        [(f.name, f.dtype.value, f.nullable) for f in want.schema()], path
    if type(want).__name__ == "FusedStageOp":
        assert len(got.members) == len(want.members), path
        for i, (g, w) in enumerate(zip(got.members, want.members)):
            assert repr(g) == repr(w), f"{path}.members[{i}]"
    assert len(got.children) == len(want.children), path
    for i, (g, w) in enumerate(zip(got.children, want.children)):
        _same_tree(g, w, f"{path}/{i}")


@pytest.mark.parametrize("name", NAMES)
def test_plan_from_bytes_equals_reference_tree(name, trees):
    want, got, _data = trees[name]
    _same_tree(got, want)


def test_trees_have_the_expected_shape(trees):
    """The reference planner's shapes the port reproduces (fusion on:
    q11's branches are fused stages; off: plain filter → project)."""
    fused = "FusedStageOp" in trees["q11"][0].tree_string()
    got = {n: trees[n][1].tree_string() for n in NAMES}
    assert got["q13"].count("ShuffleExchangeOp") == 2
    assert got["q11"].count("FusedStageOp[FilterOp") == (2 if fused else 0)
    assert got["q10"].startswith("FilterOp")
    assert got["store_quantity"].startswith("AggOp[complete")
    assert ("FusedStageOp[FilterOp[1 predicates] -> LimitOp[25]]"
            in got["limit"]) == fused
    # top-k: final sort ← single exchange ← map-side sort, a stage
    # breaker the fusion pass does not cross
    for name in ("q02", "q12"):
        lines = got[name].splitlines()
        assert lines[0].strip().startswith("SortOp[2 keys, fetch=")
        assert "ShuffleExchangeOp[SinglePartitioning 4->1]" in lines[1]
        assert lines[2].strip() == lines[0].strip()
    assert ("FusedStageOp[ProjectOp" in got["q12"]) == fused
    full = got["q02_full_sort"].splitlines()
    assert full[0].strip() == "SortOp[2 keys, fetch=None]"
    assert "ShuffleExchangeOp[RangePartitioning 4->4]" in full[1]
    assert "SinglePartitioning 4->1" in got["keyless"]
    # joins: co-partitioned sides hash-exchange both; the others
    # broadcast the build side, and a lone filter on the probe side is
    # a stage of its own
    assert got["q05"].count("ShuffleExchangeOp[HashPartitioning") == 3
    for name in ("q05_broadcast", "q09_semi", "q09_anti",
                 "broadcast_right"):
        assert "BroadcastExchangeOp" in got[name], name
    for name in join_cases.JOIN_TYPES:
        assert f"HashJoinOp[{name}, 1 keys]" in got[name]
        assert "BroadcastExchangeOp" not in got[name]
    probe = got["filtered_probe"].splitlines()
    at = next(i for i, ln in enumerate(probe) if "HashJoinOp" in ln)
    assert probe[at + 1].strip() == ("FusedStageOp[FilterOp[1 predicates]]"
                                     if fused else "FilterOp[1 predicates]")


def test_key_domain_derived_as_the_reference_does(trees, data):
    _tables, table = data
    want, got, _d = trees["store_quantity"]
    assert got.key_domain == want.key_domain \
        == pa.compute.max(table["ss_store_sk"]).as_py() + 1
    want, got, _d = trees["float_sum"]
    assert got.key_domain is None and want.key_domain is None
    # q01's partial AggOp reads parquet: no stats, no bound
    assert trees["q01"][1].child.child.key_domain is None


def test_limit_and_rename_plans_run(trees, data):
    _tables, table = data
    _w, got, _d = trees["limit"]
    out = collect(got, 1)
    assert out.num_rows == 25
    assert (out["ss_quantity"].to_numpy() > 15).all()
    _w, got, _d = trees["rename"]
    out = collect(got, 1)
    assert out.column_names == [f"c{i}" for i in range(8)]
    assert out.rename_columns(table.column_names).equals(table.slice(0, 1000))
    # the pruned scan reads two columns, in the order asked for
    _w, got, _d = trees["pruned"]
    assert got.child.child.child.schema().names == ["ss_quantity",
                                                    "ss_store_sk"]
    out = collect(got, 2).sort_by("ss_store_sk")
    want = table.group_by("ss_store_sk").aggregate(
        [("ss_quantity", "max")]).sort_by("ss_store_sk")
    assert out["top"].equals(want["ss_quantity_max"])


def test_unported_nodes_raise_naming_them(data):
    tables, _table = data
    ctx = PlannerContext(device="cpu")
    scan = tpb.PlanNode(parquet_scan=tpb.ParquetScanNode(
        files=tables["store_sales"]))
    cases = {
        "sort_merge_join": tpb.PlanNode(
            sort_merge_join=tpb.SortMergeJoinNode(probe=scan, build=scan)),
        "broadcast_join": tpb.PlanNode(
            broadcast_join=tpb.BroadcastJoinNode(probe=scan)),
        "output_resource_id": tpb.PlanNode(
            broadcast_exchange=tpb.BroadcastExchangeNode(
                child=scan, output_resource_id="build")),
        "generate": tpb.PlanNode(generate=tpb.GenerateNode(child=scan)),
        "pushdown": tpb.PlanNode(parquet_scan=tpb.ParquetScanNode(
            files=tables["store_sales"], predicates=[tpb.ExprNode(
                column=tpb.ColumnRefE(index=0))])),
    }
    for what, node in cases.items():
        with pytest.raises(NotImplementedError, match=what):
            plan_from_bytes(tpb.TaskDefinition(plan=node)
                            .SerializeToString(), ctx)
