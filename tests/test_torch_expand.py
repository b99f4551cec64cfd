"""The port's expand operator and grouping sets against the JAX
package's, on the CPU.

- ``ExpandOp`` over seeded batches (int64, float64, string and decimal
  columns, null literals of each type): the same batches, in the same
  order (one per projection per input batch), as the reference's;
  fused into a stage with a projection, the same rows as unfused.
- ``DataFrame.expand``, ``grouping_sets``, ``rollup`` and ``cube``:
  task bytes identical to the reference DataFrame's, over one partition
  and four; the planned trees identical to the reference planner's,
  the fusion pass's fan-out bound of 16 included (a cube over 5 keys,
  32 projections, stays unfused; a rollup over 3 keys, 4 projections,
  fuses; two expands whose product passes 16 split).
- Rows: a rollup, a cube and grouping sets over string keys whose
  batches differ in width (8 and 32 bytes) and an int key with nulls,
  through both Sessions: the reference's rows and Arrow types, and a
  pandas oracle's, ``spark_grouping_id`` telling a rolled-up null from a
  natural one.

Every comparison is exact but the float sums', which fall within 1e-12
of their group's Σ|v|.
"""

import numpy as np
import pandas as pd
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.ops.expand import ExpandOp as RExpand
from auron_tpu.runtime.executor import collect as rcollect
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ir import planner as tplanner
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.ops.expand import ExpandOp as TExpand
from auron_tpu_torch.ops.fused import FusedStageOp
from auron_tpu_torch.ops.project import ProjectOp
from auron_tpu_torch.runtime.executor import collect
from tests.test_torch_planner import _same_tree

F64_SUM_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

def _batches(seed: int = 1, n: int = 40) -> list:
    """Two batches: ``k`` int64 with nulls, ``s`` strings (8 bytes wide
    in the first batch, 32 in the second), ``v`` float64, ``d``
    decimal(9,2)."""
    import decimal
    rng = np.random.default_rng(seed)
    out = []
    for words in (["a", "bb", "", "ccc"],
                  ["a", "bb", "a-string-of-twenty-b", "ccc"]):
        out.append(pa.record_batch({
            "k": pa.array([None if rng.random() < 0.15 else int(x)
                           for x in rng.integers(0, 4, n)], pa.int64()),
            "s": pa.array([None if rng.random() < 0.1 else words[int(i)]
                           for i in rng.integers(0, 4, n)], pa.string()),
            "v": pa.array(rng.normal(size=n) * 10, pa.float64()),
            "d": pa.array([decimal.Decimal(int(x)).scaleb(-2)
                           for x in rng.integers(-10 ** 6, 10 ** 6, n)],
                          pa.decimal128(9, 2)),
        }))
    return out


def _projections(ir, DT):
    c = ir.ColumnRef
    return [
        [c(0), c(1), c(2), c(3), ir.Literal(0, DT.INT32)],
        [c(0), ir.Literal(None, DT.STRING), c(2), c(3),
         ir.Literal(1, DT.INT32)],
        [ir.Literal(None, DT.INT64), c(1), c(2),
         ir.Literal(None, DT.DECIMAL, 9, 2), ir.Literal(2, DT.INT32)],
        [ir.Literal(None, DT.INT64), ir.Literal(None, DT.STRING),
         ir.BinaryExpr("*", c(2), ir.Literal(2.0, DT.FLOAT64)),
         ir.Literal(None, DT.DECIMAL, 9, 2), ir.Literal(3, DT.INT32)],
    ]


_NAMES = ["k", "s", "v", "d", "gid"]


def _port_expand(batches):
    scan = TMem([batches], tbridge.schema_from_arrow(batches[0].schema),
                capacity=64, device="cpu")
    return TExpand(scan, _projections(tir, TDT), _NAMES)


def test_expand_op_matches_reference():
    batches = _batches()
    rscan = RMem([batches], rbridge.schema_from_arrow(batches[0].schema),
                 capacity=64)
    want = rcollect(RExpand(rscan, _projections(rir, RDT), _NAMES))
    op = _port_expand(batches)
    assert op.fusion_fanout == 4 and op.fusable and op.fragment_computes
    assert [(f.name, f.dtype.value, f.precision, f.scale)
            for f in op.schema()] == [("k", "int64", 0, 0),
                                      ("s", "string", 0, 0),
                                      ("v", "float64", 0, 0),
                                      ("d", "decimal", 9, 2),
                                      ("gid", "int32", 0, 0)]
    got = collect(op)
    assert got.num_rows == want.num_rows == 4 * 80
    assert got.equals(want)


def test_expand_fragment_matches_operator():
    """ExpandOp fused into a stage with a projection emits the same
    batches as the operators run one by one."""
    batches = _batches(2)
    expand = _port_expand(batches)
    proj = ProjectOp(expand, [tir.ColumnRef(i) for i in (4, 0, 1, 2)],
                     ["gid", "k", "s", "v"])
    plain = collect(proj)
    fused = collect(FusedStageOp([expand, proj]))
    assert fused.equals(plain)
    assert plain.num_rows == 4 * 80


def test_expand_metrics_count_every_projection():
    batches = _batches(3)
    metrics = {}
    collect(_port_expand(batches), metrics=metrics)
    snap = metrics["expand"].snapshot()
    assert (snap["output_batches"], snap["output_rows"]) == (8, 320)


# ---------------------------------------------------------------------------
# the DSL: task bytes and trees
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """One parquet file per partition: int keys a..e, a string key s and
    a float value."""
    root = tmp_path_factory.mktemp("expand")
    rng = np.random.default_rng(4)
    out = []
    for i in range(4):
        n = 50
        t = pa.table({**{c: pa.array(rng.integers(0, 3, n), pa.int64())
                         for c in "abcde"},
                      "s": pa.array([["x", "yy", None][int(j)]
                                     for j in rng.integers(0, 3, n)],
                                    pa.string()),
                      "v": pa.array(rng.normal(size=n), pa.float64())})
        path = str(root / f"part_{i}.parquet")
        pq.write_table(t, path)
        out.append(path)
    return out


def _grouping_frames(dsl, s, files):
    col, F = dsl.col, dsl.functions
    four = s.read_parquet(files, partitions=4)
    one = s.read_parquet(files[:1])
    total = F.sum(col("v")).alias("total")
    n = F.count_star().alias("n")
    null = dsl.lit(None, dsl.DT.FLOAT64)
    proj = [[col("a"), col("v")], [col("b"), null], [col("c"), col("v")],
            [col("d"), null]]
    return {
        "rollup3": four.rollup("a", "b", "c").agg(total, n),
        "rollup3_one": one.filter(col("v") > 0).rollup("a", col("s"), "c")
        .agg(total),
        "cube3_filter": four.filter(col("v") > 0).cube("a", "s", "c")
        .agg(n),
        "cube5": four.cube("a", "b", "c", "d", "e").agg(total),
        "cube5_one": one.filter(col("v") > 0).cube("a", "b", "c", "d", "e")
        .agg(n),
        "sets": four.grouping_sets(["a", col("s"), "b"],
                                   [[0, 1], [2], [], [0, 1, 2]]).agg(total),
        "expand": one.expand(proj, ["x", "w"]),
        "expand_twice": one.expand(proj, ["x", "w"])
        .select(col("x"), col("w"))
        .expand([[col("x"), col("w")]] * 8, ["x2", "w2"]),
        "rollup_window": four.rollup("a", "s").agg(total)
        .window([F.rank().alias("rk")], partition_by=["a"],
                order_by=[col("total").desc()]),
    }


_DSL = {"ref": dict(col=rdf.col, lit=rdf.lit, functions=rdf.functions,
                    DT=RDT),
        "port": dict(col=tdf.col, lit=tdf.lit, functions=tdf.functions,
                     DT=TDT)}


@pytest.fixture(scope="module")
def frames(files):
    from types import SimpleNamespace
    rs, ts = RSession(), TSession(device="cpu")
    return (rs, ts,
            _grouping_frames(SimpleNamespace(**_DSL["ref"]), rs, files),
            _grouping_frames(SimpleNamespace(**_DSL["port"]), ts, files))


_FRAMES = ["rollup3", "rollup3_one", "cube3_filter", "cube5", "cube5_one",
           "sets", "expand", "expand_twice", "rollup_window"]


@pytest.mark.parametrize("name", _FRAMES)
def test_task_bytes_schema_and_tree_equal_reference(name, frames):
    rs, _ts, ref, port = frames
    data = port[name].task_bytes()
    assert data == ref[name].task_bytes()
    assert (port[name].num_partitions, port[name].partitioning) == \
        (ref[name].num_partitions, ref[name].partitioning)
    assert [(f.name, f.dtype.value, f.nullable, f.precision, f.scale)
            for f in port[name].schema] == \
        [(f.name, f.dtype.value, f.nullable, f.precision, f.scale)
         for f in ref[name].schema]
    _same_tree(plan_from_bytes(data, PlannerContext(device="cpu")),
               rplan_from_bytes(data, rs.ctx))


def _expands(op) -> list:
    """(fan-out, fused?) of every ExpandOp in the tree, top down."""
    out = []
    if isinstance(op, FusedStageOp):
        out += [(m.fusion_fanout, True) for m in reversed(op.members)
                if isinstance(m, TExpand)]
    elif isinstance(op, TExpand):
        out.append((op.fusion_fanout, False))
    for c in op.children:
        out += _expands(c)
    return out


def test_fusion_bounds_the_fanout_at_16(frames):
    """A cube over 5 keys (32 projections) does not fuse with the filter
    below it; a rollup over 3 keys (4) and a cube over 3 (8) do; of two
    expands (8 over a projection over 4) the product 32 passes the
    bound, so the stage stops above the lower one."""
    _rs, ts, _ref, port = frames

    def plan(name):
        return ts.plan_physical(port[name])

    assert tplanner._MAX_STAGE_FANOUT == 16
    assert _expands(plan("cube5_one")) == [(32, False)]
    assert _expands(plan("rollup3_one")) == [(4, True)]
    assert _expands(plan("cube3_filter")) == [(8, True)]
    twice = plan("expand_twice")
    assert _expands(twice) == [(8, True), (4, False)]
    (stage,) = [op for op in _walk(twice) if isinstance(op, FusedStageOp)]
    assert [type(m).__name__ for m in stage.members] == ["ProjectOp",
                                                         "ExpandOp"]


def _walk(op):
    yield op
    for c in op.children:
        yield from _walk(c)


# ---------------------------------------------------------------------------
# rows through both Sessions
# ---------------------------------------------------------------------------

def _string_table():
    """A memory table of two batches whose string keys are 8 and 32
    bytes wide on the device."""
    return pa.Table.from_batches([b.select(["k", "s", "v"])
                                  for b in _batches(5, 60)])


def _row_frames(dsl, s):
    col, F = dsl.col, dsl.functions
    s.register("t", _string_table())
    t = s.table("t")
    aggs = (F.sum(col("v")).alias("total"), F.count_star().alias("n"))
    return {"rollup": t.rollup("s", "k").agg(*aggs),
            "cube": t.cube("k", "s").agg(*aggs),
            "sets": t.grouping_sets(["s", "k"], [[1], [0], []]).agg(*aggs)}


@pytest.fixture(scope="module")
def rows():
    from types import SimpleNamespace
    rs, ts = RSession(), TSession(device="cpu")
    ref = _row_frames(SimpleNamespace(**_DSL["ref"]), rs)
    port = _row_frames(SimpleNamespace(**_DSL["port"]), ts)
    out = {}
    for name in ref:
        assert port[name].task_bytes() == ref[name].task_bytes()
        out[name] = (ref[name].collect(), port[name].collect())
    return out


def _key(r):
    return tuple((v is None, v if v is not None else 0)
                 for k, v in r.items() if k not in ("total",))


def _oracle(name) -> list:
    df = _string_table().to_pandas()
    sets = {"rollup": [("s", "k"), ("s",), ()],
            "cube": [("k", "s"), ("k",), ("s",), ()],
            "sets": [("k",), ("s",), ()]}[name]
    keys = {"rollup": ["s", "k"], "cube": ["k", "s"], "sets": ["s", "k"]}[name]
    out = []
    for st in sets:
        gid = sum(1 << (len(keys) - 1 - i) for i, k in enumerate(keys)
                  if k not in st)
        if st:
            g = df.groupby(list(st), dropna=False)
            for kv, part in g:
                kv = kv if isinstance(kv, tuple) else (kv,)
                vals = dict(zip(st, kv))
                row = {k: (None if pd.isna(vals.get(k)) else vals.get(k))
                       for k in keys}
                out.append({**row, "spark_grouping_id": gid,
                            "total": part.v.sum(), "n": len(part),
                            "_abs": part.v.abs().sum()})
        else:
            out.append({**{k: None for k in keys}, "spark_grouping_id": gid,
                        "total": df.v.sum(), "n": len(df),
                        "_abs": df.v.abs().sum()})
    for r in out:
        if r.get("k") is not None:
            r["k"] = int(r["k"])
    return out


@pytest.mark.parametrize("name", ["rollup", "cube", "sets"])
def test_grouping_rows_equal_reference_and_oracle(name, rows):
    want, got = rows[name]
    assert got.schema.equals(want.schema)
    assert got.schema.field("spark_grouping_id").type == pa.int32()
    g = sorted(got.to_pylist(), key=_key)
    w = sorted(want.to_pylist(), key=_key)
    o = sorted(_oracle(name), key=_key)
    assert len(g) == len(w) == len(o)
    for gr, wr, orow in zip(g, w, o):
        scale = F64_SUM_TOL * orow.pop("_abs")
        for other in (wr, orow):
            assert {k: v for k, v in gr.items() if k != "total"} == \
                {k: v for k, v in other.items() if k != "total"}
            assert abs(gr["total"] - other["total"]) <= scale
    # a natural null key and a rolled-up one stay apart
    nulls = [r for r in g if r["s"] is None]
    assert {r["spark_grouping_id"] for r in nulls} >= {0, 3} or name == "sets"
