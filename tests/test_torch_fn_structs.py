"""Struct columns of the port against the JAX package's, on the CPU.

The cases of ``tests/test_map_struct.py``'s struct tests, at a small
size, over a batch whose struct key ``named_struct(a, b)`` has null
fields (and whose other struct column has null rows):

- ``named_struct``, ``struct`` and ``get_struct_field`` (by name and by
  ordinal) and the ``GetStructField`` node: the reference's columns;
- murmur3 and xxhash64 of a struct: the reference's hashes (a null
  field skipped, a null struct the running hash);
- the struct as a group key (complete, and partial → exchange →
  final), a sort key (ascending and descending), a window partition key
  and a join key: the reference's rows, in its order;
- through the Session, ``it/nested.py``'s struct queries (group, sort,
  window) agree with their pandas oracles.
"""

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops import hashing as rhashing
from auron_tpu.ops.agg import AggOp as RAgg
from auron_tpu.ops.joins import HashJoinOp as RJoin
from auron_tpu.ops.project import ProjectOp as RProject
from auron_tpu.ops.sort import SortOp as RSort
from auron_tpu.ops.window import WindowFunctionSpec as RWin
from auron_tpu.ops.window import WindowOp as RWindow
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu.parallel.partitioning import HashPartitioning as RHash
from auron_tpu.runtime.executor import collect as rcollect
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend.session import Session
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.it import nested, tpcds_data
from auron_tpu_torch.ops import hashing as thashing
from auron_tpu_torch.ops.agg import AggOp as TAgg
from auron_tpu_torch.ops.joins import HashJoinOp as TJoin
from auron_tpu_torch.ops.project import ProjectOp as TProject
from auron_tpu_torch.ops.sort import SortOp as TSort
from auron_tpu_torch.ops.window import WindowFunctionSpec as TWin
from auron_tpu_torch.ops.window import WindowOp as TWindow
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle
from auron_tpu_torch.parallel.partitioning import HashPartitioning as THash
from auron_tpu_torch.runtime.executor import collect as tcollect

ROWS = 48


def _rb(seed=2):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 3, ROWS)
    b = rng.integers(0, 2, ROWS).astype(np.float64)
    return pa.record_batch({
        "a": pa.array(a, pa.int64(), mask=rng.random(ROWS) < 0.2),
        "b": pa.array(b, pa.float64(), mask=rng.random(ROWS) < 0.2),
        "v": pa.array(rng.integers(0, 100, ROWS), pa.int64()),
        "s": pa.array([{"x": int(i % 4), "y": f"s{i % 3}"}
                       if i % 5 else None for i in range(ROWS)],
                      pa.struct([("x", pa.int64()), ("y", pa.string())])),
    })


class _Pkg:
    def __init__(self, port: bool):
        self.port = port
        self.ir = tir if port else rir

    def scan(self, rbs=None, parts=1):
        rbs = rbs or [_rb()]
        per = [rbs[i::parts] for i in range(parts)]
        if self.port:
            return TMem(per, tbridge.schema_from_arrow(rbs[0].schema),
                        capacity=64, device="cpu")
        return RMem(per, rbridge.schema_from_arrow(rbs[0].schema),
                    capacity=64)

    def keyed(self, parts=1):
        """(sd = named_struct('a', a, 'b', b), v, s)."""
        ir = self.ir
        fn = ir.ScalarFunction("named_struct", (
            ir.Literal("a", _dt(self, "STRING")), ir.ColumnRef(0),
            ir.Literal("b", _dt(self, "STRING")), ir.ColumnRef(1)))
        P = TProject if self.port else RProject
        return P(self.scan(parts=parts), [fn, ir.ColumnRef(2),
                                          ir.ColumnRef(3)],
                 ["sd", "v", "s"])

    def collect(self, op, parts=1):
        return (tcollect if self.port else rcollect)(op, parts)


def _dt(pkg, name):
    from auron_tpu.columnar.schema import DataType as RDT
    from auron_tpu_torch.columnar.schema import DataType as TDT
    return getattr(TDT if pkg.port else RDT, name)


PORT, REF = _Pkg(True), _Pkg(False)


def _both(build, parts=1):
    got = PORT.collect(build(PORT), parts)
    want = REF.collect(build(REF), parts)
    assert got.schema == want.schema
    return got.to_pylist(), want.to_pylist()


def test_struct_functions_match_reference():
    def build(p):
        ir = p.ir
        L = ir.Literal
        S = _dt(p, "STRING")
        sd = ir.ScalarFunction("named_struct", (
            L("a", S), ir.ColumnRef(0), L("b", S), ir.ColumnRef(1)))
        exprs = [sd,
                 ir.ScalarFunction("struct", (ir.ColumnRef(0),
                                              ir.ColumnRef(2))),
                 ir.ScalarFunction("get_struct_field", (ir.ColumnRef(3),
                                                        L("y", S))),
                 ir.ScalarFunction("get_struct_field", (
                     ir.ColumnRef(3), L(0, _dt(p, "INT64")))),
                 ir.GetStructField(ir.ColumnRef(3), 1),
                 ir.GetStructField(sd, 0)]
        P = TProject if p.port else RProject
        return P(p.scan(), exprs, [f"e{i}" for i in range(len(exprs))])
    got, want = _both(build)
    assert got == want


def test_struct_hashes_match_reference():
    rb = _rb()
    tb, _ = tbridge.to_device(rb, capacity=64, device="cpu")
    rbd, _ = rbridge.to_device(rb, capacity=64)
    np.testing.assert_array_equal(
        thashing.murmur3_columns(list(tb.columns[3:]) + [tb.columns[0]],
                                 64).numpy(),
        np.asarray(rhashing.murmur3_columns(
            list(rbd.columns[3:]) + [rbd.columns[0]], 64)))
    np.testing.assert_array_equal(
        thashing.xxhash64_columns(list(tb.columns[3:]), 64).numpy(),
        np.asarray(rhashing.xxhash64_columns(list(rbd.columns[3:]), 64)))


@pytest.mark.parametrize("mode", ["complete", "two_phase"])
def test_group_by_struct_key_matches_reference(mode):
    def build(p):
        ir = p.ir
        aggs = [ir.AggFunction("sum", ir.ColumnRef(1)),
                ir.AggFunction("count_star")]
        Agg = TAgg if p.port else RAgg
        kw = dict(group_names=["sd"], agg_names=["sv", "n"])
        if mode == "complete":
            return Agg(p.keyed(), [ir.ColumnRef(0)], aggs, "complete", **kw)
        part = Agg(p.keyed(2), [ir.ColumnRef(0)], aggs, "partial", **kw)
        ex = (TShuffle if p.port else RShuffle)(
            part, (THash if p.port else RHash)((ir.ColumnRef(0),), 2),
            input_partitions=2)
        return Agg(ex, [ir.ColumnRef(0)], [ir.AggFunction("sum"),
                                           ir.AggFunction("count_star")],
                   "final", **kw)
    got, want = _both(build, 1 if mode == "complete" else 2)
    assert got == want
    # a null field is a group of its own, apart from a null struct
    assert len(got) == len({(r["sd"]["a"], r["sd"]["b"]) for r in got})


@pytest.mark.parametrize("asc", [True, False])
def test_sort_by_struct_key_matches_reference(asc):
    def build(p):
        ir = p.ir
        S = TSort if p.port else RSort
        return S(p.keyed(), [ir.SortOrder(ir.ColumnRef(0), asc, asc),
                             ir.SortOrder(ir.ColumnRef(1))])
    got, want = _both(build)
    assert got == want


def test_window_partitioned_by_struct_matches_reference():
    def build(p):
        ir = p.ir
        W, Spec = (TWindow, TWin) if p.port else (RWindow, RWin)
        return W(p.keyed(), [ir.ColumnRef(0)],
                 [ir.SortOrder(ir.ColumnRef(1), False)],
                 [Spec("rank_like", "rank"), Spec("agg", "sum",
                                                  ir.ColumnRef(1))],
                 ["r", "sum_v"])
    got, want = _both(build)
    assert got == want


def test_join_on_struct_key_matches_reference():
    def build(p):
        ir = p.ir
        J = TJoin if p.port else RJoin
        return J(p.keyed(), p.keyed(), [ir.ColumnRef(0)], [ir.ColumnRef(0)],
                 join_type="inner")
    got, want = _both(build)
    assert sorted(map(str, got)) == sorted(map(str, want))
    assert got


@pytest.fixture(scope="module")
def sales(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sales"))
    files = tpcds_data.generate(root, 0.05)["store_sales"]
    ss = pa.concat_tables([pq.read_table(f) for f in files]).to_pandas()
    return {"store_sales": files}, ss


@pytest.mark.parametrize("name", ["group", "sort", "window"])
def test_struct_queries_match_their_oracles(sales, name):
    t, ss = sales
    df = nested.struct_key_dataframes(Session(device="cpu"), t)[name]
    assert nested.check_struct_keys(name, df.collect(), ss) == []
