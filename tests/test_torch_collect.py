"""collect_list, collect_set and DISTINCT aggregates of the port against
the JAX package's, on the CPU.

The same seeded pyarrow batches feed an AggOp in each package, complete
over one partition and partial → 2-way hash exchange → final over two
(cases of ``tests/test_collect_bloom_udaf.py``'s collect and DISTINCT
tests, at a small size):

- ``collect_list``/``collect_set`` over int64, float64 (NaN, ``-0.0``
  and ``0.0`` among the values), a narrow decimal and a decimal(25, 2)
  (the ``dcollect`` limb pairs); groups with only nulls (an empty list);
  groups past the first 4 element slots (the growth retry); a global
  group. Lists and sets are identical to the reference's, element order
  and every float's bits included;
- count, sum and avg DISTINCT: counts and integer sums exact, float
  averages within 1e-12 relative; every NaN counts as its own value and
  ``-0.0`` merges with ``0.0``, as in the reference;
- the DSL: DISTINCT sum and avg over a decimal(7, 2) regroup
  (``_rewrite_wide_distinct``) to the reference's bytes and rows, and
  equal Python ``decimal`` sums of the distinct values;
- the growth retries are counted and each is one host readback.
"""

import decimal
import functools
import struct
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops.agg import AggOp as RAgg
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu.parallel.partitioning import HashPartitioning as RHash
from auron_tpu.parallel.partitioning import SinglePartitioning as RSingle
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ops import base as tbase
from auron_tpu_torch.ops.agg import AggOp as TAgg
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle
from auron_tpu_torch.parallel.partitioning import HashPartitioning as THash
from auron_tpu_torch.parallel.partitioning import \
    SinglePartitioning as TSingle

REF = SimpleNamespace(ir=rir, Agg=RAgg, Mem=RMem, Shuffle=RShuffle,
                      Hash=RHash, Single=RSingle, Ctx=RCtx, cfg=rcfg,
                      bridge=rbridge)
PORT = SimpleNamespace(ir=tir, Agg=TAgg,
                       Mem=functools.partial(TMem, device="cpu"),
                       Shuffle=TShuffle, Hash=THash, Single=TSingle,
                       Ctx=TCtx, cfg=tcfg, bridge=tbridge)

ROWS, BATCH, KEYS = 160, 40, 12
#: avg DISTINCT over float64: relative tolerance
F64_REL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=5):
    """Two partitions of record batches: k int64 (a few nulls; key 39
    only ever null values), v int64 with nulls and repeats, w float64
    with NaN, -0.0 and 0.0 among few distinct values, d decimal(7, 2),
    x decimal(25, 2) with values past 2^64."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, KEYS, ROWS)
    kv = rng.random(ROWS) > 0.03
    v = rng.integers(-20, 20, ROWS)
    vv = (rng.random(ROWS) > 0.1) & (k != KEYS - 1)
    pool = np.array([np.nan, -0.0, 0.0, 1.5, -2.25, np.inf, 3.0,
                     float.fromhex("-0x1.8p+1")])
    w = pool[rng.integers(0, len(pool), ROWS)]
    # a NaN with another payload, which still dedupes as a NaN
    w[::57] = struct.unpack("<d", struct.pack("<Q", 0xFFF8000000000123))[0]
    wv = rng.random(ROWS) > 0.1
    d = [decimal.Decimal(int(u)).scaleb(-2)
         for u in rng.integers(-60, 60, ROWS)]
    big = 10 ** 22
    x = [decimal.Decimal(int(u) * big + int(u)).scaleb(-2)
         for u in rng.integers(-30, 30, ROWS)]
    xv = rng.random(ROWS) > 0.1
    rbs = []
    for i in range(0, ROWS, BATCH):
        s = slice(i, i + BATCH)
        rbs.append(pa.record_batch({
            "k": pa.array(k[s], pa.int64(), mask=~kv[s]),
            "v": pa.array(v[s], pa.int64(), mask=~vv[s]),
            "w": pa.array(w[s], pa.float64(), mask=~wv[s]),
            "d": pa.array([dd if ok else None
                           for dd, ok in zip(d[s], vv[s])],
                          pa.decimal128(7, 2)),
            "x": pa.array([xx if ok else None
                           for xx, ok in zip(x[s], xv[s])],
                          pa.decimal128(25, 2))}))
    half = len(rbs) // 2
    return [rbs[:half], rbs[half:]]


@pytest.fixture(scope="module")
def data():
    return _data()


#: (fn, column, distinct) of every aggregate under test
AGGS = [("collect_list", 1, False), ("collect_set", 1, False),
        ("collect_set", 2, False), ("collect_list", 2, False),
        ("collect_set", 3, False), ("collect_list", 4, False),
        ("collect_set", 4, False), ("count", 1, True), ("sum", 1, True),
        ("avg", 1, True), ("count", 2, True), ("avg", 2, True),
        ("count", 3, True), ("count_star", None, False)]


def _plan(ns, parts, mode: str, group: bool):
    C = ns.ir.ColumnRef
    aggs = [ns.ir.AggFunction(fn, C(c) if c is not None else None, dis)
            for fn, c, dis in AGGS]
    names = [f"a{i}" for i in range(len(aggs))]
    groups = [C(0)] if group else []
    kw = dict(group_names=["k"] if group else [], agg_names=names)
    schema = ns.bridge.schema_from_arrow(parts[0][0].schema)
    if mode == "complete":
        scan = ns.Mem([[b for p in parts for b in p]], schema,
                      capacity=BATCH)
        return ns.Agg(scan, groups, aggs, mode="complete", **kw), 1
    partial = ns.Agg(ns.Mem(parts, schema, capacity=BATCH), groups, aggs,
                     mode="partial", **kw)
    part = ns.Hash((C(0),), 2) if group else ns.Single()
    ex = ns.Shuffle(partial, part, input_partitions=2)
    final = ns.Agg(ex, groups, [ns.ir.AggFunction(a.fn, None, a.distinct)
                                for a in aggs], mode="final", **kw)
    return final, (2 if group else 1)


def _run(ns, op, partitions: int) -> pa.Table:
    conf = ns.cfg.AuronConfig({"auron.hashtable.backend": "sort"})
    out = []
    for p in range(partitions):
        ctx = ns.Ctx(partition_id=p, num_partitions=partitions, config=conf)
        out += [ns.bridge.to_arrow(b, op.schema())
                for b in op.execute(p, ctx) if int(b.num_rows)]
    schema = ns.bridge.schema_to_arrow(op.schema())
    return pa.Table.from_batches(out, schema=schema) if out \
        else schema.empty_table()


def _bits(x):
    """A value as something ``==`` compares exactly: a float by its
    bits (NaN payloads and signed zeros kept), a list element-wise."""
    if isinstance(x, float):
        return ("f", struct.pack("<d", x))
    if isinstance(x, list):
        return [_bits(e) for e in x]
    return x


def assert_same(got: pa.Table, want: pa.Table) -> None:
    """Identical schema, rows, lists (element order too) and float bits,
    but avg DISTINCT over floats: within ``F64_REL`` relative."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    for name in want.column_names:
        g, w = got[name].to_pylist(), want[name].to_pylist()
        fn = None if name in ("k",) else AGGS[int(name[1:])][0] \
            if name.startswith("a") and "#" not in name else None
        if fn == "avg":
            assert [a is None for a in g] == [b is None for b in w], name
            gv = np.array([np.nan if a is None else a for a in g])
            wv = np.array([np.nan if b is None else b for b in w])
            np.testing.assert_allclose(gv, wv, rtol=F64_REL, err_msg=name)
            continue
        assert _bits(g) == _bits(w), name


@pytest.fixture(scope="module")
def results(data):
    """{(mode, group): (reference table, port table)}, run once."""
    cache = {}

    def get(mode, group):
        if (mode, group) not in cache:
            rop, rparts = _plan(REF, data, mode, group)
            top, tparts = _plan(PORT, data, mode, group)
            cache[mode, group] = (_run(REF, rop, rparts),
                                  _run(PORT, top, tparts))
        return cache[mode, group]
    return get


@pytest.mark.parametrize("mode", ["complete", "two_phase"])
@pytest.mark.parametrize("group", [True, False], ids=["keyed", "global"])
def test_collect_and_distinct_match_reference(results, mode, group):
    want, got = results(mode, group)
    assert_same(got, want)


def test_sets_keep_nans_and_merge_signed_zeros(data, results):
    """Within a global set over w: every NaN is its own element, and
    -0.0 and 0.0 are one; count DISTINCT counts so; both as the
    reference's."""
    want, got = results("complete", False)
    s = got["a2"].to_pylist()[0]
    nans = sum(1 for x in s if x != x)
    flat = [x for rb in (b for p in data for b in p)
            for x in rb.column("w").to_pylist() if x is not None]
    assert nans == sum(1 for x in flat if x != x) > 1
    assert len([x for x in s if x == 0.0]) == 1
    assert got["a10"].to_pylist()[0] == len(s)
    assert _bits(want["a2"].to_pylist()) == _bits(got["a2"].to_pylist())


def test_growth_retries_are_counted_host_syncs(data):
    """A group past its element slots runs the step again: the retries
    are counted, and each is one more host readback."""
    top, _ = _plan(PORT, data, "complete", False)
    before = TAgg.grow_retries
    syncs = tbase.host_readback.syncs
    _run(PORT, top, 1)
    retries = TAgg.grow_retries - before
    assert retries > 0
    # each batch reduce and merge reads back once, each retry once more
    assert tbase.host_readback.syncs - syncs > retries


def test_empty_global_collect_and_count_distinct():
    schema = pa.schema([("k", pa.int64()), ("v", pa.int64())])
    out = {}
    for ns in (REF, PORT):
        C = ns.ir.ColumnRef
        scan = ns.Mem([[]], ns.bridge.schema_from_arrow(schema))
        op = ns.Agg(scan, [], [ns.ir.AggFunction("collect_list", C(1)),
                               ns.ir.AggFunction("count", C(1), True),
                               ns.ir.AggFunction("sum", C(1), True)],
                    mode="complete", agg_names=["l", "c", "s"])
        out[ns is PORT] = _run(ns, op, 1).to_pylist()
    assert out[True] == out[False] == [{"l": [], "c": 0, "s": None}]


def _decimal_table(seed=3, rows=300):
    rng = np.random.default_rng(seed)
    u = rng.integers(-400, 400, rows)
    ok = rng.random(rows) > 0.1
    return pa.table({
        "g": pa.array(rng.integers(0, 6, rows), pa.int64()),
        "p": pa.array([decimal.Decimal(int(x)).scaleb(-2) if o else None
                       for x, o in zip(u, ok)], pa.decimal128(7, 2))})


@pytest.mark.parametrize("parts", [1, 3])
def test_dsl_decimal_distinct_regroups_like_the_reference(parts):
    table = _decimal_table()

    def build(dsl, session):
        df = session.from_arrow(table, name="t")
        if parts > 1:
            df = df.repartition(parts)
        F, col = dsl.functions, dsl.col
        return df.group_by("g").agg(
            F.sum(col("p"), distinct=True).alias("s"),
            F.avg(col("p"), distinct=True).alias("a"),
            F.count(col("p"), distinct=True).alias("c"))

    tdf_, rdf_ = build(tdf, TSession(device="cpu")), build(rdf, RSession())
    assert tdf_.plan.SerializeToString() == rdf_.plan.SerializeToString()
    got = tdf_.collect().sort_by("g")
    want = rdf_.collect().sort_by("g")
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()
    # held against Python decimal over the distinct values
    rows = table.to_pylist()
    for r in got.to_pylist():
        vals = {x["p"] for x in rows if x["g"] == r["g"]
                and x["p"] is not None}
        assert r["s"] == sum(vals)
        assert r["c"] == len(vals)
        with decimal.localcontext() as ctx:
            ctx.rounding = decimal.ROUND_HALF_UP
            assert r["a"] == (sum(vals) / len(vals)).quantize(
                decimal.Decimal(1).scaleb(-6))


def test_dsl_collect_result_types_match_the_reference():
    table = _decimal_table()
    for dsl, session in ((tdf, TSession(device="cpu")), (rdf, RSession())):
        F, col = dsl.functions, dsl.col
        df = session.from_arrow(table, name="t").group_by("g").agg(
            F.collect_list(col("p")).alias("l"),
            F.collect_set(col("g")).alias("s"))
        if dsl is tdf:
            got = df
        else:
            want = df
    assert [(f.name, f.dtype.value, f.precision, f.scale, f.elem.value)
            for f in list(got.schema)[1:]] == \
        [(f.name, f.dtype.value, f.precision, f.scale, f.elem.value)
         for f in list(want.schema)[1:]]
    g = got.collect().sort_by("g")
    w = want.collect().sort_by("g")
    assert g.schema == w.schema and g.to_pylist() == w.to_pylist()
