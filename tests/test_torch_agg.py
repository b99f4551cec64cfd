"""The port's AggOp against the JAX package's, on the CPU.

The same seeded pyarrow batches feed a plan built in each package:
a complete AggOp over a MemoryScanOp, and a partial AggOp → 2-way hash
ShuffleExchangeOp → final AggOp. Each plan runs on the sort path
(``auron.hashtable.backend=sort``), the hash path (``=hash``, which also
forces the float sums onto the table) and the dense path (a
``key_domain`` hint; the reference runs its Pallas kernel through the
interpreter, the port the CUDA kernel's plain version).

Decimal aggregates (narrow and wide sums, averages, min, max, first and
count; a wide sum that overflows decimal(38) nulls its group) run on the
sort and hash paths, complete and partial → final, grouped by an int64
or a wide decimal key, and give the reference's rows exactly.

Tolerances: keys, counts, integer sums, min, max, first, null masks and
the row order are identical; float64 sums and averages agree within
1e-12 of the group's sum of |v|; on the dense path, whose float sums
accumulate per batch in f32, within 1e-5 of it.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops.agg import AggOp as RAgg
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu.parallel.partitioning import HashPartitioning as RHash
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ops.agg import AggOp as TAgg
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle
from auron_tpu_torch.parallel.partitioning import HashPartitioning as THash

REF = SimpleNamespace(ir=rir, Agg=RAgg, Mem=RMem, Shuffle=RShuffle,
                      Hash=RHash, Ctx=RCtx, cfg=rcfg, bridge=rbridge)
PORT = SimpleNamespace(ir=tir, Agg=TAgg,
                       Mem=functools.partial(TMem, device="cpu"),
                       Shuffle=TShuffle,
                       Hash=THash, Ctx=TCtx, cfg=tcfg, bridge=tbridge)

F64_TOL = 1e-12
DENSE_TOL = 1e-5
ROWS, BATCH, KEYS = 2048, 256, 700


def _data(seed=11, rows=ROWS, keys=KEYS, unique=False, null_keys=True):
    """(partitions of record batches, numpy columns): k int64 (with nulls
    unless ``null_keys`` is false; the dense path refuses them), v int64
    with negatives and nulls, w float64 with nulls."""
    rng = np.random.default_rng(seed)
    k = (rng.permutation(rows) if unique
         else rng.integers(0, keys, rows)).astype(np.int64)
    kv = (rng.random(rows) > 0.02) | (not null_keys)
    v = rng.integers(-10**6, 10**6, rows)
    vv = rng.random(rows) > 0.1
    w = rng.normal(size=rows) * 100
    wv = rng.random(rows) > 0.1
    cols = {"k": (k, kv), "v": (v, vv), "w": (w, wv)}
    rbs = [pa.record_batch({
        "k": pa.array(k[i:i + BATCH], pa.int64(), mask=~kv[i:i + BATCH]),
        "v": pa.array(v[i:i + BATCH], pa.int64(), mask=~vv[i:i + BATCH]),
        "w": pa.array(w[i:i + BATCH], pa.float64(), mask=~wv[i:i + BATCH])})
        for i in range(0, rows, BATCH)]
    half = len(rbs) // 2
    return [rbs[:half], rbs[half:]], cols


def _aggs(ns, dense: bool):
    """Every aggregate of the ported subset, over an int64 (v) and a
    float64 (w) column."""
    C = ns.ir.ColumnRef
    out = [ns.ir.AggFunction(fn, C(col)) for fn, col in (
        ("sum", 1), ("count", 1), ("avg", 2), ("min", 1), ("max", 2),
        ("sum", 2), ("avg", 1))]
    out.append(ns.ir.AggFunction("count_star", None))
    if not dense:
        # the dense path does not take first; the dispatch would refuse
        out += [ns.ir.AggFunction("first", C(1)),
                ns.ir.AggFunction("first_ignores_null", C(2))]
    return out


def _scan(ns, parts, capacity=BATCH):
    return ns.Mem(parts, ns.bridge.schema_from_arrow(parts[0][0].schema),
                  capacity=capacity)


def _plan(ns, parts, mode: str, path: str, group=True, capacity=BATCH,
          initial_capacity=4096):
    """mode: 'complete' over one partition, or 'two_phase' (partial →
    hash exchange → final over two)."""
    dense = path == "dense"
    aggs = _aggs(ns, dense)
    names = [f"a{i}" for i in range(len(aggs))]
    C = ns.ir.ColumnRef
    groups = [C(0)] if group else []
    kw = dict(group_names=["k"] if group else [], agg_names=names,
              initial_capacity=initial_capacity)
    if mode == "complete":
        scan = _scan(ns, [[b for p in parts for b in p]], capacity)
        return ns.Agg(scan, groups, aggs, mode="complete",
                      key_domain=KEYS if dense else None, **kw), 1
    partial = ns.Agg(_scan(ns, parts, capacity), groups, aggs,
                     mode="partial", key_domain=KEYS if dense else None,
                     **kw)
    ex = ns.Shuffle(partial, ns.Hash((C(0),), 2), input_partitions=2)
    final = ns.Agg(ex, [C(0)] if group else [],
                   [ns.ir.AggFunction(a.fn) for a in aggs], mode="final",
                   **kw)
    return final, 2


def _conf(ns, path: str, extra=None):
    conf = {"auron.hashtable.backend": "hash" if path == "hash" else "sort"}
    if path == "dense" and ns is REF:
        conf["auron.kernels.backend"] = "pallas"
    conf.update(extra or {})
    return ns.cfg.AuronConfig(conf)


def _run(ns, op, partitions: int, conf, metrics=None) -> pa.Table:
    """Every partition's output, in partition order, as one table."""
    out = []
    for p in range(partitions):
        ctx = ns.Ctx(partition_id=p, num_partitions=partitions, config=conf)
        if metrics is not None:
            ctx.metrics = metrics
        out += [ns.bridge.to_arrow(b, op.schema())
                for b in op.execute(p, ctx) if int(b.num_rows)]
    schema = ns.bridge.schema_to_arrow(op.schema())
    return pa.Table.from_batches(out, schema=schema) if out \
        else schema.empty_table()


def _abs_sums(keys, cols: dict, col: str) -> np.ndarray:
    """Per output key (None: the null key): the sum of |col| over its
    valid rows; ``keys=None`` means one global group."""
    k, kv = cols["k"]
    x, xv = cols[col]
    if keys is None:
        return np.array([np.abs(np.where(xv, x, 0)).sum()])
    out = []
    for key in keys:
        rows = (~kv) if key is None else (kv & (k == key))
        out.append(np.abs(np.where(rows & xv, x, 0)).sum())
    return np.array(out)


#: the float sums and averages of ``_aggs``' outputs, by the input
#: column they sum: partial state columns and final results
TOLERANT = {"a2": "w", "a5": "w", "a6": "v",
            "a2#sum": "w", "a5#sum": "w"}


def assert_same(got: pa.Table, want: pa.Table, cols: dict,
                tol: float) -> None:
    """Identical schema, row order, null masks and values, except the
    float sums and averages of TOLERANT: within ``tol`` of the group's
    sum of |x|."""
    assert got.schema == want.schema
    assert got.num_rows == want.num_rows
    keys = want["k"].to_pylist() if "k" in want.column_names else None
    for name in want.column_names:
        g, w = got[name].to_pylist(), want[name].to_pylist()
        assert [x is None for x in g] == [x is None for x in w], name
        if name not in TOLERANT:
            assert g == w, name
            continue
        scale = _abs_sums(keys, cols, TOLERANT[name])
        gv = np.array([0.0 if x is None else x for x in g])
        wv = np.array([0.0 if x is None else x for x in w])
        bad = np.abs(gv - wv) > tol * scale
        assert not bad.any(), (name, gv[bad], wv[bad])


@pytest.fixture(scope="module")
def data():
    return {"keys_with_nulls": _data(), "keys_without_nulls": _data(
        null_keys=False)}


CASES = [(mode, path) for path in ("sort", "hash", "dense")
         for mode in ("complete", "two_phase")]


@pytest.mark.parametrize("mode,path", CASES,
                         ids=[f"{p}-{m}" for m, p in CASES])
def test_agg_matches_reference(data, mode, path):
    parts, cols = data["keys_without_nulls" if path == "dense"
                       else "keys_with_nulls"]
    ref_op, n = _plan(REF, parts, mode, path)
    port_op, _ = _plan(PORT, parts, mode, path)
    want = _run(REF, ref_op, n, _conf(REF, path))
    metrics = {}
    got = _run(PORT, port_op, n, _conf(PORT, path), metrics)
    assert want.num_rows > 500
    assert_same(got, want, cols, DENSE_TOL if path == "dense" else F64_TOL)
    # the path each package's first AggOp recorded is the one asked for
    agg = metrics["agg"].snapshot()
    expect = {"sort": "dispatch_sort", "hash": "dispatch_hashtable",
              "dense": "dispatch_cuda_dense"}[path]
    assert agg.get(expect, 0) >= 1, agg


def test_partial_output_matches_reference(data):
    """The partial state rows themselves (keys, sums, has-flags, counts)
    in the reference's hash order, before any exchange."""
    parts, cols = data["keys_with_nulls"]
    flat = [[b for p in parts for b in p]]

    def partial(ns):
        aggs = _aggs(ns, False)
        return ns.Agg(_scan(ns, flat), [ns.ir.ColumnRef(0)], aggs,
                      mode="partial", group_names=["k"],
                      agg_names=[f"a{i}" for i in range(len(aggs))])

    want = _run(REF, partial(REF), 1, _conf(REF, "sort"))
    got = _run(PORT, partial(PORT), 1, _conf(PORT, "sort"))
    assert want.num_rows > 500
    assert_same(got, want, cols, F64_TOL)


def test_state_growth_and_hot_to_main_fold():
    """From 16 slots, over 16-row batches: the sort path's merges retry
    at larger capacities and the hot table folds into main
    (``_HOT_FACTOR``); ``first`` keeps the earliest batch's row across
    the merges. Same rows as the reference."""
    parts, cols = _data(seed=21, rows=256, keys=400)
    parts = [[rb.slice(i, 16) for rb in p for i in range(0, BATCH, 16)
              if i < rb.num_rows] for p in parts]

    def plan(ns):
        C = ns.ir.ColumnRef
        aggs = [ns.ir.AggFunction("sum", C(1)),
                ns.ir.AggFunction("first", C(2))]
        return ns.Agg(_scan(ns, [[b for p in parts for b in p]], 16), [C(0)],
                      aggs, mode="complete", group_names=["k"],
                      agg_names=["a0", "a1"], initial_capacity=16)

    want = _run(REF, plan(REF), 1, _conf(REF, "sort"))
    got = _run(PORT, plan(PORT), 1, _conf(PORT, "sort"))
    assert want.num_rows > 8 * 16
    assert_same(got, want, cols, F64_TOL)


@pytest.mark.parametrize("path", ["sort", "hash"])
def test_global_agg_over_empty_input(path):
    """A global aggregate over no rows: one row, counts 0, the rest
    null, in both packages."""
    schema = pa.schema([("k", pa.int64()), ("v", pa.int64()),
                        ("w", pa.float64())])
    empty = [[]]

    def plan(ns):
        scan = ns.Mem(empty, ns.bridge.schema_from_arrow(schema),
                      capacity=16)
        aggs = _aggs(ns, False)
        return ns.Agg(scan, [], aggs, mode="complete",
                      agg_names=[f"a{i}" for i in range(len(aggs))])

    want = _run(REF, plan(REF), 1, _conf(REF, path))
    got = _run(PORT, plan(PORT), 1, _conf(PORT, path))
    assert want.num_rows == 1
    assert got.to_pylist() == want.to_pylist()


KEYLESS = [(mode, path) for path in ("sort", "hash")
           for mode in ("complete", "two_phase")]


@pytest.mark.parametrize("mode,path", KEYLESS,
                         ids=[f"{p}-{m}" for m, p in KEYLESS])
def test_global_agg_over_rows_matches_reference(data, mode, path):
    """A global aggregate (no group keys) over non-empty input: every row
    hashes to the seed and forms one group, in both packages. Two-phase,
    each of the final's two partitions gives one row (the one that
    receives no state row gives the empty-input row)."""
    parts, cols = data["keys_with_nulls"]
    ref_op, n = _plan(REF, parts, mode, path, group=False)
    port_op, _ = _plan(PORT, parts, mode, path, group=False)
    want = _run(REF, ref_op, n, _conf(REF, path))
    got = _run(PORT, port_op, n, _conf(PORT, path))
    assert want.num_rows == (1 if mode == "complete" else 2)
    assert_same(got, want, cols, F64_TOL)


def _zero_batches(split: bool):
    """Groups 1 and 2 hold 0.0 and -0.0 in both orders, group 3 holds
    1.0 and NaN, group 4 one 5.0 and a null: in one batch, or the first
    value of each group in one batch and the second in the next."""
    k = [1, 1, 2, 2, 3, 3, 4, 4]
    w = [0.0, -0.0, -0.0, 0.0, 1.0, float("nan"), 5.0, None]
    if not split:
        return [pa.record_batch({"k": pa.array(k, pa.int64()),
                                 "w": pa.array(w, pa.float64())})]
    return [pa.record_batch({"k": pa.array(k[i::2], pa.int64()),
                             "w": pa.array(w[i::2], pa.float64())})
            for i in (0, 1)]


@pytest.mark.parametrize("split", [False, True],
                         ids=["one_batch", "two_batches"])
@pytest.mark.parametrize("path", ["sort", "hash", "dense"])
def test_float_min_max_order_signed_zeros(path, split):
    """Float min and max order -0.0 below 0.0, as the reference's XLA
    reductions do, whichever zero comes first (within a batch and across
    batches); a group holding a NaN gives NaN for both (ROADMAP Queue 3
    item 7, kept)."""
    rbs = _zero_batches(split)

    def plan(ns):
        scan = ns.Mem([rbs], ns.bridge.schema_from_arrow(rbs[0].schema),
                      capacity=8)
        C = ns.ir.ColumnRef
        return ns.Agg(scan, [C(0)], [ns.ir.AggFunction("min", C(1)),
                                     ns.ir.AggFunction("max", C(1))],
                      mode="complete", group_names=["k"],
                      agg_names=["lo", "hi"],
                      key_domain=8 if path == "dense" else None)

    want = _run(REF, plan(REF), 1, _conf(REF, path))
    metrics = {}
    got = _run(PORT, plan(PORT), 1, _conf(PORT, path), metrics)
    expect = {"sort": "dispatch_sort", "hash": "dispatch_hashtable",
              "dense": "dispatch_cuda_dense"}[path]
    assert metrics["agg"].snapshot().get(expect, 0) == 1

    def by_key(t):
        return {r["k"]: (r["lo"], r["hi"]) for r in t.to_pylist()}

    g, w = by_key(got), by_key(want)
    assert set(g) == set(w) == {1, 2, 3, 4}
    for key in (1, 2):
        for side in (g, w):
            lo, hi = side[key]
            assert (lo, hi) == (0.0, 0.0)
            assert np.signbit(lo) and not np.signbit(hi), (path, key, side)
    for side in (g, w):
        assert all(np.isnan(x) for x in side[3])
        assert side[4] == (5.0, 5.0)


def test_partial_skip_passes_rows_through():
    """Unique keys: once auron.agg.partial_skip.min_rows rows are seen
    the partial agg flushes its state and passes the rest through in
    state layout; the rows match the reference's."""
    parts, cols = _data(seed=5, unique=True)
    extra = {"auron.agg.partial_skip.min_rows": 512}
    flat = [[b for p in parts for b in p]]

    def partial(ns):
        aggs = _aggs(ns, False)
        return ns.Agg(_scan(ns, flat), [ns.ir.ColumnRef(0)], aggs,
                      mode="partial", group_names=["k"],
                      agg_names=[f"a{i}" for i in range(len(aggs))])

    want = _run(REF, partial(REF), 1, _conf(REF, "sort", extra))
    metrics = {}
    got = _run(PORT, partial(PORT), 1, _conf(PORT, "sort", extra), metrics)
    skipped = metrics["agg"].snapshot()["partial_agg_skipped_rows"]
    assert skipped == ROWS - 512
    # the first 512 rows flushed as groups (the null keys as one), the
    # rest passed through row by row
    assert ROWS - 512 < got.num_rows <= ROWS
    assert_same(got, want, cols, F64_TOL)


@pytest.mark.parametrize("bad", ["above_domain", "negative", "null"])
def test_dense_key_outside_hint_fails_as_in_reference(bad):
    """A key outside the key_domain hint fails the task with the same
    ValueError in both packages, at emit."""
    rng = np.random.default_rng(3)
    k = rng.integers(0, 16, 128)
    mask = np.zeros(128, bool)
    if bad == "above_domain":
        k[77] = 16
    elif bad == "negative":
        k[5] = -1
    else:
        mask[9] = True
    rb = pa.record_batch({"k": pa.array(k, pa.int64(), mask=mask),
                          "v": pa.array(rng.normal(size=128))})

    def plan(ns):
        scan = ns.Mem([[rb]], ns.bridge.schema_from_arrow(rb.schema),
                      capacity=128)
        return ns.Agg(scan, [ns.ir.ColumnRef(0)],
                      [ns.ir.AggFunction("sum", ns.ir.ColumnRef(1))],
                      mode="partial", key_domain=16)

    errors = []
    for ns in (REF, PORT):
        with pytest.raises(ValueError) as exc:
            _run(ns, plan(ns), 1, _conf(ns, "dense"))
        errors.append(str(exc.value))
    assert errors[0] == errors[1]


def test_dense_float_sums_go_through_the_kernel_wrapper(monkeypatch):
    """The dense path hands every float sum to ``cuda_sum_count``, which
    chooses the kernel or its plain version from the device its tensors
    are on; nothing above it picks the plain version from the plan's
    declared device. The batches here lie on the CPU, so each call gets
    CPU tensors and runs the plain version."""
    from auron_tpu_torch.kernels import grouped_agg as gagg
    real, calls = gagg.cuda_sum_count, []

    def spy(k, *args, **kw):
        calls.append(k.device.type)
        return real(k, *args, **kw)

    monkeypatch.setattr(gagg, "cuda_sum_count", spy)
    parts, cols = _data(null_keys=False)
    op, n = _plan(PORT, parts, "complete", "dense")
    got = _run(PORT, op, n, _conf(PORT, "dense"))
    want = _run(REF, _plan(REF, parts, "complete", "dense")[0], n,
                _conf(REF, "dense"))
    assert_same(got, want, cols, DENSE_TOL)
    # avg(w) and sum(w) sum floats, one call each per batch (avg(v)
    # keeps an int64 sum)
    assert calls == ["cpu"] * 2 * (ROWS // BATCH)


def test_device_scan_takes_its_device_from_its_batches():
    """A device scan's device is its batches' (the operators above pick
    their kernels from it); a batch on another device fails the scan."""
    from auron_tpu_torch.io.parquet import DeviceBatchScanOp
    parts, _ = _data()
    schema = tbridge.schema_from_arrow(parts[0][0].schema)
    batches = [[tbridge.to_device(rb, capacity=BATCH, device="cpu")[0]
                for rb in p] for p in parts]
    assert DeviceBatchScanOp(batches, schema).device == torch.device("cpu")
    wrong = DeviceBatchScanOp(batches, schema, device="meta")
    with pytest.raises(ValueError, match="got a batch on cpu"):
        list(wrong.execute(0, TCtx()))
    for source in (lambda p: batches[p], [[], []]):
        with pytest.raises(ValueError, match="needs its device"):
            DeviceBatchScanOp(source, schema)


def test_unported_aggregates_raise():
    schema = pa.schema([("k", pa.int64()), ("v", pa.int64())])
    scan = TMem([[]], tbridge.schema_from_arrow(schema), device="cpu")
    # collect_list and DISTINCT are ported (tests/test_torch_collect.py);
    # the bloom filter is not, and collect over a list the reference
    # refuses too
    with pytest.raises(NotImplementedError, match="not ported"):
        TAgg(scan, [tir.ColumnRef(0)],
             [tir.AggFunction("bloom_filter", tir.ColumnRef(1))])
    lists = TMem([[]], tbridge.schema_from_arrow(pa.schema(
        [("k", pa.int64()), ("v", pa.list_(pa.int64()))])), device="cpu")
    with pytest.raises(NotImplementedError, match="collect_list over list"):
        TAgg(lists, [tir.ColumnRef(0)],
             [tir.AggFunction("collect_list", tir.ColumnRef(1))])
    with pytest.raises(NotImplementedError, match="sum DISTINCT over list"):
        TAgg(lists, [tir.ColumnRef(0)],
             [tir.AggFunction("sum", tir.ColumnRef(1), distinct=True)])


@pytest.mark.parametrize("fn", ["first", "first_ignores_null"])
def test_first_of_a_null_row_matches_reference(fn):
    """A fault of the reference the port keeps (ROADMAP Queue 3): when a
    group's first row is null, ``first`` and ``first_ignores_null`` both
    return that row's payload (0) as a valid value, where Spark gives
    null and the first non-null value (7)."""
    rb = pa.record_batch({"k": pa.array([1, 1, 1, 2], pa.int64()),
                          "v": pa.array([None, 7, 8, None], pa.int64())})

    def plan(ns):
        scan = ns.Mem([[rb]], ns.bridge.schema_from_arrow(rb.schema),
                      capacity=16)
        return ns.Agg(scan, [ns.ir.ColumnRef(0)],
                      [ns.ir.AggFunction(fn, ns.ir.ColumnRef(1))],
                      mode="complete", group_names=["k"], agg_names=["f"])

    want = _run(REF, plan(REF), 1, _conf(REF, "sort"))
    got = _run(PORT, plan(PORT), 1, _conf(PORT, "sort"))
    assert got.to_pylist() == want.to_pylist() == [
        {"k": 1, "f": 0}, {"k": 2, "f": None}]


# ---------------------------------------------------------------------------
# decimals
# ---------------------------------------------------------------------------

import decimal as _pydec

#: (name, precision, scale, magnitude bound of the unscaled values)
_DEC_COLS = [("n", 7, 2, 10 ** 7), ("m", 16, 2, 10 ** 16),
             ("w", 30, 4, 10 ** 30), ("o", 38, 0, 10 ** 38)]


def _dec_data(rows=512, batch=64, keys=40, seed=5):
    """Partitions of record batches: k int64 (with nulls), a wide
    decimal key kd = k * 10^20 + 1 as decimal(25, 2), and the decimal
    columns of ``_DEC_COLS`` with nulls; ``o`` holds values near 10^38,
    so some groups' sums overflow decimal(38, 0)."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, keys, rows)
    kv = rng.random(rows) > 0.03
    cols = {"k": pa.array(k, pa.int64(), mask=~kv),
            "kd": pa.array([_pydec.Decimal(int(x) * 10 ** 20 + 1).scaleb(-2)
                            if ok else None for x, ok in zip(k, kv)],
                           pa.decimal128(25, 2))}
    for name, p, sc, bound in _DEC_COLS:
        big = name == "o"
        vals = [int(rng.integers(10 ** 17, 10 ** 18)) * 10 ** 20
                if big else int(rng.integers(0, min(bound, 10 ** 18)))
                * (bound // min(bound, 10 ** 18)) // 7 for _ in range(rows)]
        vals = [min(v, bound - 1) * (1 if rng.random() < 0.6 else -1)
                for v in vals]
        ok = rng.random(rows) > 0.1
        with _pydec.localcontext() as ctx:
            ctx.prec = 60
            cols[name] = pa.array(
                [_pydec.Decimal(v).scaleb(-sc) if o else None
                 for v, o in zip(vals, ok)], pa.decimal128(p, sc))
    table = pa.table(cols)
    rbs = table.to_batches(max_chunksize=batch)
    half = len(rbs) // 2
    return [rbs[:half], rbs[half:]]


#: the aggregates held on each column: every one on the narrow n and the
#: wide w; on m (p + 4 > 18) the sum and the average that move to the
#: limbs; on o the sum that overflows
_DEC_FNS = {"n": ("sum", "avg", "min", "max", "first", "count"),
            "m": ("sum", "avg"),
            "w": ("sum", "avg", "min", "max", "first", "count"),
            "o": ("sum",)}


def _dec_aggs(ns, columns):
    C = ns.ir.ColumnRef
    names = ["k", "kd"] + [c[0] for c in _DEC_COLS]
    out = [ns.ir.AggFunction(fn, C(names.index(c)))
           for c in columns for fn in _DEC_FNS[c]]
    return out + [ns.ir.AggFunction("count_star", None)]


def _dec_plan(ns, parts, mode, key, columns):
    C = ns.ir.ColumnRef
    aggs = _dec_aggs(ns, columns)
    kw = dict(group_names=["g"], agg_names=[f"a{i}" for i in
                                            range(len(aggs))])
    groups = [C(0 if key == "int64" else 1)]
    if mode == "complete":
        return ns.Agg(_scan(ns, [[b for p in parts for b in p]], 64),
                      groups, aggs, mode="complete", **kw), 1
    partial = ns.Agg(_scan(ns, parts, 64), groups, aggs, mode="partial",
                     **kw)
    ex = ns.Shuffle(partial, ns.Hash((C(0),), 2), input_partitions=2)
    return ns.Agg(ex, [C(0)], [ns.ir.AggFunction(a.fn) for a in aggs],
                  mode="final", **kw), 2


DEC_CASES = [(mode, path, key, cols)
             for mode in ("complete", "two_phase")
             for path, key, cols in (
                 ("sort", "int64", ("n", "m", "w", "o")),
                 ("sort", "decimal", ("w",)),
                 ("hash", "int64", ("n",)),
                 ("hash", "decimal", ("n",)))]


@pytest.mark.parametrize("mode,path,key,cols", DEC_CASES,
                         ids=[f"{p}-{m}-{k}-{''.join(c)}"
                              for m, p, k, c in DEC_CASES])
def test_decimal_aggregates_match_reference(mode, path, key, cols):
    parts = _dec_data()
    ref_op, n = _dec_plan(REF, parts, mode, key, cols)
    port_op, _ = _dec_plan(PORT, parts, mode, key, cols)
    assert port_op.schema() == port_op.schema()
    for rf, tf in zip(ref_op.schema(), port_op.schema()):
        assert (tf.dtype.value, tf.precision, tf.scale) == \
            (rf.dtype.value, rf.precision, rf.scale), rf.name
    want = _run(REF, ref_op, n, _conf(REF, path))
    metrics = {}
    got = _run(PORT, port_op, n, _conf(PORT, path), metrics)
    assert want.num_rows > 20
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()
    agg = metrics["agg"].snapshot()
    assert agg.get(f"dispatch_{'hashtable' if path == 'hash' else 'sort'}",
                   0) >= 1, agg
    if "o" in cols:   # sum(o) overflows decimal(38, 0) in some groups
        i = sum(len(_DEC_FNS[c]) for c in cols[:cols.index("o")])
        sums = got[f"a{i}"].to_pylist()
        assert any(x is None for x in sums) and any(x is not None
                                                     for x in sums)


def test_decimal_partial_state_matches_reference():
    """The partial state rows (limb sums at the input scale, the count
    carrying avg's result type, neutral-filled min/max) and the partial
    schema's (precision, scale) per field."""
    parts = _dec_data()
    flat = [[b for p in parts for b in p]]

    def partial(ns):
        aggs = _dec_aggs(ns, ("n", "m", "w"))
        return ns.Agg(_scan(ns, flat, 64), [ns.ir.ColumnRef(0)], aggs,
                      mode="partial", group_names=["g"],
                      agg_names=[f"a{i}" for i in range(len(aggs))])

    ref_op, port_op = partial(REF), partial(PORT)
    for rf, tf in zip(ref_op.schema(), port_op.schema()):
        assert (tf.name, tf.dtype.value, tf.precision, tf.scale) == \
            (rf.name, rf.dtype.value, rf.precision, rf.scale)
    want = _run(REF, ref_op, 1, _conf(REF, "sort"))
    got = _run(PORT, port_op, 1, _conf(PORT, "sort"))
    assert got.schema == want.schema
    assert got.to_pylist() == want.to_pylist()


def test_decimal_aggregates_refuse_as_the_reference_does():
    """The reference's plan-time refusals of a wide argument, word for
    word."""
    schema = pa.schema([("k", pa.int64()), ("w", pa.decimal128(30, 2))])
    scan = TMem([[]], tbridge.schema_from_arrow(schema), device="cpu")
    with pytest.raises(NotImplementedError,
                       match=r"sum DISTINCT over decimal\(p=30>18\)"):
        TAgg(scan, [tir.ColumnRef(0)],
             [tir.AggFunction("sum", tir.ColumnRef(1), distinct=True)])
    with pytest.raises(NotImplementedError,
                       match=r"bloom_filter over decimal\(p=30>18\)"):
        TAgg(scan, [tir.ColumnRef(0)],
             [tir.AggFunction("bloom_filter", tir.ColumnRef(1))])
