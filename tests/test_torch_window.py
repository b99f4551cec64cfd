"""The port's window operator against the JAX package's, on the CPU.

- The sweep: the same seeded record batches (three of them, so the
  operator concatenates) go through both packages' ``WindowOp`` under
  five configurations: ORDER BY with ties, no ORDER BY, a string
  partition key with ROWS frames ``(-1, 1)`` and ``(-3, 0)``, no
  partition key, and a group limit. Between them they call every
  function of ``RANK_LIKE``, ``OFFSET_FNS`` and ``AGG_FNS`` over int32,
  int64, float64 (with NaN, ±inf and nulls), string and narrow and wide
  decimal columns. Each output column is held against the reference's:
  exactly (ranks, ``row_number``, ``ntile``, counts, offsets, integer
  sums, min and max, decimals, strings, ``percent_rank`` and
  ``cume_dist``), but float64 sums and averages, which fall within
  ``1e-12 * Σ|v|`` over the row's segment up to its frame's end. The one
  departure is ROADMAP Queue 3 item 26: the reference's float min and
  max start from ±finfo.max, the port's from ±inf.
- Item 26 and the segmented scan against numpy oracles.
- The reference's own window cases (``tests/test_window.py``, the window
  cases of ``tests/test_decimal128.py`` and ``tests/test_advice_fixes.py``)
  run on the port against the same pandas and Python ``decimal``
  oracles.
- ``DataFrame.window``'s task bytes, plan trees and validation against
  the reference DataFrame's (q16 and the rollup → rank query run through
  both Sessions in ``test_torch_window_queries.py``).
"""

import decimal
import random
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pyarrow as pa
import pytest
import torch

from auron_tpu import config as rcfg
from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.frontend import dataframe as rdf
from auron_tpu.frontend.session import Session as RSession
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ir.planner import plan_from_bytes as rplan_from_bytes
from auron_tpu.it import tpcds_data as rdata
from auron_tpu.ops import window as rwin
from auron_tpu.runtime.executor import collect as rcollect
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.frontend.session import Session as TSession
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ir.planner import PlannerContext, plan_from_bytes
from auron_tpu_torch.ops import window as twin
from auron_tpu_torch.ops.window import WindowFunctionSpec, WindowOp
from auron_tpu_torch.runtime.executor import collect
from tests.test_torch_planner import _same_tree

REF = SimpleNamespace(ir=rir, win=rwin, bridge=rbridge, collect=rcollect,
                      Mem=RMem)
PORT = SimpleNamespace(ir=tir, win=twin, bridge=tbridge, collect=collect,
                       Mem=lambda *a, **k: TMem(*a, device="cpu", **k))

#: float64 window sums and averages: within this share of Σ|v| over the
#: row's segment up to its frame's end
F64_SUM_TOL = 1e-12

C = tir.ColumnRef


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the sweep: both packages' WindowOp over the same batches
# ---------------------------------------------------------------------------

_WORDS = ["", "a", "Books", "Music", "é", "日本", "Electronics",
          "a-string-past-16-bytes"]


def _dec(rng, n: int, digits: int, nulls: float) -> list:
    return [None if rng.random() < nulls else
            decimal.Decimal(int(rng.integers(-10 ** min(digits, 18),
                                             10 ** min(digits, 18)))
                            * 10 ** max(0, digits - 18)).scaleb(-2)
            for _ in range(n)]


def _sweep_batches(seed: int = 3, n: int = 60) -> list:
    """Three batches of ``n`` rows: partition keys ``g`` (int64, 6
    values and nulls) and ``s`` (strings of widths 8 to 32, nulls);
    order keys ``o`` (ties) and ``u`` (unique); values ``vi`` (int64),
    ``vi32``, ``vf`` (float64 with NaN, ±inf and nulls, an infinity
    after a null), ``vs`` (strings), ``dn`` decimal(7,2), ``dm``
    decimal(12,2) (its sum moves to the limbs), ``dh`` decimal(16,2) (its
    avg moves to the limbs) and ``dw`` decimal(30,2)."""
    rng = np.random.default_rng(seed)
    out = []
    perm = rng.permutation(3 * n)
    for b in range(3):
        vf = rng.normal(size=n) * 100
        vf[rng.integers(0, n, 6)] = np.nan
        vf[rng.integers(0, n, 4)] = np.inf
        vf[rng.integers(0, n, 4)] = -np.inf
        vf_null = rng.random(n) < 0.12
        words = _WORDS if b != 1 else _WORDS[:4]   # a narrower batch
        out.append(pa.record_batch({
            "g": pa.array([None if rng.random() < 0.05 else int(x)
                           for x in rng.integers(0, 6, n)], pa.int64()),
            "s": pa.array([None if rng.random() < 0.08 else
                           words[int(i) % len(words)]
                           for i in rng.integers(0, 8, n)], pa.string()),
            "o": pa.array(rng.integers(0, 25, n), pa.int64()),
            "u": pa.array(perm[b * n:(b + 1) * n], pa.int64()),
            "vi": pa.array([None if rng.random() < 0.1 else int(x)
                            for x in rng.integers(-1000, 1000, n)],
                           pa.int64()),
            "vi32": pa.array(rng.integers(2 ** 28, 2 ** 30, n), pa.int32()),
            "vf": pa.array(np.where(vf_null, np.nan, vf),
                           mask=vf_null, type=pa.float64()),
            "vs": pa.array([None if rng.random() < 0.1 else
                            _WORDS[int(i)]
                            for i in rng.integers(0, len(_WORDS), n)],
                           pa.string()),
            "dn": pa.array(_dec(rng, n, 7, 0.1), pa.decimal128(7, 2)),
            "dm": pa.array(_dec(rng, n, 12, 0.1), pa.decimal128(12, 2)),
            "dh": pa.array(_dec(rng, n, 16, 0.1), pa.decimal128(16, 2)),
            "dw": pa.array(_dec(rng, n, 30, 0.1), pa.decimal128(30, 2)),
        }))
    return out


_COLS = ["g", "s", "o", "u", "vi", "vi32", "vf", "vs", "dn", "dm", "dh",
         "dw"]

#: (kind, fn, arg column, offset, default, frame)
_RANKS = [("rank_like", f, None, 4 if f == "ntile" else 1, None, None)
          for f in twin.RANK_LIKE]


def _aggs(cols, fns=twin.AGG_FNS, frame=None):
    return [("agg", f, None if f == "count_star" else c, 1, None, frame)
            for c in cols for f in fns
            if not (f == "count_star" and c != cols[0])]


def _fn(kind, fn, arg=None, offset=1, default=None, frame=None):
    return (kind, fn, arg, offset, default, frame)


CONFIGS = {
    # ORDER BY with ties: peers share the running aggregate
    "ordered": dict(
        partition_by=("g",), order_by=(("o", True, True),),
        functions=_RANKS + [
            _fn("offset", "lead", "vi"),
            _fn("offset", "lag", "vs", 2),
            _fn("offset", "lead", "dw", 2),
            _fn("offset", "first_value", "vf"),
            _fn("offset", "last_value", "vs"),
            _fn("offset", "nth_value", "dn", 2)]
        + _aggs(["vi"])
        + _aggs(["vf", "dw"], ("sum", "avg", "min", "max"))
        + [_fn("agg", "sum", "dm"), _fn("agg", "avg", "dh"),
           _fn("agg", "avg", "dn"), _fn("agg", "sum", "vi32")],
        group_limit=None),
    # no ORDER BY: every row sees its whole partition
    "unordered": dict(
        partition_by=("g",), order_by=(),
        functions=[_fn("rank_like", "row_number"), _fn("rank_like", "rank"),
                   _fn("rank_like", "cume_dist"),
                   _fn("offset", "first_value", "vs"),
                   _fn("offset", "last_value", "vi"),
                   _fn("offset", "nth_value", "dm", 2),
                   _fn("agg", "sum", "vf"), _fn("agg", "min", "vf"),
                   _fn("agg", "avg", "vi"), _fn("agg", "sum", "dw"),
                   _fn("agg", "count", "vs")],
        group_limit=None),
    # a string partition key, a unique order, ROWS frames and defaults
    "frames": dict(
        partition_by=("s",), order_by=(("u", False, False),),
        functions=[_fn("rank_like", "row_number"),
                   _fn("rank_like", "ntile", offset=3),
                   _fn("offset", "lead", "vi", 1, -999),
                   _fn("offset", "lag", "vs", 2, "ZZ-default"),
                   _fn("offset", "lag", "vf", 1, 0.5)]
        + [_fn("agg", f, c, frame=(-1, 1)) for f, c in (
            ("sum", "vf"), ("avg", "vf"), ("count", "vi"),
            ("count_star", None), ("avg", "dn"), ("sum", "dm"))]
        + [_fn("agg", f, c, frame=(-3, 0)) for f, c in (
            ("sum", "vi"), ("avg", "vi"), ("sum", "vf"), ("sum", "dw"),
            ("count_star", None))],
        group_limit=None),
    # no partition key: one segment over the whole batch
    "global": dict(
        partition_by=(), order_by=(("u", True, True),),
        functions=[_fn("rank_like", "row_number"),
                   _fn("rank_like", "percent_rank"),
                   _fn("offset", "lag", "vf"), _fn("agg", "sum", "vf"),
                   _fn("agg", "max", "vf"), _fn("agg", "min", "dw")],
        group_limit=None),
    # the window-group limit: rows of rank <= 3 only
    "group_limit": dict(
        partition_by=("g", "s"), order_by=(("o", False, True),),
        functions=[_fn("rank_like", "rank"), _fn("rank_like", "dense_rank"),
                   _fn("agg", "sum", "vi"), _fn("offset", "lead", "vs")],
        group_limit=3),
}


def _spec(ns, t):
    kind, fn, arg, offset, default, frame = t
    return ns.win.WindowFunctionSpec(
        kind, fn, ns.ir.ColumnRef(_COLS.index(arg)) if arg else None,
        offset, default, frame)


def _window_op(ns, batches, conf, capacity=64):
    scan = ns.Mem([batches], ns.bridge.schema_from_arrow(batches[0].schema),
                  capacity=capacity)
    return ns.win.WindowOp(
        scan,
        partition_by=[ns.ir.ColumnRef(_COLS.index(c))
                      for c in conf["partition_by"]],
        order_by=[ns.ir.SortOrder(ns.ir.ColumnRef(_COLS.index(c)), a, nf)
                  for c, a, nf in conf["order_by"]],
        functions=[_spec(ns, t) for t in conf["functions"]],
        output_names=[f"w{i}" for i in range(len(conf["functions"]))],
        group_limit=conf["group_limit"])


@pytest.fixture(scope="module")
def sweep():
    """{config: (reference table, port table, port syncs)}, each built
    once."""
    batches = _sweep_batches()
    out = {}
    for name, conf in CONFIGS.items():
        want = REF.collect(_window_op(REF, batches, conf))
        op = _window_op(PORT, batches, conf)
        metrics = {}
        got = PORT.collect(op, metrics=metrics)
        out[name] = (want, got, metrics["window"].snapshot())
    return out


def _segments(table, conf):
    """Each output row's segment start, segment end and peer-group end
    (positions in the sorted output)."""
    n = table.num_rows
    keys = [table[c].to_pylist() for c in conf["partition_by"]]
    orders = [table[c].to_pylist() for c, _a, _nf in conf["order_by"]]
    start, tie = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(1, n):
        new_seg = any(k[i] != k[i - 1] for k in keys)
        start[i] = i if new_seg else start[i - 1]
        new_tie = new_seg or any(o[i] != o[i - 1] for o in orders)
        tie[i] = i if new_tie else tie[i - 1]
    seg_end, tie_end = np.zeros(n, np.int64), np.zeros(n, np.int64)
    for i in range(n - 1, -1, -1):
        last = i == n - 1
        seg_end[i] = i if last or start[i + 1] != start[i] \
            else seg_end[i + 1]
        tie_end[i] = i if last or tie[i + 1] != tie[i] else tie_end[i + 1]
    return start, seg_end, tie_end


def _float_sum_bound(table, conf, spec) -> np.ndarray:
    """``F64_SUM_TOL * Σ|v|`` per row, over the row's segment from its
    start to its frame's end, finite values only."""
    start, seg_end, tie_end = _segments(table, conf)
    v = table[spec[2]].to_numpy(zero_copy_only=False)
    v = np.where(np.isfinite(v), np.abs(v), 0.0)
    pre = np.concatenate([[0.0], np.cumsum(v)])
    if spec[5] is not None:
        end = np.minimum(np.arange(len(v)) + spec[5][1], seg_end)
    else:
        end = tie_end if conf["order_by"] else seg_end
    end = np.maximum(end, start)
    return F64_SUM_TOL * (pre[end + 1] - pre[start])


_CASES = [(name, i) for name, conf in CONFIGS.items()
          for i in range(len(conf["functions"]))]


@pytest.mark.parametrize(
    "config,i", _CASES,
    ids=[f"{n}-{i}-{CONFIGS[n]['functions'][i][1]}"
         f"-{CONFIGS[n]['functions'][i][2] or ''}"
         f"{'-rows' if CONFIGS[n]['functions'][i][5] else ''}"
         for n, i in _CASES])
def test_window_function_matches_reference(config, i, sweep):
    want, got, _metrics = sweep[config]
    conf = CONFIGS[config]
    spec = conf["functions"][i]
    assert got.num_rows == want.num_rows > 0
    # the input columns come out in the same sorted order
    for c in _COLS:
        assert _nan_safe(got[c].to_pylist()) == \
            _nan_safe(want[c].to_pylist()), c
    name = f"w{i}"
    assert got.schema.field(name).type == want.schema.field(name).type
    w, g = want[name].to_pylist(), got[name].to_pylist()
    kind, fn, arg = spec[:3]
    is_float = arg == "vf" or (kind == "agg" and fn == "avg"
                               and arg in ("vi", "vi32"))
    if kind == "agg" and fn in ("sum", "avg") and arg == "vf":
        assert [x is None for x in g] == [x is None for x in w]
        bound = _float_sum_bound(got, conf, spec)
        gv = np.array([np.nan if x is None else x for x in g])
        wv = np.array([np.nan if x is None else x for x in w])
        fin = np.isfinite(wv)
        assert np.array_equal(np.isfinite(gv), fin)
        assert np.array_equal(gv[~fin & ~np.isnan(wv)],
                              wv[~fin & ~np.isnan(wv)])
        assert np.array_equal(np.isnan(gv), np.isnan(wv))
        assert (np.abs(gv[fin] - wv[fin]) <= bound[fin]).all()
        return
    if kind == "agg" and fn in ("min", "max") and arg == "vf":
        # item 26: the reference's neutral is ±finfo.max, the port's ±inf
        big = np.finfo(np.float64).max
        w = [np.inf if x == big else -np.inf if x == -big else x for x in w]
    if is_float:
        g, w = _nan_safe(g), _nan_safe(w)
    assert g == w


def _nan_safe(values: list) -> list:
    """NaN as a string, so that lists holding it compare equal."""
    return ["nan" if isinstance(x, float) and x != x else x for x in values]


def test_sweep_exercises_every_function_and_type(sweep):
    seen = {(t[0], t[1]) for conf in CONFIGS.values()
            for t in conf["functions"]}
    assert {f for k, f in seen if k == "rank_like"} == set(twin.RANK_LIKE)
    assert {f for k, f in seen if k == "offset"} == set(twin.OFFSET_FNS)
    assert {f for k, f in seen if k == "agg"} == set(twin.AGG_FNS)
    _want, got, _m = sweep["ordered"]
    # a wide sum, a narrow sum that moved to the limbs, a wide avg
    assert got.schema.field(f"w{_index('ordered', 'sum', 'dm')}").type \
        == pa.decimal128(22, 2)
    assert got.schema.field(f"w{_index('ordered', 'avg', 'dh')}").type \
        == pa.decimal128(20, 6)
    _want, got, _m = sweep["group_limit"]
    assert max(got["w0"].to_pylist()) <= 3


def _index(config, fn, arg, frame=None) -> int:
    return next(i for i, t in enumerate(CONFIGS[config]["functions"])
                if t[1] == fn and t[2] == arg and t[5] == frame)


def test_window_reads_no_host_value(sweep):
    """The operator's one window batch reads nothing on the host."""
    for name, (_w, _g, metrics) in sweep.items():
        assert metrics["host_syncs"] == 0, name
        assert metrics["output_batches"] == 1, name


# ---------------------------------------------------------------------------
# ROADMAP Queue 3 item 26 and the segmented scan, against numpy
# ---------------------------------------------------------------------------

def _run(rb, functions, partition_by=("g",), order_by=("o",),
         group_limit=None, capacity=512):
    rbs = rb if isinstance(rb, list) else [rb]
    schema = tbridge.schema_from_arrow(rbs[0].schema)
    names = [f"w{i}" for i in range(len(functions))]
    op = WindowOp(
        TMem([rbs], schema, capacity=capacity, device="cpu"),
        partition_by=[C(rbs[0].schema.get_field_index(c))
                      for c in partition_by],
        order_by=[tir.SortOrder(C(rbs[0].schema.get_field_index(c)))
                  for c in order_by],
        functions=functions, output_names=names, group_limit=group_limit)
    return collect(op).to_pandas()


def test_item26_min_max_keep_an_infinity_after_a_null():
    """ROADMAP Queue 3 item 26's probe: p=1 with v=[null, +inf, 1.0] and
    p=2 with v=[null, -inf], ordered by o. Spark's running min of p=1 is
    [null, inf, 1.0] and max of p=2 [null, -inf]; the reference gives the
    largest finite float on those rows."""
    rb = pa.record_batch({
        "g": pa.array([1, 1, 1, 2, 2], pa.int64()),
        "o": pa.array([1, 2, 3, 1, 2], pa.int64()),
        "v": pa.array([None, np.inf, 1.0, None, -np.inf], pa.float64())})
    fns = [WindowFunctionSpec("agg", "min", arg=C(2)),
           WindowFunctionSpec("agg", "max", arg=C(2))]
    got = _run(rb, fns)
    assert got["w0"].tolist()[:3] == [None, np.inf, 1.0] or (
        np.isnan(got["w0"][0]) and got["w0"].tolist()[1:3] == [np.inf, 1.0])
    assert np.isinf(got["w1"][4]) and got["w1"][4] < 0
    assert got["w1"].isna().tolist() == [True, False, False, True, False]
    ref = rcollect(rwin.WindowOp(
        RMem([[rb]], rbridge.schema_from_arrow(rb.schema), capacity=512),
        [rir.ColumnRef(0)], [rir.SortOrder(rir.ColumnRef(1))],
        [rwin.WindowFunctionSpec("agg", "min", arg=rir.ColumnRef(2)),
         rwin.WindowFunctionSpec("agg", "max", arg=rir.ColumnRef(2))],
        output_names=["w0", "w1"])).to_pandas()
    big = np.finfo(np.float64).max
    assert ref["w0"][1] == big and ref["w1"][4] == -big


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_running_min_max_match_numpy_oracle(seed):
    """Running min and max with nulls, NaN and ±inf against a python loop
    of Spark's semantics: nulls skipped, ±inf kept, and NaN spreading as
    it does in the reference (``torch.minimum``, ``torch.maximum``)."""
    rng = np.random.default_rng(seed)
    n = 200
    v = rng.normal(size=n)
    v[rng.integers(0, n, 15)] = np.inf
    v[rng.integers(0, n, 15)] = -np.inf
    v[rng.integers(0, n, 5)] = np.nan
    null = rng.random(n) < 0.3
    rb = pa.record_batch({
        "g": pa.array(rng.integers(0, 7, n), pa.int64()),
        "o": pa.array(rng.permutation(n), pa.int64()),
        "v": pa.array(np.where(null, 0.0, v), mask=null,
                      type=pa.float64())})
    op = WindowOp(TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                       capacity=256, device="cpu"),
                  [C(0)], [tir.SortOrder(C(1))],
                  [WindowFunctionSpec("agg", "min", arg=C(2)),
                   WindowFunctionSpec("agg", "max", arg=C(2))],
                  output_names=["mn", "mx"])
    got = collect(op).to_pydict()
    lo = hi = None
    for i, x in enumerate(got["v"]):
        if i == 0 or got["g"][i] != got["g"][i - 1]:
            lo = hi = None
        if x is not None:
            nan = x != x
            lo = x if lo is None else (
                np.nan if nan or lo != lo else min(lo, x))
            hi = x if hi is None else (
                np.nan if nan or hi != hi else max(hi, x))
        assert _nan_safe([got["mn"][i], got["mx"][i]]) == \
            _nan_safe([lo, hi]), i


def _numpy_segmented(flags, values, op):
    out, acc = [], None
    for f, x in zip(flags, values):
        acc = x if f or acc is None else op(acc, x)
        out.append(acc)
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 17, 64, 1000])
def test_segmented_scan_matches_numpy_loop(n):
    """``segmented_scan`` over random flags against a python loop: int64
    sums (wrapping past 2^63, and ``_segmented_sum_int``), float min
    with NaN and ±inf, and 128-bit limb sums."""
    rng = np.random.default_rng(n)
    flags = rng.random(n) < 0.2
    flags[0] = True
    tf = torch.from_numpy(flags)
    ints = rng.integers(-2 ** 62, 2 ** 62, n, dtype=np.int64)
    want = _numpy_segmented(
        flags, ints.tolist(),
        lambda a, b: ((a + b + 2 ** 63) % 2 ** 64) - 2 ** 63)
    ti = torch.from_numpy(ints)
    got = twin.segmented_scan(tf, twin._add, ti)[0]
    assert got.tolist() == want
    start = twin._segmented_cummax_pos(tf)
    assert twin._segmented_sum_int(ti, start).tolist() == want

    f = rng.normal(size=n)
    f[rng.random(n) < 0.05] = np.nan
    f[rng.random(n) < 0.05] = np.inf
    f[rng.random(n) < 0.05] = -np.inf
    want = _numpy_segmented(flags, f.tolist(),
                            lambda a, b: np.nan if np.isnan(a) or np.isnan(b)
                            else min(a, b))
    got = twin.segmented_scan(tf, lambda a, b: (torch.minimum(a, b),),
                              torch.from_numpy(f))[0].tolist()
    assert [("nan" if x != x else x) for x in got] == \
        [("nan" if x != x else x) for x in want]

    big = [int(x) * 10 ** 18 + int(y) for x, y in zip(
        rng.integers(-10 ** 15, 10 ** 15, n), rng.integers(0, 10 ** 18, n))]
    hi, lo, _v = D.limbs_from_ints(big, n)
    want = _numpy_segmented(flags, big, lambda a, b: a + b)
    gh, gl = twin.segmented_scan(tf, D.add128, torch.from_numpy(hi),
                                 torch.from_numpy(lo))
    assert D.ints_from_limbs(gh.numpy(), gl.numpy(),
                             np.ones(n, bool)) == want


# ---------------------------------------------------------------------------
# the reference's window cases, on the port
# ---------------------------------------------------------------------------

def _data(n=500, seed=0, groups=8, unique_order=False):
    rng = np.random.default_rng(seed)
    order = (rng.permutation(n).astype("int64") if unique_order
             else rng.integers(0, 40, n))
    return pa.record_batch({
        "g": pa.array(rng.integers(0, groups, n), pa.int64()),
        "o": pa.array(order, pa.int64()),
        "v": pa.array([None if m else float(x) for m, x in
                       zip(rng.random(n) < 0.1, rng.integers(-50, 50, n))],
                      pa.float64()),
    })


class TestRankFamily:
    def test_row_number_rank_dense_rank(self):
        got = _run(_data(), [
            WindowFunctionSpec("rank_like", "row_number"),
            WindowFunctionSpec("rank_like", "rank"),
            WindowFunctionSpec("rank_like", "dense_rank")])
        df = got[["g", "o"]].copy()
        np.testing.assert_array_equal(got["w0"],
                                      df.groupby("g").cumcount() + 1)
        np.testing.assert_array_equal(
            got["w1"], df.groupby("g")["o"].rank(method="min")
            .astype("int64"))
        np.testing.assert_array_equal(
            got["w2"], df.groupby("g")["o"].rank(method="dense")
            .astype("int64"))

    def test_percent_rank_cume_dist(self):
        got = _run(_data(300, seed=1), [
            WindowFunctionSpec("rank_like", "percent_rank"),
            WindowFunctionSpec("rank_like", "cume_dist")])
        grp = got[["g", "o"]].groupby("g")["o"]
        want_pr = (grp.rank(method="min") - 1) / \
            (grp.transform("count") - 1).clip(lower=1)
        want_cd = grp.rank(method="max") / grp.transform("count")
        np.testing.assert_allclose(got["w0"], want_pr)
        np.testing.assert_allclose(got["w1"], want_cd)

    def test_ntile(self):
        got = _run(_data(100, seed=2, groups=3, unique_order=True),
                   [WindowFunctionSpec("rank_like", "ntile", offset=4)])
        for _, part in got.groupby("g"):
            q, r = divmod(len(part), 4)
            sizes = [q + 1] * r + [q] * (4 - r)
            counts = part["w0"].value_counts().sort_index()
            assert counts.to_dict() == {i + 1: s for i, s in
                                        enumerate(sizes) if s}

    def test_group_limit(self):
        rb = _data(400, seed=3)
        got = _run(rb, [WindowFunctionSpec("rank_like", "rank")],
                   group_limit=3)
        assert (got["w0"] <= 3).all()
        full = _run(rb, [WindowFunctionSpec("rank_like", "rank")])
        assert len(got) == len(full[full["w0"] <= 3])


class TestOffsetFamily:
    def test_lead_lag(self):
        got = _run(_data(300, seed=4, unique_order=True), [
            WindowFunctionSpec("offset", "lead", arg=C(2), offset=1),
            WindowFunctionSpec("offset", "lag", arg=C(2), offset=2)])
        g = got.groupby("g")["v"]
        pd.testing.assert_series_equal(got["w0"], g.shift(-1),
                                       check_names=False)
        pd.testing.assert_series_equal(got["w1"], g.shift(2),
                                       check_names=False)

    def test_lead_default(self):
        got = _run(_data(100, seed=5, unique_order=True), [
            WindowFunctionSpec("offset", "lead", arg=C(1), offset=1,
                               default=-999)])
        want = got.groupby("g")["o"].shift(-1).fillna(-999).astype("int64")
        np.testing.assert_array_equal(got["w0"], want)

    def test_lead_default_string(self):
        rb = pa.record_batch({"g": pa.array([1, 1], pa.int64()),
                              "o": pa.array([1, 2], pa.int64()),
                              "s": pa.array(["a", "b"], pa.string())})
        got = _run(rb, [WindowFunctionSpec("offset", "lead", arg=C(2),
                                           offset=1, default="ZZ")])
        assert got["w0"].tolist() == ["b", "ZZ"]

    def test_sum_int32_widens(self):
        rb = pa.record_batch({"g": pa.array([1, 1, 1], pa.int64()),
                              "o": pa.array([1, 2, 3], pa.int64()),
                              "v": pa.array([2 ** 30] * 3, pa.int32())})
        got = _run(rb, [WindowFunctionSpec("agg", "sum", arg=C(2))])
        assert got["w0"].tolist() == [2 ** 30, 2 ** 31, 3 * 2 ** 30]

    def test_first_last_nth(self):
        got = _run(_data(200, seed=6, unique_order=True), [
            WindowFunctionSpec("offset", "first_value", arg=C(1)),
            WindowFunctionSpec("offset", "last_value", arg=C(1)),
            WindowFunctionSpec("offset", "nth_value", arg=C(1), offset=2)])
        g = got.groupby("g")["o"]
        np.testing.assert_array_equal(got["w0"], g.transform("first"))
        np.testing.assert_array_equal(got["w1"], got["o"])
        second = g.transform(lambda s: s.iloc[1] if len(s) > 1 else np.nan)
        rn = got.groupby("g").cumcount()
        np.testing.assert_array_equal(got["w2"].to_numpy(dtype="float64"),
                                      np.where(rn >= 1, second, np.nan))


class TestAggOverWindow:
    def test_running_sum_count_avg(self):
        got = _run(_data(400, seed=7, unique_order=True), [
            WindowFunctionSpec("agg", "sum", arg=C(2)),
            WindowFunctionSpec("agg", "count", arg=C(2)),
            WindowFunctionSpec("agg", "avg", arg=C(2))])
        g = got.groupby("g")["v"]
        cnt = g.transform(lambda s: s.notna().cumsum())
        want_sum = g.transform(lambda s: s.fillna(0).cumsum()).where(cnt > 0)
        np.testing.assert_allclose(got["w0"], want_sum, equal_nan=True)
        np.testing.assert_array_equal(got["w1"], cnt)
        np.testing.assert_allclose(got["w2"], want_sum / cnt,
                                   equal_nan=True)

    def test_running_min_max(self):
        got = _run(_data(300, seed=8, unique_order=True), [
            WindowFunctionSpec("agg", "min", arg=C(2)),
            WindowFunctionSpec("agg", "max", arg=C(2))])
        g = got.groupby("g")["v"]
        cnt = g.transform(lambda s: s.notna().cumsum())
        want_min = g.transform(
            lambda s: s.fillna(np.inf).cummin()).where(cnt > 0)
        want_max = g.transform(
            lambda s: s.fillna(-np.inf).cummax()).where(cnt > 0)
        np.testing.assert_allclose(got["w0"], want_min, equal_nan=True)
        np.testing.assert_allclose(got["w1"], want_max, equal_nan=True)

    def test_whole_partition_agg_without_order(self):
        got = _run(_data(200, seed=9),
                   [WindowFunctionSpec("agg", "sum", arg=C(2))],
                   order_by=())
        np.testing.assert_allclose(got["w0"],
                                   got.groupby("g")["v"].transform("sum"))

    def test_range_frame_ties_share_value(self):
        rb = pa.record_batch({
            "g": pa.array([1, 1, 1, 1], pa.int64()),
            "o": pa.array([10, 10, 20, 20], pa.int64()),
            "v": pa.array([1.0, 2.0, 3.0, 4.0], pa.float64())})
        got = _run(rb, [WindowFunctionSpec("agg", "sum", arg=C(2))])
        assert got["w0"].tolist() == [3.0, 3.0, 10.0, 10.0]

    def test_count_star(self):
        got = _run(_data(150, seed=10, unique_order=True),
                   [WindowFunctionSpec("agg", "count_star")])
        np.testing.assert_array_equal(got["w0"],
                                      got.groupby("g").cumcount() + 1)


class TestEdges:
    def test_empty_input(self):
        rb = pa.record_batch({"g": pa.array([], pa.int64()),
                              "o": pa.array([], pa.int64()),
                              "v": pa.array([], pa.float64())})
        got = _run(rb, [WindowFunctionSpec("rank_like", "row_number")])
        assert len(got) == 0

    def test_single_partition_no_partition_by(self):
        got = _run(_data(50, seed=11, unique_order=True),
                   [WindowFunctionSpec("rank_like", "row_number")],
                   partition_by=())
        np.testing.assert_array_equal(got["w0"], np.arange(1, 51))

    def test_multi_batch_input(self):
        rb = _data(600, seed=12)
        rbs = [rb.slice(o, 100) for o in range(0, 600, 100)]
        got = _run(rbs, [WindowFunctionSpec("rank_like", "rank")],
                   capacity=128)
        want = got[["g", "o"]].groupby("g")["o"].rank(method="min") \
            .astype("int64")
        np.testing.assert_array_equal(got["w0"], want)

    def test_string_partition_keys(self):
        rb = pa.record_batch({
            "g": pa.array(["a", "b", "a", None, "b", None], pa.string()),
            "o": pa.array([1, 2, 3, 4, 5, 6], pa.int64())})
        got = _run(rb, [WindowFunctionSpec("rank_like", "row_number")])
        # the null group sorts first (nulls first), then 'a', then 'b'
        assert got.to_dict("list")["w0"] == [1, 2, 1, 2, 1, 2]


class TestRowsFrames:
    def _rows(self):
        rng = np.random.default_rng(9)
        return pa.record_batch({
            "g": pa.array(np.repeat([1, 2, 3], 40), pa.int64()),
            "o": pa.array(np.tile(np.arange(40), 3), pa.int64()),
            "v": pa.array(rng.normal(size=120), pa.float64())})

    def test_centered_moving_avg_vs_pandas(self):
        rb = self._rows()
        got = _run(rb, [
            WindowFunctionSpec("agg", "avg", arg=C(2), frame=(-1, 1)),
            WindowFunctionSpec("agg", "sum", arg=C(2), frame=(-1, 1)),
            WindowFunctionSpec("agg", "count", arg=C(2), frame=(-1, 1))])
        got = got.sort_values(["g", "o"])
        grp = rb.to_pandas().sort_values(["g", "o"]).groupby("g")["v"]
        roll = lambda f: grp.transform(
            lambda s: getattr(s.rolling(3, center=True, min_periods=1), f)())
        assert np.allclose(got["w0"].values, roll("mean").values)
        assert np.allclose(got["w1"].values, roll("sum").values)
        assert (got["w2"].values[[0, 1, 39]] == [2, 3, 2]).all()

    def test_trailing_frame_and_proto_roundtrip(self):
        from auron_tpu_torch.ir import auron_pb2 as pb
        from auron_tpu_torch.ir import serde
        rb = self._rows()
        wf = pb.WindowFunctionP(kind="agg", fn="sum", frame_lo=-2,
                                frame_hi=0)
        wf.arg.CopyFrom(serde.expr_to_proto(C(2)))
        node = pb.PlanNode(window=pb.WindowNode(
            child=pb.PlanNode(memory_scan=pb.MemoryScanNode(
                table_name="t")),
            partition_by=[serde.expr_to_proto(C(0))],
            order_by=[serde.sort_order_to_proto(tir.SortOrder(C(1)))],
            functions=[wf], output_names=["ts"]))
        op = plan_from_bytes(
            pb.TaskDefinition(plan=node).SerializeToString(),
            PlannerContext(catalog={"t": pa.Table.from_batches([rb])},
                           device="cpu"))
        got = collect(op).to_pandas().sort_values(["g", "o"])
        exp = rb.to_pandas().sort_values(["g", "o"]).groupby("g")["v"] \
            .transform(lambda s: s.rolling(3, min_periods=1).sum())
        assert np.allclose(got["ts"].values, exp.values)

    def test_frames_reject_min_max(self):
        with pytest.raises(NotImplementedError, match="frames"):
            WindowFunctionSpec("agg", "min", arg=C(0), frame=(-1, 1))

    def test_frame_through_dataframe_dsl(self):
        rb = self._rows()
        s = TSession(device="cpu")
        s.register("t", pa.Table.from_batches([rb]))
        got = (s.table("t")
               .window([tdf.functions.win_agg("avg", tdf.col("v"),
                                              frame=(-1, 1)).alias("ma")],
                       partition_by=[tdf.col("g")],
                       order_by=[tdf.col("o").asc()])
               .collect().to_pandas().sort_values(["g", "o"]))
        exp = rb.to_pandas().sort_values(["g", "o"]).groupby("g")["v"] \
            .transform(lambda x: x.rolling(3, center=True,
                                           min_periods=1).mean())
        assert np.allclose(got["ma"].values, exp.values)

    def test_count_star_frame(self):
        got = _run(self._rows(), [WindowFunctionSpec(
            "agg", "count_star", frame=(-1, 1))]).sort_values(["g", "o"])
        assert list(got["w0"].values[:3]) == [2, 3, 3]
        assert got["w0"].values[39] == 2

    def test_frame_rejects_wide_decimal_avg(self):
        rb = pa.record_batch({
            "g": pa.array([1, 1], pa.int64()),
            "o": pa.array([0, 1], pa.int64()),
            "d": pa.array([decimal.Decimal("1.00")] * 2,
                          pa.decimal128(16, 2))})
        with pytest.raises(NotImplementedError, match="frames"):
            _run(rb, [WindowFunctionSpec("agg", "avg", arg=C(2),
                                         frame=(-1, 1))])


# ---------------------------------------------------------------------------
# decimals over a window (the reference's decimal window cases)
# ---------------------------------------------------------------------------

def _dec_run(rb, functions, names, capacity=128):
    op = WindowOp(TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                       capacity=capacity, device="cpu"),
                  [C(0)], [tir.SortOrder(C(1), True, True)], functions,
                  output_names=names)
    return op, collect(op).to_pandas().sort_values("o") \
        .reset_index(drop=True)


@pytest.fixture
def _wide_decimal_context():
    """Python's ``decimal`` at 60 digits: sums of 38-digit values."""
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        yield


def test_window_running_aggs_wide(_wide_decimal_context):
    rng = random.Random(4)
    n = 120
    groups = [rng.randrange(5) for _ in range(n)]
    vals = [None if i % 7 == 0 else
            decimal.Decimal(rng.randint(-10 ** 30, 10 ** 30)).scaleb(-2)
            for i in range(n)]
    rb = pa.record_batch({"g": pa.array(groups, pa.int64()),
                          "o": pa.array(list(range(n)), pa.int64()),
                          "d": pa.array(vals, pa.decimal128(38, 2))})
    _op, got = _dec_run(rb, [
        WindowFunctionSpec("agg", "sum", arg=C(2)),
        WindowFunctionSpec("agg", "min", arg=C(2)),
        WindowFunctionSpec("agg", "max", arg=C(2)),
        WindowFunctionSpec("agg", "avg", arg=C(2)),
        WindowFunctionSpec("offset", "lag", arg=C(2), offset=1)],
        ["s", "mn", "mx", "av", "lg"])
    state, prev = {}, {}
    q6 = decimal.Decimal(1).scaleb(-6)
    for i in range(n):
        g, v = groups[i], vals[i]
        row = got.iloc[i]
        seen = state.setdefault(g, [])
        if v is not None:
            seen.append(v)
        if seen:
            assert row["s"] == sum(seen), i
            assert row["mn"] == min(seen) and row["mx"] == max(seen)
            assert row["av"] == (sum(seen) / len(seen)).quantize(
                q6, rounding=decimal.ROUND_HALF_UP)
        else:
            assert row["s"] is None and row["av"] is None
        assert row["lg"] == prev.get(g)
        prev[g] = v


def test_window_sum_narrow_promotes_like_agg(_wide_decimal_context):
    rng = random.Random(6)
    n = 40
    groups = [rng.randrange(3) for _ in range(n)]
    vals = [None if i % 9 == 0 else
            decimal.Decimal(rng.randint(-10 ** 10, 10 ** 10)).scaleb(-2)
            for i in range(n)]
    rb = pa.record_batch({"g": pa.array(groups, pa.int64()),
                          "o": pa.array(list(range(n)), pa.int64()),
                          "d": pa.array(vals, pa.decimal128(12, 2))})
    op, got = _dec_run(rb, [
        WindowFunctionSpec("agg", "sum", arg=C(2)),
        WindowFunctionSpec("agg", "sum", arg=C(2), frame=(-2, 0))],
        ["s", "fs"], capacity=64)
    for name in ("s", "fs"):
        f = op.schema()[op.schema().index_of(name)]
        assert (f.precision, f.scale) == (22, 2)
    state, hist = {}, {}
    for i in range(n):
        g, v = groups[i], vals[i]
        row = got.iloc[i]
        seen = state.setdefault(g, [])
        h = hist.setdefault(g, [])
        h.append(v)
        if v is not None:
            seen.append(v)
        assert row["s"] == (sum(seen) if seen else None), i
        win = [x for x in h[-3:] if x is not None]
        assert row["fs"] == (sum(win) if win else None), i


def test_rows_frame_sum_128bit_no_wrap():
    """Forty 9.2e15 values: the running prefix passes 2^63 in cents, the
    frames of eleven rows stay exact on the limbs."""
    n = 40
    big = decimal.Decimal("9200000000000000.00")
    rb = pa.record_batch({"g": pa.array([1] * n, pa.int64()),
                          "o": pa.array(list(range(n)), pa.int64()),
                          "d": pa.array([big] * n, pa.decimal128(18, 2))})
    _op, got = _dec_run(rb, [WindowFunctionSpec(
        "agg", "sum", arg=C(2), frame=(-10, 0))], ["fs"], capacity=64)
    for i in range(n):
        assert got.loc[i, "fs"] == big * min(i + 1, 11), i


def test_rows_frame_sum_wide_input(_wide_decimal_context):
    rng = random.Random(12)
    n = 30
    vals = [None if i % 6 == 5 else
            decimal.Decimal(rng.randint(-10 ** 30, 10 ** 30)).scaleb(-2)
            for i in range(n)]
    rb = pa.record_batch({"g": pa.array([i % 2 for i in range(n)],
                                        pa.int64()),
                          "o": pa.array(list(range(n)), pa.int64()),
                          "d": pa.array(vals, pa.decimal128(38, 2))})
    _op, got = _dec_run(rb, [WindowFunctionSpec(
        "agg", "sum", arg=C(2), frame=(-2, 1))], ["fs"], capacity=32)
    rows = {g: [i for i in range(n) if i % 2 == g] for g in (0, 1)}
    for i in range(n):
        idxs = rows[i % 2]
        j = idxs.index(i)
        win = [vals[idxs[t]] for t in range(max(0, j - 2),
                                           min(len(idxs), j + 2))]
        nn = [v for v in win if v is not None]
        assert got.loc[i, "fs"] == (sum(nn) if nn else None), i


def test_window_sum_overflow_nulls():
    big = decimal.Decimal(9 * 10 ** 37).scaleb(-2)
    rb = pa.record_batch({"g": pa.array([0, 0], pa.int64()),
                          "o": pa.array([0, 1], pa.int64()),
                          "d": pa.array([big, big], pa.decimal128(38, 2))})
    _op, got = _dec_run(rb, [WindowFunctionSpec("agg", "sum", arg=C(2))],
                        ["s"])
    assert got["s"].tolist() == [big, None]


def test_window_avg_decimal_spark_scale():
    vals = [decimal.Decimal("1.00"), decimal.Decimal("2.01"),
            decimal.Decimal("2.00"), None]
    rb = pa.record_batch({"g": pa.array([1, 1, 2, 2], pa.int64()),
                          "o": pa.array([0, 1, 0, 1], pa.int64()),
                          "d": pa.array(vals, pa.decimal128(10, 2))})
    op = WindowOp(TMem([[rb]], tbridge.schema_from_arrow(rb.schema),
                       capacity=8, device="cpu"),
                  [C(0)], [tir.SortOrder(C(1))],
                  [WindowFunctionSpec("agg", "avg", arg=C(2))],
                  output_names=["a"])
    assert op.schema()[op.schema().index_of("a")].scale == 6
    got = collect(op)
    assert got.schema.field("a").type == pa.decimal128(14, 6)
    assert got.column("a").to_pylist() == [
        decimal.Decimal("1.000000"), decimal.Decimal("1.505000"),
        decimal.Decimal("2.000000"), decimal.Decimal("2.000000")]


def test_window_avg_decimal_wide_promotion_matches_aggop():
    from auron_tpu_torch.columnar.schema import DataType
    from auron_tpu_torch.ops.agg import AggOp
    vals = [decimal.Decimal("99999999999999.99"),
            decimal.Decimal("99999999999999.97"),
            decimal.Decimal("3.00"), decimal.Decimal("1.00")]
    rb = pa.record_batch({"g": pa.array([1, 1, 2, 2], pa.int64()),
                          "o": pa.array([0, 1, 0, 1], pa.int64()),
                          "d": pa.array(vals, pa.decimal128(16, 2))})
    sch = tbridge.schema_from_arrow(rb.schema)
    agg = AggOp(TMem([[rb]], sch, capacity=8, device="cpu"), [C(0)],
                [tir.AggFunction("avg", C(2))], mode="complete",
                group_names=["g"], agg_names=["a"], initial_capacity=16)
    f = agg.schema()[agg.schema().index_of("a")]
    assert (f.dtype, f.precision, f.scale) == (DataType.DECIMAL, 20, 6)
    win = WindowOp(TMem([[rb]], sch, capacity=8, device="cpu"),
                   partition_by=[C(0)], order_by=[tir.SortOrder(C(1))],
                   functions=[WindowFunctionSpec("agg", "avg", arg=C(2))],
                   output_names=["a"])
    wf = win.schema()[win.schema().index_of("a")]
    assert (wf.dtype, wf.precision, wf.scale) == (DataType.DECIMAL, 20, 6)
    got = collect(win)
    assert got.schema.field("a").type == pa.decimal128(20, 6)
    assert got.column("a").to_pylist() == [
        decimal.Decimal("99999999999999.990000"),
        decimal.Decimal("99999999999999.980000"),
        decimal.Decimal("3.000000"), decimal.Decimal("2.000000")]


# ---------------------------------------------------------------------------
# DataFrame.window's bytes and trees
# ---------------------------------------------------------------------------

SCALE, SEED, BATCH_ROWS = 0.1, 7, 1 << 17


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    return rdata.generate(str(tmp_path_factory.mktemp("tpcds_window")),
                          SCALE, SEED)


def _window_frames(dsl, s, files):
    """DataFrames that call ``window`` every way the DSL can: each
    builder, defaults of three types, ROWS frames, a group limit, no
    partition key, one partition and four."""
    col, F = dsl.col, dsl.functions
    df = s.read_parquet(files, partitions=4)
    one = s.read_parquet(files[:1])
    return {
        "ranks": df.window([F.row_number(), F.rank().alias("r"),
                            F.dense_rank(), F.percent_rank(),
                            F.cume_dist(), F.ntile(4)],
                           partition_by=["ss_store_sk"],
                           order_by=[col("ss_net_paid").desc(),
                                     "ss_item_sk"]),
        "offsets": df.window(
            [F.lead(col("ss_quantity"), 2, default=-1).alias("ld"),
             F.lag("ss_sales_price", 1, default=0.5),
             F.nth_value(col("ss_item_sk"), 3), F.first_value("ss_item_sk"),
             F.last_value(col("ss_net_paid"))],
            partition_by=[col("ss_store_sk"), "ss_customer_sk"],
            order_by=[col("ss_sold_date_sk").asc(nulls_first=False)]),
        "frames": df.window(
            [F.win_agg("sum", col("ss_net_paid"), frame=(-1, 1)),
             F.win_agg("count_star", frame=(-3, 0)),
             F.win_agg("avg", col("ss_quantity")),
             F.win_agg("max", col("ss_net_paid"))],
            partition_by=["ss_item_sk"], order_by=["ss_sold_date_sk"],
            group_limit=5),
        "global": df.window([F.rank()], order_by=["ss_net_paid"]),
        "one_partition": one.window([F.row_number()],
                                    partition_by=["ss_store_sk"]),
    }


@pytest.fixture(scope="module")
def frames(data):
    rs = RSession(config=rcfg.AuronConfig({rcfg.SCAN_BATCH_ROWS: BATCH_ROWS}))
    ts = TSession(config=tcfg.AuronConfig({tcfg.SCAN_BATCH_ROWS: BATCH_ROWS}),
                  device="cpu")
    files = data["store_sales"]
    return (rs, ts, _window_frames(rdf, rs, files),
            _window_frames(tdf, ts, files))


@pytest.mark.parametrize("name", ["ranks", "offsets", "frames", "global",
                                  "one_partition"])
def test_window_task_bytes_and_tree_equal_reference(name, frames):
    rs, _ts, ref, port = frames
    data = port[name].task_bytes()
    assert data == ref[name].task_bytes()
    assert port[name].num_partitions == ref[name].num_partitions
    assert port[name].partitioning == ref[name].partitioning
    assert [(f.name, f.dtype.value, f.nullable, f.precision, f.scale)
            for f in port[name].schema] == \
        [(f.name, f.dtype.value, f.nullable, f.precision, f.scale)
         for f in ref[name].schema]
    _same_tree(plan_from_bytes(data, PlannerContext(device="cpu")),
               rplan_from_bytes(data, rs.ctx))


def test_window_validates_like_reference(frames):
    _rs, ts, _ref, port = frames
    df = port["one_partition"]
    with pytest.raises(ValueError, match="group_limit"):
        df.window([tdf.functions.rank()], group_limit=0)
    with pytest.raises(TypeError, match="literal"):
        df.window([tdf.functions.lead("ss_quantity",
                                      default=tdf.col("ss_item_sk"))])
    with pytest.raises(NotImplementedError, match="frames"):
        df.window([tdf.functions.win_agg("min", tdf.col("ss_quantity"),
                                         frame=(-1, 0))])
