"""The port's hash join and broadcast exchange against the JAX package's,
on the CPU.

The same seeded numpy batches go to both packages' ``HashJoinOp``:

- the 7 join types, with ``auron.hashtable.enabled`` on (the hash-run
  index, "ht") and off (two binary searches, "sorted");
- int64 keys with nulls and duplicate build keys; float64 keys with
  NaN, -0.0 and 0.0; two keys (int64 and int32); a wide decimal(25,2)
  key (two limbs, values that share a limb) and a narrow decimal(12,2)
  key with an int64 beside it; one probe batch and
  three (one of them empty); a build side of two batches (concatenated)
  and one with no batch; a probe side whose only batch has no rows.

Every output batch has the reference's row count, its live rows are
the reference's in the same order (float bits compared), and the
``dispatch_ht_index`` / ``dispatch_searchsorted`` counter is the
reference's. ``BroadcastExchangeOp`` replays the reference's batches to
every consumer partition, after running its child once per input
partition. ``pairwise_eq`` and ``null_column_for_field`` equal the
reference's. What the port does not join yet raises.

There is no tolerance anywhere here: every comparison is exact.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auron_tpu import config as rcfg
from auron_tpu.columnar.batch import DeviceBatch as JBatch
from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.columnar.decimal128 import Decimal128Column as JDec
from auron_tpu.columnar.schema import DataType as JDT
from auron_tpu.columnar.schema import Field as JField
from auron_tpu.columnar.schema import Schema as JSchema
from auron_tpu.exprs import eval as jeval
from auron_tpu.exprs import ir as rir
from auron_tpu.io.parquet import DeviceBatchScanOp as RScan
from auron_tpu.ops import hashing as rhashing
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.ops.joins import HashJoinOp as RJoin
from auron_tpu.parallel.exchange import BroadcastExchangeOp as RBroadcast
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.io.parquet import DeviceBatchScanOp as TScan
from auron_tpu_torch.ops import hashing as thashing
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.ops.base import PhysicalOp, yields_owned_batches
from auron_tpu_torch.ops.joins import JOIN_TYPES
from auron_tpu_torch.ops.joins import HashJoinOp as TJoin
from auron_tpu_torch.parallel.exchange import BroadcastExchangeOp as TBroadcast

REF = SimpleNamespace(ir=rir, DT=JDT, Field=JField, Schema=JSchema,
                      Scan=RScan, Join=RJoin, Broadcast=RBroadcast, Ctx=RCtx,
                      cfg=rcfg)
PORT = SimpleNamespace(ir=tir, DT=TDT, Field=TField, Schema=TSchema,
                       Scan=lambda parts, schema: TScan(parts, schema,
                                                        device="cpu"),
                       Join=TJoin, Broadcast=TBroadcast, Ctx=TCtx, cfg=tcfg)

CAP = 16


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# ---------------------------------------------------------------------------
# the data: (key columns, payload) per side, as numpy
# ---------------------------------------------------------------------------

#: per key case: the key columns' names and dtypes
KEYS = {"int64": (("k", "int64"),),
        "float64": (("k", "float64"),),
        "two_keys": (("k", "int64"), ("j", "int32")),
        "dec_wide": (("k", "dec25"),),
        "dec_narrow": (("k", "dec12"), ("j", "int64"))}

#: decimal key types: (precision, scale)
_DEC_KEYS = {"dec25": (25, 2), "dec12": (12, 2)}

#: wide key values: pairs that share the high or the low limb, the
#: limb edges, negatives
_WIDE_POOL = [2 ** 64 - 1, 2 ** 64, -(2 ** 64), -1, 10 ** 24 + 3,
              10 ** 24 + 2 ** 64 + 3, -(10 ** 24), 7]


def _key_values(dtype: str, n: int, rng, build: bool):
    if dtype == "float64":
        return rng.choice([np.nan, -0.0, 0.0, 1.5, 2.5, 3.5], n)
    if dtype == "dec25":
        pick = rng.integers(0, len(_WIDE_POOL) if build else 6, n)
        hi, lo, _ = D.limbs_from_ints([_WIDE_POOL[i] for i in pick], n)
        return hi, lo
    if dtype == "dec12":
        return rng.integers(-3, 8 if build else 6, n) * 10 ** 9 + 1
    # build keys reach past the probe's: some build rows match nothing
    return rng.integers(0, 8 if build else 6, n).astype(dtype)


def _side(case: str, rows: list[int], seed: int, build: bool) -> list:
    """Per batch, ``[(data, validity), ...]`` padded to CAP rows and its
    row count: the key columns (20% null), then a payload column."""
    rng = np.random.default_rng(seed)
    out = []
    for n in rows:
        cols = []
        for _name, dt in KEYS[case]:
            v = _key_values(dt, CAP, rng, build)
            ok = rng.random(CAP) > 0.2
            cols.append(v + (ok,) if isinstance(v, tuple) else (v, ok))
        payload = (rng.integers(0, 100, CAP).astype(np.int64) if build
                   else rng.normal(size=CAP))
        cols.append((payload, rng.random(CAP) > 0.1))
        out.append((cols, n))
    return out


def _schema(ns, case: str, build: bool):
    fields = [ns.Field(("b_" if build else "p_") + name, ns.DT.DECIMAL,
                       True, *_DEC_KEYS[dt]) if dt in _DEC_KEYS
              else ns.Field(("b_" if build else "p_") + name,
                            getattr(ns.DT, dt.upper()))
              for name, dt in KEYS[case]]
    fields.append(ns.Field("b_v" if build else "p_v",
                           ns.DT.INT64 if build else ns.DT.FLOAT64))
    return ns.Schema(tuple(fields))


def _batches(ns, side: list) -> list:
    if ns is REF:
        return [JBatch(tuple(JDec(*map(jnp.asarray, c)) if len(c) == 3
                             else JCol(*map(jnp.asarray, c)) for c in cols),
                       jnp.asarray(n, jnp.int32))
                for cols, n in side]
    return [batch_from_numpy(cols, n, "cpu") for cols, n in side]


#: per case: (key case, probe batches' row counts, build's)
CASES = {
    "int64-1_batch": ("int64", [13], [11, 14]),
    "int64-3_batches": ("int64", [13, 0, 16], [11, 14]),
    "float64-3_batches": ("float64", [16, 9, 0], [12, 15]),
    "two_keys-1_batch": ("two_keys", [14], [16, 10]),
    "empty_build": ("int64", [13, 7], []),
    "empty_probe": ("int64", [0], [11, 14]),
    "dec_wide-3_batches": ("dec_wide", [13, 0, 16], [11, 14]),
    "dec_narrow-1_batch": ("dec_narrow", [14], [16, 10]),
}


def _join(ns, case: str, how: str):
    key_case, probe_rows, build_rows = CASES[case]
    n_keys = len(KEYS[key_case])
    probe = ns.Scan([_batches(ns, _side(key_case, probe_rows, 1, False))],
                    _schema(ns, key_case, False))
    build = ns.Scan([_batches(ns, _side(key_case, build_rows, 2, True))],
                    _schema(ns, key_case, True))
    keys = [ns.ir.ColumnRef(i) for i in range(n_keys)]
    return ns.Join(probe, build, keys, keys, how)


def _run(ns, op, hashtable: bool):
    """Each output batch as ([(data, validity)] of its live rows, row
    count), and the join's dispatch counters."""
    ctx = ns.Ctx(config=ns.cfg.AuronConfig(
        {ns.cfg.HASHTABLE_ENABLED: hashtable}))
    out = []
    for b in op.execute(0, ctx):
        n = int(b.num_rows)
        out.append(([(np.stack([np.asarray(c.hi), np.asarray(c.lo)], 1)[:n]
                      if hasattr(c, "hi") else np.asarray(c.data)[:n],
                      np.asarray(c.validity)[:n]) for c in b.columns], n))
    counters = {k: v for k, v in ctx.metrics_for("hash_join")
                .snapshot().items() if k.startswith("dispatch_")}
    return out, counters


def _bits(d: np.ndarray) -> np.ndarray:
    return d.view(np.int64) if d.dtype == np.float64 else d


@pytest.mark.parametrize("index", ["ht", "sorted"])
@pytest.mark.parametrize("how", JOIN_TYPES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_hash_join_matches_reference(case, how, index):
    want, want_c = _run(REF, _join(REF, case, how), index == "ht")
    got, got_c = _run(PORT, _join(PORT, case, how), index == "ht")
    assert got_c == want_c
    if CASES[case][2]:
        key = "dispatch_ht_index" if index == "ht" else \
            "dispatch_searchsorted"
        assert got_c == {key: 1}
    assert [n for _c, n in got] == [n for _c, n in want]
    for (gcols, _n), (wcols, _m) in zip(got, want):
        assert len(gcols) == len(wcols)
        for (gd, gv), (wd, wv) in zip(gcols, wcols):
            np.testing.assert_array_equal(gv, wv)
            np.testing.assert_array_equal(_bits(gd[gv]), _bits(wd[wv]))


def test_joins_emit_rows_on_every_path():
    """The cases are not vacuous: inner finds pairs, anti keeps rows,
    right emits unmatched build rows, and the float keys match NaN with
    NaN and -0.0 with 0.0."""
    got, _c = _run(PORT, _join(PORT, "float64-3_batches", "inner"), True)
    # the probe key (column 0) and the build key (column 2) of each pair
    pk, bk = (np.concatenate([cols[i][0] for cols, _n in got])
              for i in (0, 2))
    assert (np.isnan(pk) & np.isnan(bk)).any()
    assert ((pk == 0.0) & (np.signbit(pk) != np.signbit(bk))).any()
    for case, how in (("int64-3_batches", "anti"),
                      ("int64-1_batch", "right")):
        got, _c = _run(PORT, _join(PORT, case, how), False)
        assert sum(n for _c, n in got) > 0


# ---------------------------------------------------------------------------
# the broadcast exchange
# ---------------------------------------------------------------------------

def _broadcast(ns):
    """A broadcast over 2 input partitions, and the partitions its
    child was executed for."""
    parts = [_batches(ns, _side("int64", [13, 16], 3, True)),
             _batches(ns, _side("int64", [5], 4, True))]
    scan = ns.Scan(parts, _schema(ns, "int64", True))
    calls, execute = [], scan.execute

    def counted(partition, ctx):
        calls.append(partition)
        return execute(partition, ctx)

    scan.execute = counted
    return ns.Broadcast(scan, input_partitions=2), calls


def test_broadcast_exchange_replays_reference_batches():
    """2 input partitions replayed to 3 consumers: each consumer gets the
    reference's batches, the same objects each time, and the child ran
    once per input partition."""
    (rop, rcalls), (top, tcalls) = _broadcast(REF), _broadcast(PORT)
    ctx_r, ctx_t = RCtx(num_partitions=3), TCtx(num_partitions=3)
    seen = []
    for p in range(3):
        want = list(rop.execute(p, ctx_r))
        got = list(top.execute(p, ctx_t))
        assert [int(b.num_rows) for b in got] == \
            [int(b.num_rows) for b in want] == [13, 16, 5]
        for g, w in zip(got, want):
            for gc, wc in zip(g.columns, w.columns):
                np.testing.assert_array_equal(gc.data.numpy(),
                                              np.asarray(wc.data))
                np.testing.assert_array_equal(gc.validity.numpy(),
                                              np.asarray(wc.validity))
        seen.append(got)
    assert all(a is b for a, b in zip(seen[0], seen[2]))
    assert tcalls == rcalls == [0, 1]
    assert not yields_owned_batches(top)
    assert ctx_t.metrics_for("broadcast_exchange").snapshot()[
        "output_rows"] == 3 * 34


# ---------------------------------------------------------------------------
# pieces, and what raises
# ---------------------------------------------------------------------------

def test_pairwise_eq_matches_reference():
    v = np.array([np.nan, -0.0, 0.0, 1.5, np.nan, 2.0])
    w = np.array([0.0, 0.0, -0.0, 1.5, np.nan, np.inf])
    pi = np.array([0, 1, 2, 3, 4, 5, 0, 5])
    bi = np.array([4, 0, 1, 3, 4, 5, 2, 1])
    ok = np.ones(6, bool)
    want = rhashing.pairwise_eq(JCol(jnp.asarray(v), jnp.asarray(ok)),
                                jnp.asarray(pi),
                                JCol(jnp.asarray(w), jnp.asarray(ok)),
                                jnp.asarray(bi))
    got = thashing.pairwise_eq(TCol(torch.from_numpy(v), torch.from_numpy(ok)),
                               torch.from_numpy(pi),
                               TCol(torch.from_numpy(w), torch.from_numpy(ok)),
                               torch.from_numpy(bi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.numpy().tolist() == [True, True, True, True, True, False,
                                    False, False]


def test_decimal_joins_match_wide_keys_by_both_limbs():
    """The wide cases are not vacuous: inner pairs keys that share one
    limb only with nothing, and matches equal keys."""
    got, _c = _run(PORT, _join(PORT, "dec_wide-3_batches", "inner"), True)
    pk, bk = (np.concatenate([cols[i][0] for cols, _n in got])
              for i in (0, 2))
    assert len(pk) > 0 and (pk == bk).all()


def test_null_decimal_columns_match_reference():
    for p in (12, 25):
        want = jeval.null_column_for_field(JField("f", JDT.DECIMAL, True, p,
                                                  2), 5)
        got = teval.null_column_for_field(TField("f", TDT.DECIMAL, True, p,
                                                 2), 5, torch.device("cpu"))
        assert type(got).__name__ == type(want).__name__
        assert not got.validity.numpy().any()


@pytest.mark.parametrize("dtype", ["BOOL", "INT8", "INT32", "INT64",
                                   "FLOAT32", "FLOAT64", "DATE32",
                                   "TIMESTAMP_US"])
def test_null_column_for_field_matches_reference(dtype):
    want = jeval.null_column_for_field(JField("f", getattr(JDT, dtype)), 5)
    got = teval.null_column_for_field(TField("f", getattr(TDT, dtype)), 5,
                                      torch.device("cpu"))
    assert got.data.numpy().dtype == np.asarray(want.data).dtype
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert not got.validity.numpy().any() and not np.asarray(
        want.validity).any()


def test_unported_joins_raise():
    class _Structs(PhysicalOp):
        def schema(self):
            return TSchema((TField("d", TDT.STRUCT),))

    with pytest.raises(NotImplementedError, match="16f"):
        TJoin(_Structs(), _Structs(), [tir.ColumnRef(0)],
              [tir.ColumnRef(0)])
    with pytest.raises(ValueError, match="cross"):
        _join(PORT, "int64-1_batch", "cross")
    op = _join(PORT, "int64-1_batch", "inner")
    with pytest.raises(NotImplementedError, match="memory manager"):
        op.execute(0, TCtx(mem_manager=object()))
    bc, _calls = _broadcast(PORT)
    with pytest.raises(NotImplementedError, match="memory manager"):
        bc.execute(0, TCtx(mem_manager=object()))
