"""The port's device hash table against the JAX package's.

The same seeded numpy inputs go to ``auron_tpu.hashtable`` and to
``auron_tpu_torch.hashtable`` (CPU tensors). Hashes and key words cross
as int64 bit patterns of the reference's uint64.

Tolerances: claims, slots, resolved rows, slot order, stored keys,
group validity, exported hash order and hashes, join-index payloads and
every integer, min, max, first, or and count accumulator are identical;
float64 sums agree within a relative 1e-12 of the key's sum of |v|.
Decimal keys: a wide column's three words (validity, high limb, low
limb) and hashes, and a ``HashAggState`` keyed on a wide and a narrow
decimal (slots, stored limbs, export order) are the reference's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.hashtable import agg as jagg
from auron_tpu.hashtable import core as jcore
from auron_tpu.hashtable import table as jtable
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.hashtable import agg as tagg
from auron_tpu_torch.hashtable import core as tcore
from auron_tpu_torch.hashtable import table as ttable

F64_REL_TOL = 1e-12
I64 = np.iinfo(np.int64)


def _i64(a) -> np.ndarray:
    """The reference's uint64 array as int64 bits."""
    return np.asarray(a).view(np.int64)


def _cols(specs):
    """(JAX columns, port columns) from (data, validity) numpy pairs."""
    j = tuple(JCol(jnp.asarray(d), jnp.asarray(v)) for d, v in specs)
    t = tuple(TCol(torch.from_numpy(np.ascontiguousarray(d)),
                   torch.from_numpy(np.ascontiguousarray(v)))
              for d, v in specs)
    return j, t


def _bits(a) -> np.ndarray:
    """Float arrays as their bits (NaN and -0.0 compared exactly)."""
    a = np.asarray(a)
    if a.dtype.kind == "f":
        return a.view(np.int64 if a.itemsize == 8 else np.int32)
    return a


# ---------------------------------------------------------------------------
# insert_loop and the codec
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,n_keys,cap", [(8192, 2048, 4096),
                                          (20000, 15000, 1 << 15),
                                          (8192, 8000, 8192)])
def test_insert_loop_claims_slots_resolved_identical(n, n_keys, cap):
    rng = np.random.default_rng(n_keys)
    k = rng.integers(0, n_keys, n).astype(np.int64)
    live = rng.random(n) > 0.1
    jc, tc = _cols([(k, np.ones(n, bool))])
    h = jagg._hashes(jc, n)
    w = jcore.key_words(jc, jcore.key_meta(jc))
    want = jax.jit(jcore.insert_loop, static_argnums=(5,))(
        jnp.full(cap, jcore.EMPTY, jnp.uint64),
        jnp.zeros((cap, 2), jnp.uint64), h, w, jnp.asarray(live), 64)

    th = tagg._hashes(tc, n)
    tw = tcore.key_words(tc, tcore.key_meta(tc))
    np.testing.assert_array_equal(th.numpy(), _i64(h))
    np.testing.assert_array_equal(tw.numpy().T, _i64(w))   # word-major
    before = tcore.insert_loop.rounds
    got = tcore.insert_loop(
        torch.full((cap,), tcore.EMPTY, dtype=torch.int64),
        torch.zeros((2, cap), dtype=torch.int64), th, tw,
        torch.from_numpy(live), 64)
    # the inputs need chains longer than the full rounds: the tail runs
    assert tcore.insert_loop.rounds - before > 2
    for g, wnt in zip(got, want):
        assert g.numpy().dtype == np.asarray(wnt).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(wnt))
    assert bool(got[2].sum() == int(live.sum()))


KEY_WORD_CASES = {
    "int64": np.array([0, 1, -1, I64.min, I64.max, 42]),
    "int32": np.array([0, 1, -1, -2**31, 2**31 - 1, 7], np.int32),
    "int8": np.array([0, 1, -1, -128, 127, 3], np.int8),
    "bool": np.array([True, False, True, True, False, False]),
    "float32": np.array([0.0, -0.0, np.nan, -1.5, 1e-45, 3.4e38],
                        np.float32),
    "float64": np.array([0.0, -0.0, np.nan, -1.5, 5e-324, -1.7e308]),
}


@pytest.mark.parametrize("dtype", sorted(KEY_WORD_CASES))
def test_key_words_and_hashes_identical(dtype):
    d = KEY_WORD_CASES[dtype]
    valid = np.array([True, True, True, True, False, True])
    jc, tc = _cols([(d, valid), (d[::-1].copy(), np.ones(6, bool))])
    assert tcore.key_meta(tc) == jcore.key_meta(jc)
    np.testing.assert_array_equal(
        tcore.key_words(tc, tcore.key_meta(tc)).numpy().T,
        _i64(jcore.key_words(jc, jcore.key_meta(jc))))
    np.testing.assert_array_equal(tagg._hashes(tc, 6).numpy(),
                                  _i64(jagg._hashes(jc, 6)))


def test_hash_sentinel_remap():
    h = np.array([0, 5, 0xFFFFFFFFFFFFFFFF, 0xFFFFFFFFFFFFFFFE,
                  1 << 63], np.uint64)
    want = np.asarray(jcore.remap_hashes(jnp.asarray(h)))
    got = tcore.remap_hashes(torch.from_numpy(h.view(np.int64)))
    np.testing.assert_array_equal(got.numpy(), _i64(want))
    assert got[2] == tcore.EMPTY - 1


def test_key_meta_raises_on_a_column_that_is_not_primitive():
    class StringColumn:
        pass

    with pytest.raises(NotImplementedError,
                       match="hashtable keys of StringColumn are not "
                             "supported"):
        tcore.key_meta((StringColumn(),))


# ---------------------------------------------------------------------------
# grouped_agg_once (the hash twin's body)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("key_dtype", ["int64", "float32"])
def test_grouped_agg_once_slot_order_identical(key_dtype):
    rng = np.random.default_rng(3)
    n, cap = 8192, 8192
    k = rng.integers(-1500, 1500, n).astype(key_dtype)
    kv = rng.random(n) > 0.05
    live = rng.random(n) > 0.2
    v = rng.normal(size=n)
    vv = rng.random(n) > 0.05
    sums_in = np.where(vv & live, v, 0.0)
    cnt_in = (vv & live).astype(np.int32)
    jc, tc = _cols([(k, kv)])
    want = jax.jit(lambda c, s, ct, lv: jagg.grouped_agg_once(
        c, (s, ct), ("sum", "sum"), lv, cap))(
        jc, jnp.asarray(sums_in), jnp.asarray(cnt_in), jnp.asarray(live))
    got = tagg.grouped_agg_once(
        tc, (torch.from_numpy(sums_in), torch.from_numpy(cnt_in)),
        ("sum", "sum"), torch.from_numpy(live), cap)
    (wcols, (wsum, wcnt), wng, wvalid) = want
    (gcols, (gsum, gcnt), gng, gvalid) = got
    null = live & ~kv
    assert int(gng) == int(wng) == np.unique(k[live & kv]).size + null.any()
    np.testing.assert_array_equal(gvalid.numpy(), np.asarray(wvalid))
    np.testing.assert_array_equal(_bits(gcols[0].data.numpy()),
                                  _bits(wcols[0].data))
    np.testing.assert_array_equal(gcols[0].validity.numpy(),
                                  np.asarray(wcols[0].validity))
    np.testing.assert_array_equal(gcnt.numpy(), np.asarray(wcnt))
    assert gcnt.dtype == torch.int32 and gsum.dtype == torch.float64
    # per slot: the sum of |v| over the rows of its key
    abs_by_key = {}
    for key, ok, val in zip(k[live], kv[live], np.abs(sums_in[live])):
        key = (bool(ok), key if ok else 0)
        abs_by_key[key] = abs_by_key.get(key, 0.0) + val
    scale = np.array([abs_by_key.get((bool(ok), key if ok else 0), 0.0)
                      for key, ok in zip(gcols[0].data.numpy(),
                                         gcols[0].validity.numpy())])
    assert np.all(np.abs(gsum.numpy() - np.asarray(wsum))
                  <= F64_REL_TOL * scale)


# ---------------------------------------------------------------------------
# HashAggState: the differential battery of tests/test_hashtable.py on
# primitive keys, state against state
# ---------------------------------------------------------------------------

#: (kind, contribution) per accumulator from int64 values and validity
ACCS = {
    "sum": ("sum", lambda v, ok: np.where(ok, v, 0)),
    "count": ("sum", lambda v, ok: ok.astype(np.int64)),
    "min": ("min", lambda v, ok: np.where(ok, v, I64.max)),
    "max": ("max", lambda v, ok: np.where(ok, v, I64.min)),
    "first": ("first", lambda v, ok: v),
    "or": ("or", lambda v, ok: ok & (v > 0)),
    "fsum": ("sum", lambda v, ok: np.where(ok, v * 0.37, 0.0)),
}
ALL = ("sum", "count", "min", "max", "first", "or", "fsum")


def _battery_case(name):
    """(keys (data, validity), values, validity, accs, rows per batch,
    initial capacity)."""
    rng = np.random.default_rng(sorted(BATTERY).index(name))
    if name == "int64_keys_with_nulls_duplicate_heavy":
        n = 1536
        keys = (rng.integers(0, 40, n), rng.random(n) >= 0.1)
        per, cap0, accs = 64, 64, ALL
    elif name == "all_distinct_keys":
        n = 512
        keys = (np.arange(n), np.ones(n, bool))
        per, cap0, accs = 64, 1024, ALL
    elif name in ("float64_keys_nan_negzero", "float32_keys_nan_negzero"):
        n = 768
        pool = np.array([0.0, -0.0, np.nan, 1.5, -1.5, 2.25],
                        name[:7])
        keys = (pool[rng.integers(0, len(pool), n)], rng.random(n) >= 0.15)
        per, cap0, accs = 256, 64, ALL
    elif name == "forced_growth_from_16":
        # the int64 cases share batch and table shapes, so the reference
        # compiles each of its programs once for all of them
        n = 128
        keys = (rng.permutation(n), np.ones(n, bool))
        per, cap0, accs = 64, 16, ALL
    elif name == "first_over_batches":
        n = 512
        keys = (np.arange(n) % 7, np.ones(n, bool))
        return keys, np.arange(n), np.ones(n, bool), ("first",), 32, 64
    elif name == "distinct_no_aggs":
        n = 384
        keys = (rng.integers(0, 64, n), rng.random(n) >= 0.1)
        per, cap0, accs = 64, 256, ()
    else:
        raise ValueError(name)
    values = rng.integers(-1000, 1000, n)
    return keys, values, rng.random(n) >= 0.2, accs, per, cap0


BATTERY = ["int64_keys_with_nulls_duplicate_heavy", "all_distinct_keys",
           "float64_keys_nan_negzero", "float32_keys_nan_negzero",
           "forced_growth_from_16", "first_over_batches",
           "distinct_no_aggs"]


def _live(n, per):
    """Live rows: the last row of every batch but each third is dead."""
    live = np.ones(n, bool)
    live[per - 1::per] = np.arange(0, n, per) % 3 != 0
    return live


def _groups(keys, live) -> int:
    """Distinct live keys under Spark key equality (NULL one group, NaN
    == NaN, -0.0 == 0.0)."""
    d, v = keys
    return len({"null" if not ok else "nan" if x != x else x + 0.0
                for x, ok in zip(d[live].tolist(), v[live])})


def _run_states(keys, values, ok, accs, per, cap0):
    """Both states over the same batches; returns (JAX, port) states."""
    kinds = tuple(ACCS[a][0] for a in accs)
    js = jagg.HashAggState(kinds, initial_capacity=cap0)
    ts = tagg.HashAggState(kinds, initial_capacity=cap0)
    n = values.size
    live_all = _live(n, per)
    for lo in range(0, n, per):
        sl = slice(lo, lo + per)
        jc, tc = _cols([(keys[0][sl], keys[1][sl])])
        contribs = [ACCS[a][1](values[sl], ok[sl]) for a in accs]
        live = live_all[sl]
        js.update(jc, [jnp.asarray(c) for c in contribs], jnp.asarray(live))
        ts.update(tc, [torch.from_numpy(c) for c in contribs],
                  torch.from_numpy(live))
    return js, ts


@pytest.mark.parametrize("name", BATTERY)
def test_hash_agg_state_matches_reference(name):
    keys, values, ok, accs, per, cap0 = _battery_case(name)
    js, ts = _run_states(keys, values, ok, accs, per, cap0)
    assert (ts.cap, ts.count, ts.rows_seen) == (js.cap, js.count,
                                                js.rows_seen)
    assert ts.nbytes() == js.nbytes()
    if name == "forced_growth_from_16":
        assert ts.cap >= 256           # four doublings or more
    wcols, waccs, wng, wcap, wh = js.to_sorted_table()
    gcols, gaccs, gng, gcap, gh = ts.to_sorted_table()
    assert int(gng) == int(wng) == _groups(keys, _live(values.size, per))
    assert gcap == wcap
    np.testing.assert_array_equal(gh.numpy(), _i64(wh))
    for g, w in zip(gcols, wcols):
        np.testing.assert_array_equal(_bits(g.data.numpy()), _bits(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
    for a, g, w in zip(accs, gaccs, waccs):
        w = np.asarray(w)
        assert g.numpy().dtype == w.dtype, a
        if a == "fsum":
            scale = np.abs(w) + 1.0
            assert np.all(np.abs(g.numpy() - w) <= F64_REL_TOL * scale), a
        else:
            np.testing.assert_array_equal(g.numpy(), w, err_msg=a)
    if name == "first_over_batches":
        ng = int(gng)
        got = dict(zip(gcols[0].data[:ng].tolist(),
                       gaccs[0][:ng].tolist()))
        assert got == {i: i for i in range(7)}   # first occurrence


def test_to_sorted_table_orders_hashes_as_unsigned():
    n = 300
    keys = (np.arange(n) * 7919, np.ones(n, bool))
    js, ts = _run_states(keys, np.arange(n), np.ones(n, bool), ("sum",),
                         n, 1024)
    gh = ts.to_sorted_table()[4].numpy()
    np.testing.assert_array_equal(gh, _i64(js.to_sorted_table()[4]))
    live = gh[:n]
    assert (live < 0).any() and (live >= 0).any()   # hashes >= 2^63 too
    u = live.view(np.uint64)
    assert np.all(u[1:] >= u[:-1])
    assert np.all(gh[n:] == tcore.EMPTY)


def test_overflow_raises_where_the_reference_does(monkeypatch):
    """40 keys cannot fit 32 slots, and growth stops at a capacity of
    32: both raise before committing the batch."""
    monkeypatch.setattr(jagg, "_MAX_CAPACITY", 32)
    monkeypatch.setattr(tagg, "_MAX_CAPACITY", 32)
    n = 40
    jc, tc = _cols([(np.arange(n), np.ones(n, bool))])
    v = np.arange(n)
    states = (
        (jagg, jc, jnp.asarray(v), jnp.ones(n, bool)),
        (tagg, tc, torch.from_numpy(v), torch.ones(n, dtype=torch.bool)))
    for mod, cols, vals, live in states:
        st = mod.HashAggState(("sum",), 16, max_probe_rounds=1)
        with pytest.raises(mod.HashTableOverflow):
            st.update(cols, [vals], live)
        # the empty table grew once, then the batch overflowed at the wall
        assert (st.count, st.rows_seen, st.cap) == (0, 0, 32)


# ---------------------------------------------------------------------------
# DeviceHashTable and the join index
# ---------------------------------------------------------------------------

def test_device_hash_table_insert_probe_and_growth_remap():
    rng = np.random.default_rng(11)
    jt, tt = jtable.DeviceHashTable(128), ttable.DeviceHashTable(128)
    assert [a.tolist() for a in tt.probe(
        (TCol(torch.zeros(4, dtype=torch.int64),
              torch.ones(4, dtype=torch.bool)),),
        torch.ones(4, dtype=torch.bool))] == [[0] * 4, [False] * 4]
    for step in range(2):
        n = 256
        k = rng.integers(0, 700, n).astype(np.int64)
        jc, tc = _cols([(k, rng.random(n) > 0.05)])
        live = rng.random(n) > 0.1
        w_slot, w_new = jt.insert(jc, jnp.asarray(live))
        g_slot, g_new = tt.insert(tc, torch.from_numpy(live))
        np.testing.assert_array_equal(g_slot.numpy(), np.asarray(w_slot))
        np.testing.assert_array_equal(g_new.numpy(), np.asarray(w_new))
        assert (tt.count, tt.cap) == (jt.count, jt.cap)
        assert tt.last_remap is not None, step     # grew in every insert
        assert tt.last_remap[0] == jt.last_remap[0]
        for g, w in zip(tt.last_remap[1:], jt.last_remap[1:]):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        for g, w in zip(tt.keys_columns(), jt.keys_columns()):
            np.testing.assert_array_equal(g.data.numpy(),
                                          np.asarray(w.data))
            np.testing.assert_array_equal(g.validity.numpy(),
                                          np.asarray(w.validity))
    # probe present, absent (700..) and dead rows
    k = rng.integers(0, 900, 256).astype(np.int64)
    jc, tc = _cols([(k, rng.random(256) > 0.05)])
    live = rng.random(256) > 0.1
    w_slot, w_found = jt.probe(jc, jnp.asarray(live))
    g_slot, g_found = tt.probe(tc, torch.from_numpy(live))
    np.testing.assert_array_equal(g_slot.numpy(), np.asarray(w_slot))
    np.testing.assert_array_equal(g_found.numpy(), np.asarray(w_found))
    assert g_found.any() and not g_found.all()


@pytest.mark.parametrize("rounds", [64, 1])
def test_join_index_matches_reference_and_searchsorted(rounds):
    rng = np.random.default_rng(12 + rounds)
    n = 512
    jc, tc = _cols([(rng.integers(0, 150, n), np.ones(n, bool))])
    h_sorted = np.sort(np.asarray(jagg._hashes(jc, n)))   # as uint64
    want = jtable.build_join_index(jnp.asarray(h_sorted), rounds)
    got = ttable.build_join_index(torch.from_numpy(_i64(h_sorted)), rounds)
    assert (got is None) == (want is None)
    if want is None:
        return
    for a in ("th", "lo", "cnt"):
        g, w = getattr(got, a).numpy(), np.asarray(getattr(want, a))
        np.testing.assert_array_equal(g, _i64(w) if a == "th" else w)
    probe = np.concatenate([h_sorted[rng.integers(0, n, 200)],
                            rng.integers(0, 2**63, 50).astype(np.uint64),
                            np.full(4, 0xFFFFFFFFFFFFFFFF, np.uint64)])
    w_lo, w_cnt = want.lookup(jnp.asarray(probe))
    g_lo, g_cnt = got.lookup(torch.from_numpy(_i64(probe)))
    np.testing.assert_array_equal(g_lo.numpy(), np.asarray(w_lo))
    np.testing.assert_array_equal(g_cnt.numpy(), np.asarray(w_cnt))
    left = np.searchsorted(h_sorted, probe, "left")
    cnt = np.searchsorted(h_sorted, probe, "right") - left
    np.testing.assert_array_equal(g_cnt.numpy(), cnt)
    np.testing.assert_array_equal(g_lo.numpy(), np.where(cnt > 0, left, 0))


# ---------------------------------------------------------------------------
# decimal keys
# ---------------------------------------------------------------------------

from auron_tpu.columnar.decimal128 import Decimal128Column as JDec
from auron_tpu_torch.columnar import decimal128 as D


def _dec_key_cols(n: int, seed: int, pool: int):
    """A wide key drawn from ``pool`` 128-bit values (ties, the ±2^63 and
    2^64 - 1 limb edges, nulls) and a narrow int64 key."""
    rng = np.random.default_rng(seed)
    base = [0, -1, 2 ** 63, -(2 ** 63), 2 ** 64 - 1, 10 ** 38 - 1,
            -(10 ** 38 - 1), 2 ** 64] + [
        int(x) * 10 ** 20 + int(y) for x, y in zip(
            rng.integers(-10 ** 9, 10 ** 9, pool),
            rng.integers(-10 ** 9, 10 ** 9, pool))]
    vals = [base[i] for i in rng.integers(0, len(base), n)]
    hi, lo, _ = D.limbs_from_ints(vals, n)
    hv = rng.random(n) >= 0.1
    small = rng.integers(-3, 3, n)
    sv = rng.random(n) >= 0.1
    j = (JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(hv)),
         JCol(jnp.asarray(small), jnp.asarray(sv)))
    t = (D.Decimal128Column(torch.from_numpy(hi), torch.from_numpy(lo),
                            torch.from_numpy(hv)),
         TCol(torch.from_numpy(small), torch.from_numpy(sv)))
    return j, t


def test_decimal_key_words_and_hashes_identical():
    jc, tc = _dec_key_cols(64, 1, 8)
    assert tcore.key_meta(tc) == jcore.key_meta(jc) == (("dec",),
                                                        ("prim", "int64"))
    np.testing.assert_array_equal(
        tcore.key_words(tc, tcore.key_meta(tc)).numpy().T,
        _i64(jcore.key_words(jc, jcore.key_meta(jc))))
    np.testing.assert_array_equal(tagg._hashes(tc, 64).numpy(),
                                  _i64(jagg._hashes(jc, 64)))


@pytest.mark.parametrize("pool", [12, 400])
def test_decimal_keyed_hash_agg_state_matches_reference(pool):
    """Batches of 64 rows keyed on (wide decimal, int64) into a table
    from 16 slots: the table grows; slots, stored keys, export order and
    the sum/count/min accumulators equal the reference's."""
    n, per = 512, 64
    kinds = ("sum", "sum", "min")
    js = jagg.HashAggState(kinds, initial_capacity=16)
    ts = tagg.HashAggState(kinds, initial_capacity=16)
    rng = np.random.default_rng(pool)
    values = rng.integers(-1000, 1000, n)
    ok = rng.random(n) >= 0.2
    jall, tall = _dec_key_cols(n, pool, pool)
    live_all = _live(n, per)
    for lo in range(0, n, per):
        sl = slice(lo, lo + per)
        jk = (JDec(jall[0].hi[sl], jall[0].lo[sl], jall[0].validity[sl]),
              JCol(jall[1].data[sl], jall[1].validity[sl]))
        tk = (D.Decimal128Column(tall[0].hi[sl], tall[0].lo[sl],
                                 tall[0].validity[sl]),
              TCol(tall[1].data[sl], tall[1].validity[sl]))
        contribs = [np.where(ok[sl], values[sl], 0),
                    ok[sl].astype(np.int64),
                    np.where(ok[sl], values[sl], I64.max)]
        live = live_all[sl]
        js.update(jk, [jnp.asarray(c) for c in contribs], jnp.asarray(live))
        ts.update(tk, [torch.from_numpy(c) for c in contribs],
                  torch.from_numpy(live))
    assert (ts.cap, ts.count) == (js.cap, js.count)
    assert ts.cap > 16
    wcols, waccs, wng, wcap, wh = js.to_sorted_table()
    gcols, gaccs, gng, gcap, gh = ts.to_sorted_table()
    assert int(gng) == int(wng) and gcap == wcap
    np.testing.assert_array_equal(gh.numpy(), _i64(wh))
    np.testing.assert_array_equal(gcols[0].hi.numpy(), np.asarray(wcols[0].hi))
    np.testing.assert_array_equal(gcols[0].lo.numpy(), np.asarray(wcols[0].lo))
    np.testing.assert_array_equal(gcols[0].validity.numpy(),
                                  np.asarray(wcols[0].validity))
    np.testing.assert_array_equal(gcols[1].data.numpy(),
                                  np.asarray(wcols[1].data))
    for g, w in zip(gaccs, waccs):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
