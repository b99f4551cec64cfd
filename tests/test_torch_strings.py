"""The port's string columns against the JAX package's, on the CPU.

The same seeded strings (empty strings, nulls, and UTF-8 whose bytes
pass 0x7F: "é", "ü", "日本") go to both packages:

- the Arrow bridge: ``to_device`` of plain, sliced, chunked, dictionary
  and large_string arrays gives the reference's chars, lengths and
  validity; ``fetch_numpy`` / ``to_arrow`` give the input back;
- the column ops: ``gather_column``, ``compact``, ``concat_batches``
  across widths 8, 16 and 32 (the reference's widths unified by hand),
  ``resize``;
- xxhash64 and murmur3 of every length 0–70 at widths 8 to 128, tail
  bytes 0x00–0xFF, nulls, and chained columns;
- the sort: order words ascending and descending, nulls first and last;
  ``SortOp`` over batches of different widths; range bounds and
  partition ids; a full sort through a range exchange that samples its
  own bounds; a batch wider than the sampled bounds lands where its
  padded form does;
- the hash table: ``HashAggState`` and ``DeviceHashTable`` with string
  keys whose width grows mid-stream (8 → 16 → 32): slots, stored keys,
  export order and accumulators;
- AggOp: min, max, first, first_ignores_null and count over strings,
  complete and two-phase, groups keyed by strings on the sort and hash
  paths, all-null groups, and the reference's dispatch reasons;
- expressions: the six comparisons, ``IN`` and ``NOT IN`` with literals
  longer than the column's width;
- joins on string keys (both candidate searches) and string payloads
  through an outer join's null padding; the hash exchange and the
  broadcast exchange over string columns.

There is no tolerance anywhere here: every comparison is exact.
"""

import functools
from types import SimpleNamespace

import numpy as np
import pyarrow as pa
import pytest
import torch

import jax.numpy as jnp

from auron_tpu import config as rcfg
from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.columnar import batch as rbatch
from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.exprs import eval as reval
from auron_tpu.exprs import ir as rir
from auron_tpu.hashtable import agg as rht
from auron_tpu.hashtable import table as rtable
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops import hashing as rhash
from auron_tpu.ops import sort as rsort
from auron_tpu.ops.agg import AggOp as RAgg
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.ops.joins import HashJoinOp as RJoin
from auron_tpu.parallel import partitioning as rpart
from auron_tpu.parallel.exchange import BroadcastExchangeOp as RBroadcast
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu_torch import config as tcfg
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar import batch as tbatch
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.hashtable import agg as tht
from auron_tpu_torch.hashtable import table as ttable
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ops import hashing as thash
from auron_tpu_torch.ops import sort as tsort
from auron_tpu_torch.ops.agg import AggOp as TAgg
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.ops.joins import HashJoinOp as TJoin
from auron_tpu_torch.parallel import partitioning as tpart
from auron_tpu_torch.parallel.exchange import BroadcastExchangeOp as TBroadcast
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle

REF = SimpleNamespace(ir=rir, bridge=rbridge, batch=rbatch, Mem=RMem,
                      Ctx=RCtx, cfg=rcfg, Agg=RAgg, Join=RJoin,
                      Shuffle=RShuffle, Broadcast=RBroadcast, part=rpart,
                      sort=rsort, eval=reval)
PORT = SimpleNamespace(ir=tir, bridge=tbridge, batch=tbatch,
                       Mem=functools.partial(TMem, device="cpu"), Ctx=TCtx,
                       cfg=tcfg, Agg=TAgg, Join=TJoin, Shuffle=TShuffle,
                       Broadcast=TBroadcast, part=tpart, sort=tsort,
                       eval=teval)

#: values whose UTF-8 bytes pass 0x7F, and ASCII around them
WORDS = ["", "a", "A", "é", "ü", "日本", "Books", "Music", "Shoes",
         "Electronics", "zz", "éa", "Zebra", "a" * 7, "b" * 9]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Several test workers share the CPU: one torch thread each."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _strings(n: int, seed: int, max_len: int = 20, nulls=0.15) -> list:
    """Seeded strings: WORDS, and random ASCII and Latin-1 letters up to
    ``max_len`` bytes; ``nulls`` of them None."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if rng.random() < nulls:
            out.append(None)
        elif rng.random() < 0.5:
            out.append(WORDS[rng.integers(len(WORDS))])
        else:
            k = int(rng.integers(0, max_len // 2 + 1))
            out.append("".join(chr(c) for c in rng.integers(0x61, 0xFF, k)))
    return [s if s is None or len(s.encode()) <= max_len
            else s.encode()[:max_len].decode("utf-8", "ignore") for s in out]


def _host(col) -> tuple:
    """A column of either package as host arrays."""
    if hasattr(col, "chars"):
        return (np.asarray(col.chars), np.asarray(col.lens),
                np.asarray(col.validity))
    return np.asarray(col.data), np.asarray(col.validity)


def _same_col(got, want, n=None):
    for g, w in zip(_host(got), _host(want)):
        g, w = (g[:n], w[:n]) if n is not None else (g, w)
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


def _batch(ns, rb, capacity=None, widths=None):
    if ns is REF:
        return rbridge.to_device(rb, capacity, string_widths=widths)[0]
    return tbridge.to_device(rb, capacity, device="cpu",
                             string_widths=widths)[0]


# ---------------------------------------------------------------------------
# the Arrow bridge and the column ops
# ---------------------------------------------------------------------------

def _arrow_cases() -> dict:
    s = _strings(40, 1)
    plain = pa.array(s, pa.string())
    return {"plain": plain, "sliced": plain.slice(7, 25),
            "chunked": pa.chunked_array([plain.slice(0, 13),
                                         plain.slice(13)]),
            "dictionary": plain.dictionary_encode(),
            "large_string": pa.array(s, pa.large_string()),
            "empty_and_null": pa.array(["", None, "", None], pa.string())}


@pytest.mark.parametrize("case", sorted(_arrow_cases()))
def test_to_device_and_back_match_reference(case):
    arr = _arrow_cases()[case]
    rb = pa.record_batch([arr.combine_chunks() if case == "chunked"
                          else arr], names=["s"])
    if case == "chunked":   # a table's chunked column, as a scan meets it
        tbl = pa.table({"s": arr})
        got = tbridge._column_to_device(
            tbridge.schema_from_arrow(tbl.schema)[0], tbl["s"], 64,
            torch.device("cpu"))
        want = _batch(REF, rb, 64).columns[0]
    else:
        got = _batch(PORT, rb, 64).columns[0]
        want = _batch(REF, rb, 64).columns[0]
    assert isinstance(got, tbatch.StringColumn)
    _same_col(got, want)
    batch = tbatch.DeviceBatch((got,), torch.tensor(len(arr),
                                                    dtype=torch.int32))
    schema = tbridge.schema_from_arrow(rb.schema)
    back = tbridge.to_arrow(batch, schema)
    plain = arr.cast(pa.string()) if case != "dictionary" \
        else arr.dictionary_decode()
    if case == "chunked":
        plain = plain.combine_chunks()
    assert back.column(0).to_pylist() == plain.to_pylist()
    assert back.schema == rbridge.to_arrow(
        rbridge.to_device(rb, 64)[0], rbridge.schema_from_arrow(
            rb.schema)).schema
    (fetched, n), = [tbridge.fetch_numpy(batch)]
    assert n == len(arr)
    for g, w in zip(fetched[0], _host(got)):
        np.testing.assert_array_equal(g, w[:n])


def _width_batches(ns):
    """Three batches of one string column and an int column, at widths
    8, 16 and 32."""
    out = []
    for i, max_len in enumerate((8, 16, 32)):
        s = _strings(20, 10 + i, max_len)
        s[0] = "x" * max_len
        rb = pa.record_batch({"s": pa.array(s, pa.string()),
                              "i": pa.array(np.arange(20) + 100 * i)})
        out.append(_batch(ns, rb, 32))
    return out


def test_column_ops_match_reference():
    rb_, tb_ = _width_batches(REF), _width_batches(PORT)
    assert [b.columns[0].width for b in tb_] == [8, 16, 32]
    rng = np.random.default_rng(3)
    idx = rng.integers(0, 32, 32)
    valid = rng.random(32) > 0.3
    keep = rng.random(32) > 0.4
    for r, t in zip(rb_, tb_):
        _same_col(tbatch.gather_column(t.columns[0], torch.from_numpy(idx),
                                       torch.from_numpy(valid)),
                  rbatch.gather_column(r.columns[0], jnp.asarray(idx),
                                       jnp.asarray(valid)))
        got = tbatch.compact(t, torch.from_numpy(keep))
        want = rbatch.compact(r, jnp.asarray(keep))
        assert int(got.num_rows) == int(want.num_rows)
        for g, w in zip(got.columns, want.columns):
            _same_col(g, w)
        for cap in (64, 24):
            for g, w in zip(tbatch.resize(t, cap).columns,
                            rbatch.resize(r, cap).columns):
                _same_col(g, w)
    # the port unifies widths itself; the reference's concat needs equal
    # widths, so its batches are padded first
    got = tbatch.concat_batches(tbatch.concat_batches(tb_[0], tb_[1]),
                                tb_[2])
    w = 32

    def pad(b):
        return rbatch.DeviceBatch(
            (rbatch.pad_string_width(b.columns[0], w),) + b.columns[1:],
            b.num_rows)
    want = rbatch.concat_batches(rbatch.concat_batches(pad(rb_[0]),
                                                       pad(rb_[1])),
                                 pad(rb_[2]))
    assert got.columns[0].width == 32
    assert int(got.num_rows) == int(want.num_rows) == 60
    for g, wc in zip(got.columns, want.columns):
        _same_col(g, wc)


# ---------------------------------------------------------------------------
# hashes
# ---------------------------------------------------------------------------

def _hash_inputs(width: int, seed: int):
    """Every length 0..min(70, width), twice, random bytes 0x00–0xFF up
    to each length (zero past it), every third row null."""
    rng = np.random.default_rng(seed)
    lens = np.repeat(np.arange(min(70, width) + 1), 2).astype(np.int32)
    n = lens.size
    chars = rng.integers(0, 256, (n, width)).astype(np.uint8)
    chars[np.arange(width)[None, :] >= lens[:, None]] = 0
    valid = np.arange(n) % 3 != 1
    return chars, lens, valid


@pytest.mark.parametrize("width", [8, 16, 32, 64, 128])
def test_string_hashes_match_reference(width):
    chars, lens, valid = _hash_inputs(width, width)
    n = lens.size
    other = np.random.default_rng(1).integers(-2**62, 2**62, n)
    rc = [rbatch.StringColumn(jnp.asarray(chars), jnp.asarray(lens),
                              jnp.asarray(valid)),
          rbatch.PrimitiveColumn(jnp.asarray(other), jnp.ones(n, bool))]
    tc = [tbatch.StringColumn(torch.from_numpy(chars),
                              torch.from_numpy(lens),
                              torch.from_numpy(valid)),
          tbatch.PrimitiveColumn(torch.from_numpy(other),
                                 torch.ones(n, dtype=torch.bool))]
    # chained after an int64 column, and two string columns chained
    for sel in ([1, 0], [0, 0]):
        r = [rc[i] for i in sel]
        t = [tc[i] for i in sel]
        np.testing.assert_array_equal(
            thash.xxhash64_columns(t, n).numpy(),
            np.asarray(rhash.xxhash64_columns(r, n)).view(np.int64))
        np.testing.assert_array_equal(
            thash.murmur3_columns(t, n).numpy(),
            np.asarray(rhash.murmur3_columns(r, n)))
    # the hash does not depend on the width
    wide = tbatch.pad_string_width(tc[0], width + 8)
    np.testing.assert_array_equal(thash.xxhash64_columns([wide], n).numpy(),
                                  thash.xxhash64_columns([tc[0]], n).numpy())


def test_adjacent_and_pairwise_eq_match_reference():
    s = _strings(40, 4, 12)
    s[5] = s[4]
    s[9] = s[10] = None
    rb = pa.record_batch({"s": pa.array(s, pa.string())})
    r, t = _batch(REF, rb, 40).columns[0], _batch(PORT, rb, 40).columns[0]
    np.testing.assert_array_equal(thash.adjacent_eq(t).numpy(),
                                  np.asarray(rhash.adjacent_eq(r)))
    rng = np.random.default_rng(2)
    a, b = rng.integers(0, 40, 60), rng.integers(0, 40, 60)
    np.testing.assert_array_equal(
        thash.pairwise_eq(t, torch.from_numpy(a), t,
                          torch.from_numpy(b)).numpy(),
        np.asarray(rhash.pairwise_eq(r, jnp.asarray(a), r, jnp.asarray(b))))
    # the port also compares two widths
    wide = tbatch.pad_string_width(t, 32)
    np.testing.assert_array_equal(
        thash.pairwise_eq(t, torch.from_numpy(a), wide,
                          torch.from_numpy(b)).numpy(),
        np.asarray(rhash.pairwise_eq(r, jnp.asarray(a), r, jnp.asarray(b))))


# ---------------------------------------------------------------------------
# sort words, SortOp and range partitioning
# ---------------------------------------------------------------------------

ORDERS = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("asc,nf", ORDERS)
def test_string_order_words_match_reference(asc, nf):
    rb = pa.record_batch({"s": pa.array(_strings(48, 5, 24), pa.string())})
    r, t = _batch(REF, rb, 48).columns[0], _batch(PORT, rb, 48).columns[0]
    got = tsort.sort_key_words([t], [(asc, nf)])
    want = rsort.sort_key_words([r], [(asc, nf)])
    assert len(got) == len(want) == 1 + 32 // 8
    for g, w in zip(got, want):
        np.testing.assert_array_equal(tsort.words_to_uint64(g),
                                      np.asarray(w))


def _sort_plan(ns, parts, fetch=None):
    scan = ns.Mem(parts, ns.bridge.schema_from_arrow(parts[0][0].schema),
                  capacity=32)
    C = ns.ir.ColumnRef
    return ns.sort.SortOp(scan, [ns.ir.SortOrder(C(0), False, False),
                                 ns.ir.SortOrder(C(1), True, True)],
                          fetch=fetch)


def _rows(ns, op, partitions=1, conf=None) -> list:
    """Every partition's rows, in order, as python tuples."""
    out = []
    for p in range(partitions):
        ctx = ns.Ctx(partition_id=p, num_partitions=partitions,
                     config=conf)
        for b in op.execute(p, ctx):
            if int(b.num_rows):
                out += ns.bridge.to_arrow(b, op.schema()).to_pylist()
    return out


def _string_parts(n_batches=3, rows=30, seed=20):
    """One partition of batches whose string column ``s`` grows from 8
    to 24 bytes, with an int key ``i`` of ties."""
    out = []
    for i in range(n_batches):
        max_len = 8 * (i + 1)
        s = _strings(rows, seed + i, max_len)
        out.append(pa.record_batch({
            "s": pa.array(s, pa.string()),
            "i": pa.array(np.random.default_rng(i).integers(0, 3, rows))}))
    return [out]


@pytest.mark.parametrize("fetch", [None, 7])
def test_sort_op_on_strings_matches_reference(fetch):
    parts = _string_parts()
    got = _rows(PORT, _sort_plan(PORT, parts, fetch))
    # the reference's concat needs one width: the scan pins it
    want = _rows(REF, _sort_plan(REF, parts, fetch))
    assert got == want
    assert len(got) == (fetch or 90)


def _range_batches(ns, width=None):
    rb = pa.record_batch({"s": pa.array(_strings(64, 30, 16), pa.string()),
                          "i": pa.array(np.arange(64))})
    return [_batch(ns, rb, 64, {"s": width} if width else None)]


@pytest.mark.parametrize("asc,nf", ORDERS)
def test_range_bounds_on_strings_match_reference(asc, nf):
    schema = tbridge.schema_from_arrow(
        pa.schema([("s", pa.string()), ("i", pa.int64())]))
    rschema = rbridge.schema_from_arrow(
        pa.schema([("s", pa.string()), ("i", pa.int64())]))
    t_orders = (tir.SortOrder(tir.ColumnRef(0), asc, nf),
                tir.SortOrder(tir.ColumnRef(1)))
    r_orders = (rir.SortOrder(rir.ColumnRef(0), asc, nf),
                rir.SortOrder(rir.ColumnRef(1)))
    tb, rb = _range_batches(PORT), _range_batches(REF)
    got = tpart.compute_range_bounds(tb, t_orders, schema, 4)
    want = rpart.compute_range_bounds(rb, r_orders, rschema, 4)
    assert got == want and len(got) == 3
    tp = tpart.RangePartitioning(t_orders, 4, got)
    rp = rpart.RangePartitioning(r_orders, 4, want)
    ids = tp.partition_ids(tb[0], schema).numpy()
    np.testing.assert_array_equal(ids, np.asarray(rp.partition_ids(
        rb[0], rschema)))
    # a batch wider than the sampled bounds: the same ids as its rows at
    # the bounds' width, once the partitioning knows the bounds' words
    keyed = tpart.RangePartitioning(
        t_orders, 4, got, tpart.key_word_counts(tb, t_orders, schema))
    wide = _range_batches(PORT, 48)[0]
    assert wide.columns[0].width == 48
    np.testing.assert_array_equal(keyed.partition_ids(wide, schema).numpy(),
                                  ids)


def test_full_sort_by_category_through_range_exchange():
    """A full sort by a category string (descending) and an int through
    a range exchange that samples its own bounds: every partition's rows
    are the reference's, in its order."""
    rng = np.random.default_rng(8)
    cats = np.array(["Books", "Music", "Shoes", "Home", "Sports",
                     "Electronics", "Jewelry", "日本"])
    parts = [[pa.record_batch({
        "i_category": pa.array(cats[rng.integers(0, 8, 40)].tolist()),
        "k": pa.array(rng.integers(0, 50, 40))}) for _ in range(3)]
        for _ in range(2)]
    outs = []
    for ns in (REF, PORT):
        scan = ns.Mem(parts, ns.bridge.schema_from_arrow(
            parts[0][0].schema), capacity=64)
        C = ns.ir.ColumnRef
        orders = [ns.ir.SortOrder(C(0), False, True),
                  ns.ir.SortOrder(C(1), True, True)]
        ex = ns.Shuffle(scan, ns.part.RangePartitioning(
            tuple(orders), 3, ()), input_partitions=2)
        op = ns.sort.SortOp(ex, orders)
        outs.append([_rows(ns, op, 3)])
    assert outs[0] == outs[1]
    assert len(outs[1][0]) == 240


# ---------------------------------------------------------------------------
# the hash table
# ---------------------------------------------------------------------------

def _growing_keys():
    """Three batches of (string key, int64 value) whose keys widen 8 →
    16 → 32 bytes and repeat across batches."""
    base = [w for w in WORDS if len(w.encode()) <= 8]
    out = []
    for i, extra in enumerate(([], ["é" * 6, "mid-width-key"],
                               ["a-much-longer-key-of-32-bytes"])):
        rng = np.random.default_rng(40 + i)
        pool = base + extra
        s = [pool[j] for j in rng.integers(0, len(pool), 96)]
        s[::11] = [None] * len(s[::11])
        out.append(pa.record_batch({
            "s": pa.array(s, pa.string()),
            "v": pa.array(rng.integers(-100, 100, 96))}))
    return out


def test_hash_agg_state_widens_string_keys_mid_stream():
    rbs = _growing_keys()
    states = {}
    for ns, mod in ((REF, rht), (PORT, tht)):
        st = mod.HashAggState(("sum", "min", "first"), initial_capacity=16)
        for rb in rbs:
            b = _batch(ns, rb, 128)
            k, v = b.columns
            live = b.row_mask()
            st.update((k,), (v.data, v.data, v.data), live)
        states[ns is PORT] = st
    r, t = states[False], states[True]
    assert [m for m in t.key_meta] == [("str", 32)] == list(r.key_meta)
    assert t.cap == r.cap and t.count == r.count
    (rk, ra, rn, rcap, rh), (tk, ta, tn, tcap, th) = \
        r.to_sorted_table(), t.to_sorted_table()
    assert int(tn) == int(rn) and tcap == rcap
    np.testing.assert_array_equal(th.numpy(), np.asarray(rh).view(np.int64))
    _same_col(tk[0], rk[0])
    for g, w in zip(ta, ra):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_device_hash_table_widens_string_keys_mid_stream():
    rbs = _growing_keys()
    got, want = [], []
    tables = {}
    for ns, mod, out in ((REF, rtable, want), (PORT, ttable, got)):
        table = mod.DeviceHashTable(initial_capacity=16)
        for rb in rbs:
            b = _batch(ns, rb, 128)
            slot, is_new = table.insert((b.columns[0],), b.row_mask())
            out.append((np.asarray(slot), np.asarray(is_new)))
        probe = _batch(ns, rbs[0], 128)
        out.append(tuple(np.asarray(x) for x in table.probe(
            (probe.columns[0],), probe.row_mask())))
        tables[ns is PORT] = table
    for (gs, gn), (ws, wn) in zip(got, want):
        np.testing.assert_array_equal(gs, ws)
        np.testing.assert_array_equal(gn, wn)
    _same_col(tables[True].keys_columns()[0],
              tables[False].keys_columns()[0])


# ---------------------------------------------------------------------------
# AggOp
# ---------------------------------------------------------------------------

def _agg_parts():
    """Two partitions: string group key ``g`` (nulls included), string
    value ``s`` (every row of group "none" null), int64 ``v``."""
    rng = np.random.default_rng(50)
    groups = ["CA", "TX", "é", "日本", "none", None]
    parts = []
    for p in range(2):
        batches = []
        for b in range(3):
            g = [groups[j] for j in rng.integers(0, len(groups), 40)]
            s = _strings(40, 100 * p + b, 24)
            s = [None if gi == "none" else si for gi, si in zip(g, s)]
            batches.append(pa.record_batch({
                "g": pa.array(g, pa.string()),
                "s": pa.array(s, pa.string()),
                "v": pa.array(rng.integers(0, 9, 40))}))
        parts.append(batches)
    return parts


def _agg_plan(ns, parts, mode, string_values=True):
    C = ns.ir.ColumnRef
    if string_values:
        aggs = [ns.ir.AggFunction(fn, C(1)) for fn in (
            "min", "max", "first", "first_ignores_null", "count")]
    else:
        aggs = [ns.ir.AggFunction("count", C(1)),
                ns.ir.AggFunction("sum", C(2))]
    aggs.append(ns.ir.AggFunction("count_star", None))
    names = [f"a{i}" for i in range(len(aggs))]
    kw = dict(group_names=["g"], agg_names=names)
    schema = ns.bridge.schema_from_arrow(parts[0][0].schema)
    if mode == "complete":
        scan = ns.Mem([[b for p in parts for b in p]], schema, capacity=64)
        return ns.Agg(scan, [C(0)], aggs, mode="complete", **kw), 1
    partial = ns.Agg(ns.Mem(parts, schema, capacity=64), [C(0)], aggs,
                     mode="partial", **kw)
    ex = ns.Shuffle(partial, ns.part.HashPartitioning((C(0),), 2),
                    input_partitions=2)
    return ns.Agg(ex, [C(0)], [ns.ir.AggFunction(a.fn) for a in aggs],
                  mode="final", **kw), 2


AGG_CASES = [(mode, values, path) for mode in ("complete", "two_phase")
             for values in ("strings", "counts") for path in ("sort", "hash")]


@pytest.mark.parametrize("mode,values,path", AGG_CASES)
def test_string_aggs_match_reference(mode, values, path):
    parts = _agg_parts()
    results, reasons = [], []
    # strings never reach the table: "auto" takes the reference's reason
    backend = "auto" if values == "strings" and path == "sort" else path
    for ns in (REF, PORT):
        op, n = _agg_plan(ns, parts, mode, values == "strings")
        conf = ns.cfg.AuronConfig({"auron.hashtable.backend": backend})
        results.append(_rows(ns, op, n, conf))
        reasons.append(op._hash_dispatch(ns.Ctx(config=conf)).reason)
    assert results[1] == results[0]
    assert reasons[1] == reasons[0]
    if values == "strings":
        assert reasons[1] == "acc_kind:smin"
        none = [r for r in results[1] if r["g"] == "none"]
        assert none and none[0]["a0"] is None and none[0]["a3"] is None
    else:
        assert reasons[1] == ("eligible" if path == "hash"
                              else "backend_config")


# ---------------------------------------------------------------------------
# expressions
# ---------------------------------------------------------------------------

def _expr_batch(ns):
    s = _strings(40, 60, 12)
    t = _strings(40, 61, 24)
    s[:6] = ["Books", "Electronics", "é", "", None, "Books"]
    rb = pa.record_batch({"s": pa.array(s, pa.string()),
                          "t": pa.array(t, pa.string())})
    return _batch(ns, rb, 40), ns.bridge.schema_from_arrow(rb.schema)


def _exprs(ir, S):
    """Comparisons and IN lists over the string columns, in either
    package's IR (``S``: its STRING type)."""
    C, L = ir.ColumnRef, ir.Literal
    out = []
    for op in ("==", "!=", "<", "<=", ">", ">="):
        out.append(ir.BinaryExpr(op, C(0), L("Books", S)))
        out.append(ir.BinaryExpr(op, C(0), C(1)))
        out.append(ir.BinaryExpr(op, L("é", S), C(0)))
        # a literal longer than the column's 16-byte width
        out.append(ir.BinaryExpr(op, C(0), L("Electronics and more", S)))
    for neg in (False, True):
        out.append(ir.InList(C(0), ("Books", "é", "", "x" * 40), neg))
    return out


def test_string_predicates_match_reference():
    rb, rs = _expr_batch(REF)
    tb, ts = _expr_batch(PORT)
    assert tb.columns[0].width == 16
    for re_, te in zip(_exprs(rir, RDT.STRING), _exprs(tir, TDT.STRING)):
        want = reval.evaluate(re_, rb, rs)
        got = teval.evaluate(te, tb, ts)
        assert got.dtype.value == want.dtype.value == "bool"
        assert teval.infer_dtype(te, ts)[0].value == "bool"
        _same_col(got.col, want.col, 40)


# ---------------------------------------------------------------------------
# joins and exchanges
# ---------------------------------------------------------------------------

def _join_sides():
    rng = np.random.default_rng(70)
    keys = ["CA", "TX", "é", "日本", "Books", "a-key-of-twenty-bytes"]
    probe = [pa.record_batch({
        "k": pa.array([keys[j] if j < len(keys) else None
                       for j in rng.integers(0, len(keys) + 1, 30)],
                      pa.string()),
        "x": pa.array(rng.integers(0, 100, 30))}) for _ in range(2)]
    build = [pa.record_batch({
        "k": pa.array(keys[2:] + ["NY", None], pa.string()),
        "y": pa.array(_strings(6, 71, 16), pa.string())})]
    return probe, build


@pytest.mark.parametrize("index", ["ht", "sorted"])
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti"])
def test_string_key_join_matches_reference(how, index):
    probe, build = _join_sides()
    rows = []
    for ns in (REF, PORT):
        p = ns.Mem([probe], ns.bridge.schema_from_arrow(probe[0].schema),
                   capacity=32)
        b = ns.Mem([build], ns.bridge.schema_from_arrow(build[0].schema),
                   capacity=8)
        C = ns.ir.ColumnRef
        op = ns.Join(p, b, [C(0)], [C(0)], how)
        conf = ns.cfg.AuronConfig({"auron.hashtable.enabled":
                                   index == "ht"})
        rows.append(_rows(ns, op, 1, conf))
    assert rows[1] == rows[0]
    if how in ("left", "full"):
        assert any(r["y"] is None and r["k"] is not None for r in rows[1])


def test_exchanges_carry_strings():
    parts = _agg_parts()
    outs = []
    for ns in (REF, PORT):
        schema = ns.bridge.schema_from_arrow(parts[0][0].schema)
        C = ns.ir.ColumnRef
        ex = ns.Shuffle(ns.Mem(parts, schema, capacity=64),
                        ns.part.HashPartitioning((C(0), C(1)), 2),
                        input_partitions=2)
        bc = ns.Broadcast(ns.Mem(parts, schema, capacity=64),
                          input_partitions=2)
        outs.append((_rows(ns, ex, 2), _rows(ns, bc, 2)))
    assert outs[1] == outs[0]
    assert len(outs[1][0]) == 240 and len(outs[1][1]) == 480


#: ROADMAP Queue 3 item 25's sides: widths 8 and 32 (a 17-byte key)
_NARROW = {"s": ["a", "bb", None, "", "zz"], "x": [0, 1, 2, 3, 4]}
_WIDE = {"t": ["abcdefghijklmnopq", "a", "", None, "q"],
         "y": [0, 1, 2, 3, 4]}


def _join_oracle(probe: dict, build: dict, how: str) -> list:
    """SQL's rows of ``probe JOIN build`` on their first columns as
    python tuples: a null
    key matches nothing; semi, anti and existence keep the probe's rows
    (anti keeps a null-key row, which matches nothing)."""
    pn, bn = list(probe), list(build)
    prow = list(zip(*probe.values()))
    brow = list(zip(*build.values()))
    nulls_b = (None,) * len(bn)
    out, hit_b = [], set()
    for pr in prow:
        hits = [j for j, br in enumerate(brow)
                if pr[0] is not None and br[0] == pr[0]]
        hit_b.update(hits)
        if how == "semi":
            out += [pr] if hits else []
        elif how == "anti":
            out += [] if hits else [pr]
        elif how == "existence":
            out.append(pr + (bool(hits),))
        else:
            out += [pr + brow[j] for j in hits]
            if not hits and how in ("left", "full"):
                out.append(pr + nulls_b)
    if how == "full":
        out += [(None,) * len(pn) + br for j, br in enumerate(brow)
                if j not in hit_b]
    return out


def _sort_key(row):
    return tuple((v is None, "" if v is None else str(v)) for v in row)


@pytest.mark.parametrize("index", ["ht", "sorted"])
@pytest.mark.parametrize("build_side", ["co_partitioned", "broadcast"])
@pytest.mark.parametrize("probe_width", [8, 32])
@pytest.mark.parametrize("how", ["inner", "left", "full", "semi", "anti",
                                 "existence"])
def test_string_key_join_across_widths_gives_sql_rows(how, probe_width,
                                                      build_side, index):
    """A probe of string width 8 against a build of width 32, and the
    other way round, through every join type, a co-partitioned and a
    broadcast build side, and both candidate searches: SQL's rows. The
    reference raises here (``pairwise_eq`` compares chars of two widths:
    ROADMAP Queue 3 item 25), so the oracle is plain Python."""
    probe, build = (_NARROW, _WIDE) if probe_width == 8 else (_WIDE, _NARROW)
    p_rb, b_rb = pa.record_batch(probe), pa.record_batch(build)
    p = PORT.Mem([[p_rb]], tbridge.schema_from_arrow(p_rb.schema),
                 capacity=8)
    assert p.schema()[0].dtype == TDT.STRING
    b = PORT.Mem([[b_rb]], tbridge.schema_from_arrow(b_rb.schema),
                 capacity=8)
    if build_side == "broadcast":
        b = TBroadcast(b, input_partitions=1)
    C = tir.ColumnRef
    op = TJoin(p, b, [C(0)], [C(0)], how)
    conf = tcfg.AuronConfig({"auron.hashtable.enabled": index == "ht"})
    got = [tuple(r.values()) for r in _rows(PORT, op, 1, conf)]
    widths = {next(iter(b.execute(0, TCtx()))).columns[0].width
              for b in (p, b)}
    assert widths == {8, 32}
    want = _join_oracle(probe, build, how)
    assert sorted(got, key=_sort_key) == sorted(want, key=_sort_key)
