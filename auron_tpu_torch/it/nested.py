"""Queries over nested columns and DISTINCT aggregates, with their
oracles.

Built in the port's DataFrame DSL (``dsl=`` builds the same query in
another DSL with the same surface, such as the JAX package's) over the
store_sales files of ``it/tpcds_data.py``:

- ``customer_sets_dataframe``: per customer, ``collect_set`` of the
  items, ``collect_list`` of the quantities and the DISTINCT count of
  the items; ``exploded_sets_dataframe`` explodes (or posexplodes) the
  set back to rows;
- ``struct_key_dataframes``: ``named_struct(store, date)`` as a group
  key, a sort key and a window partition key, read back with
  ``get_struct_field``;
- ``decimal_distinct_dataframe``: DISTINCT sum and avg of the price as a
  decimal(7, 2), which the DSL regroups (``_rewrite_wide_distinct``);
- ``wide_set_dataframe``: ``collect_set`` of the price as a
  decimal(25, 2), the limb-pair set;
- ``nested_table``/``write_nested``: a table of list<int64>,
  list<string>, list<decimal(25, 2)>, map<string, string>,
  map<int64, float64> and struct columns with null, empty and
  null-holding lists; ``function_sweep_dataframe`` calls the 31 array,
  map and struct functions over it.

Each ``check_*`` holds a result against a pandas/pyarrow (or Python
``decimal``) oracle over the same rows and returns its mismatches, an
empty list when it agrees. Sets are compared as sets and lists as
multisets: their order after an exchange is not fixed.
"""

from __future__ import annotations

import decimal
from collections import Counter

import numpy as np

from auron_tpu_torch.it.queries import PORT_DSL

#: the width of the decimals the DISTINCT and wide-set queries cast to
PRICE_DECIMAL = (7, 2)
WIDE_DECIMAL = (25, 2)


def _sales(s, t, partitions=4):
    return s.read_parquet(t["store_sales"], partitions=partitions)


# ---------------------------------------------------------------------------
# (a) collect and DISTINCT per customer, (b) explode back to rows
# ---------------------------------------------------------------------------

def customer_sets_dataframe(s, t, dsl=None):
    d = dsl or PORT_DSL
    return (_sales(s, t).group_by("ss_customer_sk")
            .agg(d.F.collect_set(d.col("ss_item_sk")).alias("items"),
                 d.F.collect_list(d.col("ss_quantity")).alias("qtys"),
                 d.F.count(d.col("ss_item_sk"), distinct=True)
                 .alias("n_items")))


def _pairs(a, b) -> np.ndarray:
    """Two int64 columns as one sortable int64 key per row (both hold
    values below 2^31)."""
    return (np.asarray(a, np.int64) << 32) | np.asarray(b, np.int64)


def _flat(got, key: str, lists: str):
    """(key of each element's row, the elements) of a list column."""
    import pyarrow.compute as pc
    col = got[lists].combine_chunks()
    rows = pc.list_parent_indices(col).to_numpy()
    keys = got[key].to_numpy()[rows]
    return keys, pc.list_flatten(col).to_numpy(zero_copy_only=False)


def check_customer_sets(got, ss) -> list[str]:
    """``got`` (customer, items, qtys, n_items) against pandas ``ss``:
    each set holds the customer's distinct items once each, each list
    the customer's quantities as a multiset, each count the distinct
    items."""
    bad = []
    cust = got["ss_customer_sk"].to_numpy()
    want_cust = np.unique(ss["ss_customer_sk"].to_numpy())
    if not np.array_equal(np.sort(cust), want_cust):
        bad.append(f"customers: {len(cust)} rows vs {len(want_cust)}")
    k, items = _flat(got, "ss_customer_sk", "items")
    have = np.sort(_pairs(k, items))
    want = np.unique(_pairs(ss["ss_customer_sk"], ss["ss_item_sk"]))
    if not np.array_equal(have, want):
        bad.append(f"sets: {have.size} elements ({np.unique(have).size} "
                   f"distinct) vs {want.size}")
    k, qtys = _flat(got, "ss_customer_sk", "qtys")
    if not np.array_equal(np.sort(_pairs(k, qtys)), np.sort(_pairs(
            ss["ss_customer_sk"], ss["ss_quantity"]))):
        bad.append("lists differ as multisets")
    n = ss.groupby("ss_customer_sk")["ss_item_sk"].nunique()
    if not np.array_equal(got["n_items"].to_numpy(),
                          n.reindex(cust).to_numpy()):
        bad.append("count distinct differs")
    return bad


def exploded_sets_dataframe(s, t, pos: bool = False, dsl=None):
    sets = customer_sets_dataframe(s, t, dsl).select("ss_customer_sk",
                                                     "items")
    return (sets.posexplode if pos else sets.explode)(
        "items", keep=["ss_customer_sk"])


def check_exploded(got, ss, pos: bool = False) -> list[str]:
    """One row per distinct (customer, item); with ``pos``, each
    customer's positions are 0..n-1 once each."""
    bad = []
    cust = got["ss_customer_sk"].to_numpy()
    have = np.sort(_pairs(cust, got["col"].to_numpy()))
    want = np.unique(_pairs(ss["ss_customer_sk"], ss["ss_item_sk"]))
    if not np.array_equal(have, want):
        bad.append(f"pairs: {have.size} rows, {np.unique(have).size} "
                   f"distinct, want {want.size}")
    if pos:
        p = got["pos"].to_numpy()
        order = np.lexsort((p, cust))
        c, p = cust[order], p[order]
        start = np.r_[0, np.flatnonzero(c[1:] != c[:-1]) + 1]
        rank = np.arange(c.size) - np.repeat(start, np.diff(
            np.r_[start, c.size]))
        if not np.array_equal(p, rank):
            bad.append("positions are not 0..n-1 per customer")
    return bad


# ---------------------------------------------------------------------------
# (c) a struct as a group key, a sort key and a window partition key
# ---------------------------------------------------------------------------

def _with_struct(s, t, d):
    F, col, lit = d.F, d.col, d.lit
    return _sales(s, t).select(
        F.named_struct(lit("store"), col("ss_store_sk"), lit("date"),
                       col("ss_sold_date_sk")).alias("sd"),
        col("ss_item_sk"), col("ss_quantity"), col("ss_sales_price"))


def _fields(d, *extra):
    F, col, lit = d.F, d.col, d.lit
    return (F.get_struct_field(col("sd"), lit("store")).alias("store"),
            F.get_struct_field(col("sd"), lit("date")).alias("date"),
            *[col(e) for e in extra])


def struct_key_dataframes(s, t, dsl=None) -> dict:
    """{"group", "sort", "window"}: the sum of the quantity and the row
    count per (store, date) struct; the same groups sorted by the
    struct descending; the rows ranked first by price (then item) in
    their struct's window."""
    d = dsl or PORT_DSL
    F, col = d.F, d.col
    grouped = _with_struct(s, t, d).group_by("sd").agg(
        F.sum(col("ss_quantity")).alias("q"), F.count_star().alias("n"))
    top = _with_struct(s, t, d).window(
        [F.rank().alias("r")], partition_by=[col("sd")],
        order_by=[col("ss_sales_price").desc(), col("ss_item_sk").asc()])
    return {
        "group": grouped.select(*_fields(d, "q", "n")),
        "sort": grouped.sort(col("sd").desc()).select(*_fields(d, "q", "n")),
        "window": top.filter(col("r") == 1).select(
            *_fields(d, "ss_item_sk", "ss_sales_price")),
    }


def check_struct_keys(name: str, got, ss) -> list[str]:
    g = ss.groupby(["ss_store_sk", "ss_sold_date_sk"])
    rows = got.to_pydict()
    if name in ("group", "sort"):
        want = {k: (int(q), int(n)) for k, q, n in zip(
            g.size().index, g["ss_quantity"].sum(), g.size())}
        have = {(a, b): (q, n) for a, b, q, n in zip(
            rows["store"], rows["date"], rows["q"], rows["n"])}
        bad = [] if have == want and len(rows["q"]) == len(want) else [
            f"{name}: {len(have)} groups vs {len(want)}"]
        if name == "sort":
            keys = list(zip(rows["store"], rows["date"]))
            if keys != sorted(keys, reverse=True):
                bad.append("sort: not in descending struct order")
        return bad
    mx = g["ss_sales_price"].transform("max")
    top = ss[ss["ss_sales_price"] == mx]
    first = top.groupby(["ss_store_sk", "ss_sold_date_sk"])[
        "ss_item_sk"].transform("min")
    top = top[top["ss_item_sk"] == first]
    want = Counter(zip(top["ss_store_sk"], top["ss_sold_date_sk"],
                       top["ss_item_sk"], top["ss_sales_price"]))
    have = Counter(zip(rows["store"], rows["date"], rows["ss_item_sk"],
                       rows["ss_sales_price"]))
    return [] if have == want else [
        f"window: {sum(have.values())} rows vs {sum(want.values())}"]


# ---------------------------------------------------------------------------
# (d) DISTINCT sum and avg over a decimal, (e) a set of wide decimals
# ---------------------------------------------------------------------------

def _priced(s, t, d, p: int, sc: int):
    return _sales(s, t).select(
        d.col("ss_store_sk"),
        d.col("ss_sales_price").cast(d.DataType.DECIMAL, p, sc).alias("p"))


def decimal_distinct_dataframe(s, t, dsl=None):
    d = dsl or PORT_DSL
    return _priced(s, t, d, *PRICE_DECIMAL).group_by("ss_store_sk").agg(
        d.F.sum(d.col("p"), distinct=True).alias("s"),
        d.F.avg(d.col("p"), distinct=True).alias("a"))


def _cents(ss) -> dict:
    """{store: set of distinct prices in cents} (the cast rounds the
    two-decimal float price HALF_UP, exactly for these values)."""
    pairs = np.unique(_pairs(ss["ss_store_sk"], np.round(
        ss["ss_sales_price"].to_numpy() * 100).astype(np.int64)))
    out: dict = {}
    for st, c in zip((pairs >> 32).tolist(), (pairs & 0xFFFFFFFF).tolist()):
        out.setdefault(st, set()).add(c)
    return out


def check_decimal_distinct(got, ss) -> list[str]:
    """Against Python ``decimal``: the sum of each store's distinct
    prices, and their mean rounded HALF_UP to scale 6."""
    want = _cents(ss)
    rows = got.to_pydict()
    bad = [] if len(rows["s"]) == len(want) else [
        f"{len(rows['s'])} stores vs {len(want)}"]
    q6 = decimal.Decimal(1).scaleb(-6)
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        ctx.rounding = decimal.ROUND_HALF_UP
        for st, sm, av in zip(rows["ss_store_sk"], rows["s"], rows["a"]):
            vals = want.get(st, set())
            total = decimal.Decimal(sum(vals)).scaleb(-2)
            mean = (total / len(vals)).quantize(q6)
            if sm != total or av != mean:
                bad.append(f"store {st}: {sm}/{av} vs {total}/{mean}")
                break
    return bad


def wide_set_dataframe(s, t, dsl=None):
    d = dsl or PORT_DSL
    return _priced(s, t, d, *WIDE_DECIMAL).group_by("ss_store_sk").agg(
        d.F.collect_set(d.col("p")).alias("ps"))


def check_wide_set(got, ss) -> list[str]:
    """Each store's set holds its distinct prices once each."""
    import pyarrow as pa
    import pyarrow.compute as pc
    col = got["ps"].combine_chunks()
    rows = pc.list_parent_indices(col).to_numpy()
    stores = got["ss_store_sk"].to_numpy()
    # |price| < 10^6: the float64 of the decimal holds its cents exactly
    cents = np.round(pc.list_flatten(col).cast(pa.float64()).to_numpy()
                     * 100).astype(np.int64)
    have = np.sort(_pairs(stores[rows], cents))
    want = np.unique(_pairs(ss["ss_store_sk"], np.round(
        ss["ss_sales_price"].to_numpy() * 100).astype(np.int64)))
    bad = [] if len(stores) == len(np.unique(ss["ss_store_sk"])) else [
        f"{len(stores)} stores"]
    if not np.array_equal(have, want):
        bad.append(f"sets: {have.size} elements vs {want.size}")
    return bad


# ---------------------------------------------------------------------------
# (f) a parquet file of nested columns, (g) the function sweep over it
# ---------------------------------------------------------------------------

def nested_table(rows: int, seed: int = 42):
    """A pyarrow table of ``rows`` rows: k int64; s, a string of
    "k:v" pairs; li list<int64>, ls list<string>, ld list<decimal(25,
    2)>, mss map<string, string>, mif map<int64, float64> and st
    struct<a: int64, b: string, c: float64>. About one list in eight is
    null, one in eight empty, and elements and map values hold nulls."""
    import pyarrow as pa
    rng = np.random.default_rng(seed)
    k = np.arange(rows, dtype=np.int64)
    lens = rng.integers(0, 6, rows)
    kind = rng.integers(0, 8, rows)        # 0: null list, 1: empty list
    lens = np.where(kind == 1, 0, lens)
    null_row = kind == 0
    n_el = int(lens.sum())
    ints = rng.integers(-5, 6, n_el)
    int_ok = rng.random(n_el) > 0.1
    words = np.array(["a", "bb", "ccc", "dddd", "", "eeeeeeeeeeee"])
    strs = words[rng.integers(0, len(words), n_el)]
    cents = rng.integers(-10 ** 6, 10 ** 6, n_el) * 10 ** 12 + \
        rng.integers(0, 100, n_el)
    off = np.concatenate([[0], np.cumsum(lens)])

    def lists(make):
        return [None if null_row[i] else [make(j) for j in
                                          range(off[i], off[i + 1])]
                for i in range(rows)]

    li = lists(lambda j: int(ints[j]) if int_ok[j] else None)
    ls = lists(lambda j: str(strs[j]) if int_ok[j] else None)
    ld = lists(lambda j: decimal.Decimal(int(cents[j])).scaleb(-2)
               if int_ok[j] else None)

    def kv(i, key, val):
        return [(key(j), val(j)) for j in range(off[i], off[i + 1])]

    mss, mif = [], []
    for i in range(rows):
        if null_row[i]:
            mss.append(None)
            mif.append(None)
            continue
        # distinct keys per map: the element index within the row
        mss.append(kv(i, lambda j, i=i: f"k{j - off[i]}",
                      lambda j: str(strs[j]) if int_ok[j] else None))
        mif.append(kv(i, lambda j, i=i: int(j - off[i]),
                      lambda j: float(ints[j]) * 0.5 if int_ok[j]
                      else None))
    st_ok = rng.random(rows) > 0.1
    a_ok = rng.random(rows) > 0.1
    st = [{"a": int(k[i] % 7) if a_ok[i] else None,
           "b": str(words[i % len(words)]),
           "c": float(i % 5) - 1.5} if st_ok[i] else None
          for i in range(rows)]
    pairs = [",".join(f"{w}:{j}" for j, w in enumerate(
        words[rng.integers(0, 4, 1 + i % 3)])) for i in range(rows)]
    return pa.table({
        "k": pa.array(k, pa.int64()),
        "s": pa.array(pairs, pa.string()),
        "li": pa.array(li, pa.list_(pa.int64())),
        "ls": pa.array(ls, pa.list_(pa.string())),
        "ld": pa.array(ld, pa.list_(pa.decimal128(*WIDE_DECIMAL))),
        "mss": pa.array(mss, pa.map_(pa.string(), pa.string())),
        "mif": pa.array(mif, pa.map_(pa.int64(), pa.float64())),
        "st": pa.array(st, pa.struct([("a", pa.int64()), ("b", pa.string()),
                                      ("c", pa.float64())])),
    })


def write_nested(root: str, rows: int, seed: int = 42) -> list[str]:
    """``nested_table(rows, seed)`` as one parquet file under ``root``."""
    import os

    import pyarrow.parquet as pq
    os.makedirs(root, exist_ok=True)
    path = os.path.join(root, "nested.parquet")
    pq.write_table(nested_table(rows, seed), path)
    return [path]


#: the functions ``function_sweep_dataframe`` calls, each at least once
SWEEP_FUNCTIONS = (
    "array", "size", "cardinality", "array_contains", "array_position",
    "element_at", "get_map_value", "array_max", "array_min", "sort_array",
    "array_repeat", "map", "create_map", "map_from_arrays", "map_keys",
    "map_values", "map_entries", "map_from_entries", "map_contains_key",
    "map_concat", "array_distinct", "array_union", "array_intersect",
    "array_except", "arrays_overlap", "split", "array_join", "str_to_map",
    "named_struct", "struct", "get_struct_field")


def function_sweep_dataframe(s, files, dsl=None):
    """A select over ``write_nested``'s file calling every function of
    ``SWEEP_FUNCTIONS``."""
    d = dsl or PORT_DSL
    F, col, lit = d.F, d.col, d.lit
    k, li, ls = col("k"), col("li"), col("ls")
    mss, mif = col("mss"), col("mif")
    one = lit(1)
    return s.read_parquet(files).select(
        k,
        F.array(k, k + 1, k % 3).alias("arr"),
        F.size(li).alias("size_li"),
        F.cardinality(mif).alias("card_mif"),
        F.array_contains(li, k % 5).alias("contains"),
        F.array_position(li, lit(3)).alias("position"),
        F.element_at(li, one).alias("first_li"),
        F.element_at(ls, lit(-1)).alias("last_ls"),
        F.element_at(mss, lit("k1")).alias("mss_k1"),
        F.get_map_value(mif, k % 3).alias("mif_k"),
        F.array_max(li).alias("max_li"),
        F.array_min(li).alias("min_li"),
        F.sort_array(li, lit(False)).alias("sorted_desc"),
        F.sort_array(ls).alias("sorted_ls"),
        F.array_repeat(k % 4, lit(3)).alias("repeat"),
        F.map(k % 4, k * 2).alias("m"),
        F.create_map(lit(1), k, lit(2), k % 2).alias("cm"),
        F.map_from_arrays(F.array(k, k + 1), F.array(one, lit(2)))
        .alias("mfa"),
        F.map_keys(mif).alias("keys_mif"),
        F.map_values(mss).alias("values_mss"),
        F.map_entries(mif).alias("entries_mif"),
        F.map_from_entries(F.map_entries(mif)).alias("mfe"),
        F.map_contains_key(mss, lit("k0")).alias("has_k0"),
        F.map_concat(mif, F.map(lit(0), k * 1.0)).alias("concat"),
        F.array_distinct(li).alias("distinct_li"),
        F.array_union(li, F.array(k % 5, one)).alias("union_li"),
        F.array_intersect(li, F.array(one, lit(2), lit(3)))
        .alias("intersect_li"),
        F.array_except(li, F.array(one)).alias("except_li"),
        F.arrays_overlap(li, F.array(k % 5)).alias("overlap"),
        F.split(col("s"), lit(",")).alias("split_s"),
        F.array_join(ls, lit("-"), lit("?")).alias("joined"),
        F.str_to_map(col("s")).alias("stm"),
        F.named_struct(lit("x"), k, lit("y"), col("s")).alias("ns"),
        F.struct(k, li).alias("st2"),
        F.get_struct_field(col("st"), lit("b")).alias("st_b"))
