"""TPC-DS-class integration queries the port can run.

Copies of ``auron_tpu.it.queries``'s q01 to q16, with their oracles
(q03, q04 and q06 to q09 group, filter or sort on strings; q15
multiplies two wide decimals and sorts on the product; q16 ranks within
a window). Each
query runs through the whole front end: DataFrame DSL → protobuf
TaskDefinition → physical planner → operators (``ShuffleExchangeOp``
stages and hash joins included).
More queries of the same shapes:

- ``store_quantity_dataframe``, over an in-memory table
  (``Session.from_arrow``), whose single partition lets the planner
  derive a dense key domain;
- ``q05_dataframe(co_partitioned=False)``, q05 without its two
  repartitions, whose date_dim side is broadcast;
- ``cheap_sales_items_dataframe``, q09's anti join (or its semi join)
  with a keyless count over the item keys alone;
- ``outer_join_dataframe``, a co-partitioned join of every type that
  leaves rows unmatched on both sides;
- ``broadcast_outer_dataframe``, the right or full join over a
  broadcast build side whose rows are ``BROADCAST_OUTER_ROWS``;
- ``rollup_rank_dataframe``, q67's shape: a rollup of (category,
  brand), then a rank within the category;
- ``window_sweep_dataframes``, every window function over the joined
  sales, item and customer tables;
- ``expression_sweep_dataframe``, a select over the customer or the
  item table that calls every scalar function and expression node the
  port evaluates;
- ``decimal_money_dataframe``, money columns cast to decimals of both
  representations and aggregated per store (narrow and wide sums and
  averages, wide min and max, a narrow product whose sum moves to the
  limbs), and ``decimal_price_key_dataframe``, a wide decimal group key
  through the hash table and a top-k sort on it; their oracles compute
  in Python's ``decimal``.

pyarrow and pandas are imported inside the functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from types import SimpleNamespace
from typing import Callable

from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.frontend.dataframe import Col, col, lit
from auron_tpu_torch.frontend.dataframe import functions as F


@dataclass(frozen=True)
class Query:
    name: str
    description: str
    dataframe: Callable  # (session, tables: {name: [files]}) -> DataFrame
    oracle: Callable     # (pd_tables: {name: DataFrame}) -> pandas.DataFrame

    def run(self, session, tables):
        return self.dataframe(session, tables).collect()

    def expected(self, pd_tables):
        import pyarrow as pa
        df = self.oracle(pd_tables)
        return pa.Table.from_pandas(df.reset_index(drop=True),
                                    preserve_index=False)


def _sales(session, tables, partitions=4):
    return session.read_parquet(tables["store_sales"], partitions=partitions)


def _dim(session, tables, name, columns=None):
    return session.read_parquet(tables[name], columns=columns)


# q01: scan → filter → two-phase agg

def q01_dataframe(s, t, partitions=4):
    return (_sales(s, t, partitions=partitions)
            .filter(col("ss_quantity") > 5)
            .group_by("ss_store_sk")
            .agg(F.sum(col("ss_sales_price")).alias("total"),
                 F.count(col("ss_net_paid")).alias("paid_cnt"),
                 F.avg(col("ss_net_profit")).alias("avg_profit")))


def _q01_oracle(p):
    ss = p["store_sales"]
    f = ss[ss.ss_quantity > 5]
    return f.groupby("ss_store_sk").agg(
        total=("ss_sales_price", "sum"),
        paid_cnt=("ss_net_paid", "count"),
        avg_profit=("ss_net_profit", "mean")).reset_index()


# q02: top-k customers by revenue (agg → exchange → global sort + limit)

def q02_dataframe(s, t, limit=100):
    """``limit=None`` is the full sort through the range exchange."""
    return (_sales(s, t)
            .group_by("ss_customer_sk")
            .agg(F.sum(col("ss_net_paid")).alias("revenue"))
            .sort(col("revenue").desc(), col("ss_customer_sk").asc(),
                  limit=limit))


def _q02_oracle(p):
    g = p["store_sales"].groupby("ss_customer_sk").agg(
        revenue=("ss_net_paid", "sum")).reset_index()
    return g.sort_values(["revenue", "ss_customer_sk"],
                         ascending=[False, True]).head(100)


# q03: fact ⋈ dim join (co-partitioned) → agg by category (IN filter)

def q03_dataframe(s, t):
    item = (_dim(s, t, "item")
            .select(col("i_item_sk").alias("ss_item_sk"),
                    col("i_category"), col("i_current_price"))
            .repartition(4, "ss_item_sk"))
    sales = _sales(s, t).repartition(4, "ss_item_sk")
    return (sales.join(item, on="ss_item_sk")
            .filter(col("i_category").isin("Books", "Music", "Shoes"))
            .group_by("i_category")
            .agg(F.sum(col("ss_sales_price")).alias("total"),
                 F.count_star().alias("n")))


def _q03_oracle(p):
    ss, it = p["store_sales"], p["item"]
    j = ss.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j[j.i_category.isin(["Books", "Music", "Shoes"])]
    return j.groupby("i_category").agg(
        total=("ss_sales_price", "sum"),
        n=("ss_item_sk", "size")).reset_index()


# q04: join the store dim → agg by state

def q04_dataframe(s, t):
    store = (_dim(s, t, "store")
             .select(col("s_store_sk").alias("ss_store_sk"),
                     col("s_state")))
    return (_sales(s, t).repartition(4, "ss_store_sk")
            .join(store.repartition(4, "ss_store_sk"), on="ss_store_sk")
            .group_by("s_state")
            .agg(F.count_star().alias("n"),
                 F.sum(col("ss_net_profit")).alias("profit")))


def _q04_oracle(p):
    j = p["store_sales"].merge(p["store"], left_on="ss_store_sk",
                               right_on="s_store_sk")
    return j.groupby("s_state").agg(
        n=("ss_store_sk", "size"),
        profit=("ss_net_profit", "sum")).reset_index()


# q05: a filtered date_dim joined with store_sales → agg by month

def q05_dataframe(s, t, co_partitioned=True):
    """``co_partitioned=False`` drops the two repartitions: the 1-partition
    date_dim side is then broadcast to the 4 store_sales partitions."""
    dd = (_dim(s, t, "date_dim")
          .filter(col("d_year") == 2000)
          .select(col("d_date_sk").alias("ss_sold_date_sk"), col("d_moy")))
    sales = _sales(s, t)
    if co_partitioned:
        sales = sales.repartition(4, "ss_sold_date_sk")
        dd = dd.repartition(4, "ss_sold_date_sk")
    return (sales.join(dd, on="ss_sold_date_sk")
            .group_by("d_moy")
            .agg(F.sum(col("ss_sales_price")).alias("total")))


def _q05_oracle(p):
    dd = p["date_dim"]
    dd = dd[dd.d_year == 2000]
    j = p["store_sales"].merge(dd, left_on="ss_sold_date_sk",
                               right_on="d_date_sk")
    return j.groupby("d_moy").agg(
        total=("ss_sales_price", "sum")).reset_index()


# q06: string min/max aggregates over a join (customer emails by state)

def q06_dataframe(s, t):
    cust = (_dim(s, t, "customer")
            .select(col("c_customer_sk").alias("ss_customer_sk"),
                    col("c_state"), col("c_email")))
    return (_sales(s, t).repartition(4, "ss_customer_sk")
            .join(cust.repartition(4, "ss_customer_sk"),
                  on="ss_customer_sk")
            .group_by("c_state")
            .agg(F.min(col("c_email")).alias("first_email"),
                 F.max(col("c_email")).alias("last_email"),
                 F.count(col("c_email")).alias("n")))


def _q06_oracle(p):
    import pandas as pd
    j = p["store_sales"].merge(p["customer"], left_on="ss_customer_sk",
                               right_on="c_customer_sk")
    # SQL min/max skip nulls: drop them, then reduce (an all-null group
    # gives NaN, the engine's NULL)
    g = j.groupby("c_state")["c_email"]
    return pd.DataFrame({
        "first_email": g.apply(lambda v: v.dropna().min()),
        "last_email": g.apply(lambda v: v.dropna().max()),
        "n": g.count(),
    }).reset_index()


# q07: three-table join → composite-key agg → sort + limit

def q07_dataframe(s, t):
    item = (_dim(s, t, "item")
            .select(col("i_item_sk").alias("ss_item_sk"),
                    col("i_category")))
    store = (_dim(s, t, "store")
             .select(col("s_store_sk").alias("ss_store_sk"),
                     col("s_state")))
    return (_sales(s, t).repartition(4, "ss_item_sk")
            .join(item.repartition(4, "ss_item_sk"), on="ss_item_sk")
            .repartition(4, "ss_store_sk")
            .join(store.repartition(4, "ss_store_sk"), on="ss_store_sk")
            .filter(col("ss_net_profit") > 0)
            .group_by("i_category", "s_state")
            .agg(F.sum(col("ss_net_paid")).alias("paid"))
            .sort(col("paid").desc(), col("i_category").asc(),
                  col("s_state").asc(), limit=50))


def _q07_oracle(p):
    j = (p["store_sales"]
         .merge(p["item"], left_on="ss_item_sk", right_on="i_item_sk")
         .merge(p["store"], left_on="ss_store_sk", right_on="s_store_sk"))
    j = j[j.ss_net_profit > 0]
    g = j.groupby(["i_category", "s_state"]).agg(
        paid=("ss_net_paid", "sum")).reset_index()
    return g.sort_values(["paid", "i_category", "s_state"],
                         ascending=[False, True, True]).head(50)


# q08: semi join — the states of customers who bought Electronics

def q08_dataframe(s, t):
    item = (_dim(s, t, "item")
            .select(col("i_item_sk").alias("ss_item_sk"),
                    col("i_category")))
    buyers = (_sales(s, t)
              .join(item, on="ss_item_sk")
              .filter(col("i_category") == "Electronics")
              .select(col("ss_customer_sk").alias("c_customer_sk")))
    cust = _dim(s, t, "customer")
    return (cust.join(buyers, on="c_customer_sk", how="semi")
            .group_by("c_state")
            .agg(F.count_star().alias("n")))


def _q08_oracle(p):
    j = p["store_sales"].merge(p["item"], left_on="ss_item_sk",
                               right_on="i_item_sk")
    buyers = set(j[j.i_category == "Electronics"].ss_customer_sk)
    c = p["customer"]
    c = c[c.c_customer_sk.isin(buyers)]
    return c.groupby("c_state").agg(
        n=("c_customer_sk", "size")).reset_index()


# q09: anti join — items never sold under $1, counted by category

def q09_dataframe(s, t):
    # "never discounted": anti-join against sub-$1 sales, rare enough
    # (~0.2% of rows) that the anti side stays populated at every scale
    sold = (_sales(s, t)
            .filter(col("ss_sales_price") < 1.0)
            .select(col("ss_item_sk").alias("i_item_sk")))
    item = _dim(s, t, "item")
    return (item.join(sold, on="i_item_sk", how="anti")
            .group_by("i_category")
            .agg(F.count_star().alias("n")))


def _q09_oracle(p):
    ss = p["store_sales"]
    sold = set(ss[ss.ss_sales_price < 1.0].ss_item_sk)
    it = p["item"]
    unsold = it[~it.i_item_sk.isin(sold)]
    return unsold.groupby("i_category").agg(
        n=("i_item_sk", "size")).reset_index()


# q09's join with a keyless count: items against sub-$1 sales

def cheap_sales_items_dataframe(s, t, how="anti"):
    """The items never sold under $1 (``how="anti"``, q09's join) or
    those that were (``"semi"``), counted. The 4-partition sales side is
    broadcast to the 1-partition item scan."""
    sold = (_sales(s, t)
            .filter(col("ss_sales_price") < 1.0)
            .select(col("ss_item_sk").alias("i_item_sk")))
    return (_dim(s, t, "item", columns=["i_item_sk"])
            .join(sold, on="i_item_sk", how=how)
            .group_by()
            .agg(F.count_star().alias("n")))


def _cheap_sales_items_oracle(p, how="anti"):
    import pandas as pd
    ss = p["store_sales"]
    sold = ss[ss.ss_sales_price < 1.0].ss_item_sk
    hit = p["item"].i_item_sk.isin(sold)
    return pd.DataFrame({"n": [int((~hit if how == "anti" else hit).sum())]})


# every join type over co-partitioned sides with unmatched rows on both

def outer_join_dataframe(s, t, how):
    """store_sales rows of quantity 1 under $10 joined on the item with
    the items priced under $150, both sides hash-partitioned 4 ways on
    the key: each side has rows the other does not match."""
    sales = (_sales(s, t)
             .filter((col("ss_quantity") == 1)
                     & (col("ss_sales_price") < 10.0))
             .select(col("ss_item_sk"), col("ss_customer_sk"),
                     col("ss_net_paid"))
             .repartition(4, "ss_item_sk"))
    items = (_dim(s, t, "item", columns=["i_item_sk", "i_current_price"])
             .filter(col("i_current_price") < 150.0)
             .select(col("i_item_sk").alias("ss_item_sk"),
                     col("i_current_price"))
             .repartition(4, "ss_item_sk"))
    return sales.join(items, on="ss_item_sk", how=how)


def _outer_join_oracle(p, how):
    """The join's rows in pandas (in no particular order). As in the
    reference, an unmatched item row keeps a null ``ss_item_sk``."""
    ss = p["store_sales"]
    sales = ss[(ss.ss_quantity == 1) & (ss.ss_sales_price < 10.0)][
        ["ss_item_sk", "ss_customer_sk", "ss_net_paid"]]
    it = p["item"]
    items = it[it.i_current_price < 150.0][["i_item_sk", "i_current_price"]] \
        .rename(columns={"i_item_sk": "ss_item_sk"})
    hit = sales.ss_item_sk.isin(items.ss_item_sk)
    if how == "existence":
        return sales.assign(exists=hit)
    if how in ("semi", "anti"):
        return sales[hit if how == "semi" else ~hit]
    m = sales.merge(items, on="ss_item_sk",
                    how={"full": "outer"}.get(how, how), indicator=True)
    m["ss_item_sk"] = m.ss_item_sk.astype("Int64").mask(
        m._merge == "right_only")
    return m.drop(columns="_merge")


# the right and full joins over a broadcast build side (ROADMAP Queue 3
# item 8): every probe partition emits the build rows it did not match

#: the reference's rows, in its order, as (k, x, y): 4 right and 7 full
#: rows, where a co-partitioned join gives 2 and 5
BROADCAST_OUTER_ROWS = {
    "right": [(None, None, 8), (None, None, 7), (2, 20, 7),
              (None, None, 8)],
    "full": [(1, 10, None), (3, 30, None), (None, None, 8),
             (None, None, 7), (2, 20, 7), (4, 40, None), (None, None, 8)],
}


def broadcast_outer_dataframe(s, how):
    """k = 1..4 in 2 round-robin partitions, joined with k in {2, 5} in
    one partition: the sides are not co-partitioned, so the build side
    is broadcast."""
    import pyarrow as pa
    probe = s.from_arrow(pa.table({"k": [1, 2, 3, 4],
                                   "x": [10, 20, 30, 40]})).repartition(2)
    build = s.from_arrow(pa.table({"k": [2, 5], "y": [7, 8]}))
    return probe.join(build, on="k", how=how)


# q10: agg → filter on the aggregate (HAVING)

def q10_dataframe(s, t):
    return (_sales(s, t)
            .group_by("ss_quantity")
            .agg(F.count_star().alias("n"),
                 F.avg(col("ss_sales_price")).alias("avg_price"))
            .filter(col("n") > 100))


def _q10_oracle(p):
    g = p["store_sales"].groupby("ss_quantity").agg(
        n=("ss_quantity", "size"),
        avg_price=("ss_sales_price", "mean")).reset_index()
    return g[g.n > 100]


# q11: union of two filtered branches → agg

def q11_dataframe(s, t):
    lo = (_sales(s, t)
          .filter(col("ss_sales_price") < 10.0)
          .select(col("ss_store_sk"), col("ss_quantity")))
    hi = (_sales(s, t)
          .filter(col("ss_sales_price") > 250.0)
          .select(col("ss_store_sk"), col("ss_quantity")))
    return (lo.union(hi)
            .group_by("ss_store_sk")
            .agg(F.sum(col("ss_quantity")).alias("qty"),
                 F.count_star().alias("n")))


def _q11_oracle(p):
    ss = p["store_sales"]
    u = ss[(ss.ss_sales_price < 10.0) | (ss.ss_sales_price > 250.0)]
    return u.groupby("ss_store_sk").agg(
        qty=("ss_quantity", "sum"),
        n=("ss_quantity", "size")).reset_index()


# q12: projection arithmetic with a cast → filter → global top-k by the
# computed column

def q12_dataframe(s, t):
    return (_sales(s, t)
            .select(col("ss_item_sk"),
                    (col("ss_sales_price")
                     * col("ss_quantity").cast(DataType.FLOAT64))
                    .alias("revenue"),
                    col("ss_net_profit"))
            .filter(col("ss_net_profit") > 0)
            .sort(col("revenue").desc(), col("ss_item_sk").asc(), limit=20))


def _q12_oracle(p):
    ss = p["store_sales"].copy()
    ss["revenue"] = ss.ss_sales_price * ss.ss_quantity
    f = ss[ss.ss_net_profit > 0][["ss_item_sk", "revenue", "ss_net_profit"]]
    return f.sort_values(["revenue", "ss_item_sk"],
                         ascending=[False, True]).head(20)


# q13: distinct buying customers per store (two nested aggs through two
# exchanges)

def q13_dataframe(s, t):
    per_cust = (_sales(s, t)
                .group_by("ss_store_sk", "ss_customer_sk")
                .agg(F.count_star().alias("_n")))
    return (per_cust
            .group_by("ss_store_sk")
            .agg(F.count(col("ss_customer_sk")).alias("buyers")))


def _q13_oracle(p):
    return p["store_sales"].groupby("ss_store_sk").agg(
        buyers=("ss_customer_sk", "nunique")).reset_index()


# q14: string functions over a dimension table (initcap, substring_index,
# concat_ws), then an aggregate on the derived string key and a sort

def q14_dataframe(s, t):
    return (_dim(s, t, "item")
            .select(col("i_item_sk"),
                    F.initcap(col("i_category")).alias("cat_title"),
                    F.substring_index(col("i_brand"), lit("#"), lit(1))
                    .alias("brand_name"),
                    F.concat_ws(lit("/"), col("i_category"),
                                col("i_brand")).alias("path"))
            .filter(col("i_item_sk") >= 0)
            .group_by("cat_title")
            .agg(F.count_star().alias("n"),
                 F.min(col("path")).alias("first_path"))
            .sort(col("cat_title").asc()))


def _q14_oracle(p):
    it = p["item"].copy()
    it["cat_title"] = it.i_category.str.title()
    it["path"] = it.i_category + "/" + it.i_brand
    g = (it.groupby("cat_title")
           .agg(n=("i_item_sk", "size"), first_path=("path", "min"))
           .reset_index())
    return g.sort_values("cat_title")[["cat_title", "n", "first_path"]]


# q15: wide decimals: cast to decimal(25,2) and decimal(20,0), multiply
# (Spark's type is decimal(38,2), on the limbs), sort on the product

def q15_dataframe(s, t, dsl=None):
    d = dsl or PORT_DSL
    col, T = d.col, d.DataType
    return (_sales(s, t)
            .select(col("ss_item_sk"),
                    (col("ss_sales_price").cast(T.DECIMAL, 25, 2)
                     * col("ss_quantity").cast(T.DECIMAL, 20, 0))
                    .alias("rev_dec"))
            .filter(col("ss_item_sk") < 50)
            .sort(col("rev_dec").desc(), col("ss_item_sk").asc(), limit=25))


def _q15_oracle(p):
    import decimal
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        ss = p["store_sales"]
        f = ss[ss.ss_item_sk < 50].copy()
        q = decimal.Decimal("0.01")
        f["rev_dec"] = [
            (decimal.Decimal(str(round(px, 2))).quantize(q)
             * decimal.Decimal(int(n)))
            for px, n in zip(f.ss_sales_price, f.ss_quantity)]
        out = f.sort_values(["rev_dec", "ss_item_sk"],
                            ascending=[False, True]).head(25)
        return out[["ss_item_sk", "rev_dec"]]


# decimal money: the store_sales money columns as decimals, aggregated
# per store

def decimal_money_dataframe(s, t, dsl=None):
    """Per store: ``price`` = ss_sales_price as decimal(7,2), ``paid`` =
    ss_net_paid as decimal(20,2) (two limbs; null rows stay null) and
    ``ext`` = price × ss_quantity as decimal(10,0), a decimal(18,2);
    then sum(price) → (17,2), avg(price) → (11,6), sum(paid) → (30,2),
    avg(paid) → (24,6), min and max of paid, count(paid) and sum(ext) →
    (28,2), which moves to the limbs; sorted by the store."""
    d = dsl or PORT_DSL
    col, F, T = d.col, d.F, d.DataType
    price = col("ss_sales_price").cast(T.DECIMAL, 7, 2)
    return (_sales(s, t)
            .select(col("ss_store_sk"), price.alias("price"),
                    col("ss_net_paid").cast(T.DECIMAL, 20, 2).alias("paid"),
                    (price * col("ss_quantity").cast(T.DECIMAL, 10, 0))
                    .alias("ext"))
            .group_by("ss_store_sk")
            .agg(F.sum(col("price")).alias("sum_price"),
                 F.avg(col("price")).alias("avg_price"),
                 F.sum(col("paid")).alias("sum_paid"),
                 F.avg(col("paid")).alias("avg_paid"),
                 F.min(col("paid")).alias("min_paid"),
                 F.max(col("paid")).alias("max_paid"),
                 F.count(col("paid")).alias("n_paid"),
                 F.sum(col("ext")).alias("sum_ext"))
            .sort(col("ss_store_sk").asc()))


#: the result fields' (precision, scale) of ``decimal_money_dataframe``
DECIMAL_MONEY_TYPES = {"sum_price": (17, 2), "avg_price": (11, 6),
                       "sum_paid": (30, 2), "avg_paid": (24, 6),
                       "min_paid": (20, 2), "max_paid": (20, 2),
                       "sum_ext": (28, 2)}


def _unscaled(values, scale: int):
    """Float money values cast to a decimal's unscaled ints, as the
    cast computes them: x * 10^scale rounded half to even in float64."""
    import numpy as np
    return np.round(np.asarray(values, np.float64) * 10.0 ** scale)


def _dec(unscaled: int, scale: int):
    import decimal
    with decimal.localcontext() as ctx:
        ctx.prec = 60
        return decimal.Decimal(int(unscaled)).scaleb(-scale)


def _avg_half_up(total: int, count: int, shift: int) -> int:
    """round(total * 10^shift / count), halves away from zero."""
    q = (abs(total) * 10 ** shift * 2 + count) // (2 * count)
    return q if total >= 0 else -q


def _by_key(keys, *columns):
    """The sorted distinct keys, each row's group start in key order, and
    the columns in that order (for ``np.ufunc.reduceat``)."""
    import numpy as np
    order = np.argsort(keys, kind="stable")
    uniq, starts = np.unique(keys[order], return_index=True)
    return uniq, starts, [c[order] for c in columns]


def _decimal_money_oracle(p):
    """Exact per-store integer sums, minima and maxima of the unscaled
    values (numpy int64: at TPC-DS SF10 a store's sum stays below 2^40),
    then Python's ``decimal`` for the values and the HALF_UP averages."""
    import numpy as np
    import pandas as pd
    ss = p["store_sales"]
    price = _unscaled(ss.ss_sales_price, 2).astype(np.int64)
    ok = ss.ss_net_paid.notna().to_numpy()
    paid = np.where(ok, _unscaled(ss.ss_net_paid.fillna(0.0), 2), 0) \
        .astype(np.int64)
    ext = price * ss.ss_quantity.to_numpy(np.int64)
    big = np.iinfo(np.int64)
    stores, starts, (pr, pd_, ok_, ex, lo, hi) = _by_key(
        ss.ss_store_sk.to_numpy(np.int64), price, paid, ok.astype(np.int64),
        ext, np.where(ok, paid, big.max), np.where(ok, paid, big.min))
    sums = {name: np.add.reduceat(a, starts).tolist()
            for name, a in (("price", pr), ("paid", pd_), ("n", ok_),
                            ("ext", ex))}
    rows_n = np.diff(np.append(starts, len(pr))).tolist()
    mins = np.minimum.reduceat(lo, starts).tolist()
    maxs = np.maximum.reduceat(hi, starts).tolist()
    rows = []
    for i, store in enumerate(stores.tolist()):
        n_paid = sums["n"][i]
        rows.append({
            "ss_store_sk": store,
            "sum_price": _dec(sums["price"][i], 2),
            "avg_price": _dec(_avg_half_up(sums["price"][i], rows_n[i], 4),
                              6),
            "sum_paid": _dec(sums["paid"][i], 2) if n_paid else None,
            "avg_paid": _dec(_avg_half_up(sums["paid"][i], n_paid, 4), 6)
            if n_paid else None,
            "min_paid": _dec(mins[i], 2) if n_paid else None,
            "max_paid": _dec(maxs[i], 2) if n_paid else None,
            "n_paid": n_paid,
            "sum_ext": _dec(sums["ext"][i], 2)})
    return pd.DataFrame(rows)


# a wide decimal group key: the hash table's limb keys, then a top-k
# sort on the key

def decimal_price_key_dataframe(s, t, dsl=None):
    """ss_sales_price as decimal(20,2) (two limbs) as the group key,
    with count(*) and sum(ss_quantity), the 100 largest keys."""
    d = dsl or PORT_DSL
    col, F, T = d.col, d.F, d.DataType
    return (_sales(s, t)
            .select(col("ss_sales_price").cast(T.DECIMAL, 20, 2)
                    .alias("price_key"), col("ss_quantity"))
            .group_by("price_key")
            .agg(F.count_star().alias("n"),
                 F.sum(col("ss_quantity")).alias("qty"))
            .sort(col("price_key").desc(), limit=100))


def _decimal_price_key_oracle(p):
    import numpy as np
    import pandas as pd
    ss = p["store_sales"]
    keys, starts, (q,) = _by_key(
        _unscaled(ss.ss_sales_price, 2).astype(np.int64),
        ss.ss_quantity.to_numpy(np.int64))
    n = np.diff(np.append(starts, len(q)))
    qty = np.add.reduceat(q, starts)
    keys, n, qty = keys[::-1][:100], n[::-1][:100], qty[::-1][:100]
    return pd.DataFrame({"price_key": [_dec(k, 2) for k in keys],
                         "n": n, "qty": qty})


# the expression sweep: every scalar function and node, over customer
# and item

#: the DataFrame DSL the sweep is written in; a test passes the JAX
#: package's to build the same query there
PORT_DSL = SimpleNamespace(col=col, lit=lit, F=F, ir=ir, Col=Col,
                           DataType=DataType)


def _sweep_customer(df, d):
    """Dates, timestamps, strings, LIKE, hashes and nulls over customer:
    c_customer_sk, c_birth_year, c_state (8 wide) and c_email (32 wide,
    ~2% null)."""
    col, lit, F, ir, T = d.col, d.lit, d.F, d.ir, d.DataType
    sk, by = col("c_customer_sk"), col("c_birth_year")
    st, em = col("c_state"), col("c_email")
    day = F.make_date(by, sk % 12 + 1, sk % 28 + 1)   # 1930–2004
    ts = (sk * 123456789 - 50_000_000_000_000).cast(T.TIMESTAMP_US)
    i_st = df.schema.index_of("c_state")
    i_sk = df.schema.index_of("c_customer_sk")
    bound = lambda i, n: d.ir.ColumnRef(i, n)
    case = d.Col(ir.CaseWhen(
        ((ir.BinaryExpr("==", bound(i_st, "c_state"),
                        ir.Literal("CA", T.STRING)),
          ir.Literal("California, the golden state", T.STRING)),
         (ir.BinaryExpr(">", bound(i_sk, "c_customer_sk"),
                        ir.Literal(500, T.INT64)), bound(i_st, "c_state"))),
        None))
    return df.select(
        sk, F.year(day).alias("year"), F.month(ts).alias("month"),
        F.day(day).alias("day"), F.dayofmonth(ts).alias("dayofmonth"),
        F.quarter(day).alias("quarter"), F.dayofweek(day).alias("dow"),
        F.dayofyear(ts).alias("doy"),
        F.date_add(day, sk % 40).alias("date_add"),
        F.date_sub(day, lit(3)).alias("date_sub"),
        F.datediff(day, F.make_date(lit(2000), lit(1), lit(1)))
        .alias("datediff"),
        F.hour(ts).alias("hour"), F.minute(ts).alias("minute"),
        F.second(ts).alias("second"),
        F.date_format(ts, lit("yyyy-MM-dd HH:mm:ss.SSS")).alias("fmt"),
        F.from_unixtime(sk * 3607).alias("from_unixtime"),
        F.to_unix_timestamp(ts).alias("to_unix"),
        F.unix_timestamp(day).alias("unix"),
        F.trunc(day, lit("quarter")).alias("trunc"),
        F.date_trunc(lit("week"), ts).alias("date_trunc"),
        F.add_months(day, sk % 25 - 12).alias("add_months"),
        F.last_day(day).alias("last_day"),
        F.months_between(ts, day).alias("months_between"),
        F.weekofyear(day).alias("weekofyear"),
        F.next_day(day, lit("Friday")).alias("next_day"),
        F.to_date(ts).alias("to_date"),
        F.length(em).alias("length"), F.char_length(st).alias("char_len"),
        F.upper(em).alias("upper"), F.lower(st).alias("lower"),
        F.trim(F.concat(lit("  "), st, lit(" "))).alias("trim"),
        F.ltrim(F.concat(lit(" "), st)).alias("ltrim"),
        F.rtrim(F.concat(st, lit("  "))).alias("rtrim"),
        F.substring(em, sk % 7 - 3, lit(5)).alias("substring"),
        F.substr(em, lit(3)).alias("substr"),
        F.concat(st, lit("-"), em).alias("concat"),
        F.concat_ws(lit("/"), st, em, st).alias("concat_ws"),
        F.initcap(F.concat_ws(lit(" "), st, em)).alias("initcap"),
        F.repeat(st, lit(3)).alias("repeat"), F.reverse(em).alias("reverse"),
        F.lpad(st, lit(6), lit("*")).alias("lpad"),
        F.rpad(em, lit(40), lit("ab")).alias("rpad"),
        F.left(em, lit(4)).alias("left"), F.right(em, sk % 5).alias("right"),
        F.space(lit(3)).alias("space"), F.ascii(em).alias("ascii"),
        F.chr(sk % 128).alias("chr"), F.char(by).alias("char"),
        F.instr(em, lit("@")).alias("instr"),
        F.locate(lit("e"), em, lit(3)).alias("locate"),
        F.position(lit("xa"), em).alias("position"),
        F.substring_index(em, lit("."), lit(-1)).alias("tld"),
        F.substring_index(em, lit("@"), lit(1)).alias("user"),
        F.substring_index(em, lit("ex"), lit(-1)).alias("after_ex"),
        F.translate(em, lit("aeiou"), lit("AE")).alias("translate"),
        em.like("c1%").alias("like_prefix"),
        em.like("%.com").alias("like_suffix"),
        em.like("%ample%").alias("like_infix"),
        em.like("c%@%com").alias("like_chain"),
        em.like("c_2%").alias("like_regex"),
        em.like("c12@example.com").alias("like_exact"),
        em.startswith("c9").alias("startswith"),
        em.endswith("7@example.com").alias("endswith"),
        em.contains("55").alias("contains"),
        case.alias("case_when"),
        d.Col(ir.Negative(bound(i_sk, "c_customer_sk"))).alias("negative"),
        F.hash(sk, st).alias("hash"), F.murmur3_hash(em).alias("murmur3"),
        F.xxhash64(em, by).alias("xxhash64"),
        F.coalesce(em, st).alias("coalesce"),
        F.nullif(st, lit("TX")).alias("nullif"),
        F.if_(sk % 3 == 0, em, st).alias("if"))


def _sweep_item(df, d):
    """Math, nulls, casts between strings, numbers and dates, split and
    the host parses over item: i_item_sk, i_category (16 wide), i_brand
    ('brand#NNN') and i_current_price (0.5–300)."""
    col, lit, F, ir, T = d.col, d.lit, d.F, d.ir, d.DataType
    it, pr = col("i_item_sk"), col("i_current_price")
    cat, br = col("i_category"), col("i_brand")
    i_it = df.schema.index_of("i_item_sk")
    i_pr = df.schema.index_of("i_current_price")
    i_cat = df.schema.index_of("i_category")
    i_br = df.schema.index_of("i_brand")
    num = F.substring_index(br, lit("#"), lit(-1))          # '027'
    ds = F.concat(lit("19"), F.substring(br, lit(-2), lit(2)), lit("-"),
                  (it % 12 + 1).cast(T.STRING), lit("-"),
                  (it % 28 + 1).cast(T.STRING))              # '1927-3-5'
    day = ds.cast(T.DATE32)
    case = d.Col(ir.CaseWhen(
        ((ir.BinaryExpr(">", ir.ColumnRef(i_pr, "i_current_price"),
                        ir.Literal(200.0, T.FLOAT64)),
          ir.ColumnRef(i_cat, "i_category")),
         (ir.BinaryExpr(">", ir.ColumnRef(i_pr, "i_current_price"),
                        ir.Literal(100.0, T.FLOAT64)),
          ir.Literal("a much longer literal, 32 wide", T.STRING))),
        ir.ColumnRef(i_br, "i_brand")))
    return df.select(
        it, F.abs(pr - 150.0).alias("abs"), F.sqrt(pr - 20.0).alias("sqrt"),
        F.floor(pr).alias("floor"), F.ceil(pr * -1.0).alias("ceil"),
        F.round(pr, lit(1)).alias("round"), F.bround(pr).alias("bround"),
        F.pow(pr, lit(0.5)).alias("u_pow"),
        F.power(it % 7, lit(2)).alias("u_power"),
        F.exp(pr / 100.0).alias("u_exp"), F.log(pr - 100.0).alias("u_log"),
        F.ln(pr).alias("u_ln"),
        F.isnan(F.sqrt(pr - 150.0)).alias("isnan"),
        F.nanvl(F.sqrt(pr - 150.0), lit(-1.0)).alias("nanvl"),
        F.normalize_nan_and_zero((pr - pr) * -1.0).alias("normalize"),
        F.greatest(pr, lit(100.0)).alias("greatest"),
        F.least(it % 17, it % 5).alias("least"),
        F.sin(pr).alias("u_sin"), F.cos(pr).alias("u_cos"),
        F.tan(pr).alias("u_tan"), F.asin(pr / 300.0).alias("u_asin"),
        F.acos(pr / 300.0).alias("u_acos"), F.atan(pr).alias("u_atan"),
        F.sinh(pr / 50.0).alias("u_sinh"), F.cosh(pr / 50.0).alias("u_cosh"),
        F.tanh(pr / 100.0).alias("u_tanh"), F.log10(pr).alias("u_log10"),
        F.log2(pr).alias("u_log2"), F.log1p(pr).alias("u_log1p"),
        F.expm1(pr / 100.0).alias("u_expm1"),
        F.cbrt(pr - 150.0).alias("u_cbrt"), F.degrees(pr).alias("degrees"),
        F.radians(pr).alias("radians"), F.rint(pr).alias("rint"),
        F.signum(pr - 150.0).alias("signum"),
        F.sign(it % 5 - 2).alias("sign"),
        F.atan2(pr, it % 11 - 5).alias("u_atan2"),
        F.hypot(pr, it % 7).alias("u_hypot"), F.pi().alias("pi"),
        F.e().alias("e"), F.pmod(it, lit(-7)).alias("pmod"),
        F.pmod(pr, lit(7.5)).alias("pmod_f"),
        F.factorial(it % 25).alias("factorial"),
        F.coalesce(F.nullif(it % 3, lit(0)), lit(-1)).alias("coalesce"),
        F.null_if(F.floor(pr), lit(100)).alias("null_if"),
        F.if_(pr > 150.0, cat, br).alias("if"),
        case.alias("case_when"),
        d.Col(ir.Negative(ir.ColumnRef(i_it, "i_item_sk"))).alias("neg"),
        d.Col(ir.Negative(ir.ColumnRef(i_pr, "i_current_price")))
        .alias("neg_f"),
        num.cast(T.INT32).alias("str_int"),
        num.cast(T.FLOAT64).alias("str_float"),
        br.cast(T.INT64).alias("str_bad_int"),
        (it % 2).cast(T.STRING).cast(T.BOOL).alias("str_bool"),
        day.alias("str_date"), day.cast(T.STRING).alias("date_str"),
        day.cast(T.TIMESTAMP_US).alias("date_ts"),
        F.concat(day.cast(T.STRING), lit(" 10:11:12")).cast(T.TIMESTAMP_US)
        .cast(T.STRING).alias("ts_str"),
        F.concat(day.cast(T.STRING), lit(" 23:59:59")).cast(T.TIMESTAMP_US)
        .cast(T.DATE32).alias("ts_date"),
        (pr > 100.0).cast(T.STRING).alias("bool_str"),
        pr.cast(T.STRING).alias("float_str"),
        pr.cast(T.FLOAT32).cast(T.STRING).alias("f32_str"),
        it.cast(T.STRING).alias("int_str"),
        pr.cast(T.STRING).cast(T.FLOAT64).alias("float_round_trip"),
        F.split(br, lit("#")).getitem(1).alias("split"),
        F.unix_timestamp(F.concat(ds, lit(" 00:00:00")),
                         lit("yyyy-MM-dd HH:mm:ss")).alias("unix_str"),
        F.to_date(ds, lit("yyyy-MM-dd")).alias("to_date_fmt"),
        F.hash(it, cat).alias("hash"), F.xxhash64(pr, cat).alias("xxhash"))


def expression_sweep_dataframe(s, t, table: str = "customer", dsl=None):
    """A select over ``table`` ('customer' or 'item') after a filter
    that keeps one row in seven; the two tables' selects together call
    every scalar function the port registers and every expression node
    of ``exprs/ir.py`` (string casts, the three LIKE classes, CASE WHEN
    with string branches of different widths). ``dsl`` is the
    DataFrame DSL to build it in (``PORT_DSL`` by default)."""
    d = dsl or PORT_DSL
    key = {"customer": "c_customer_sk", "item": "i_item_sk"}[table]
    df = s.read_parquet(t[table]).filter(d.col(key) % 7 == 3)
    return (_sweep_customer if table == "customer" else _sweep_item)(df, d)


# q16: window functions: rank within the store by revenue (an exchange
# on the partition keys, the TPC-DS windowed-rank class)

def q16_dataframe(s, t):
    per_item = (_sales(s, t)
                .group_by("ss_store_sk", "ss_item_sk")
                .agg(F.sum(col("ss_sales_price")).alias("rev")))
    return (per_item
            .window([F.rank().alias("rnk")],
                    partition_by=[col("ss_store_sk")],
                    order_by=[col("rev").desc()])
            .filter(col("rnk") <= 3)
            .sort(col("ss_store_sk").asc(), col("rnk").asc(),
                  col("ss_item_sk").asc()))


def _q16_oracle(p):
    ss = p["store_sales"]
    g = (ss.groupby(["ss_store_sk", "ss_item_sk"])
           .agg(rev=("ss_sales_price", "sum")).reset_index())
    g["rnk"] = g.groupby("ss_store_sk")["rev"] \
        .rank(method="min", ascending=False).astype("int64")
    f = g[g.rnk <= 3]
    return f.sort_values(["ss_store_sk", "rnk", "ss_item_sk"])[
        ["ss_store_sk", "ss_item_sk", "rev", "rnk"]]


# rollup → rank, q67's shape over the port's tables: a broadcast join on
# the item, a rollup of (category, brand), the top 5 of each category by
# revenue

ROLLUP_RANK_TOP = 5


def rollup_rank_dataframe(s, t, dsl=None):
    """store_sales ⋈ item (item broadcast), ``amt`` = price × quantity as
    float64, ``rollup(i_category, i_brand)`` of ``sum(amt)``, ``rank()``
    within the category by the sum descending, the rows of rank <= 5,
    sorted by (category, rank, brand). A category's rolled-up row (its
    brand null, ``spark_grouping_id`` 1) ranks 1 in its category; the
    grand total (both null, id 3) is the one row of the null category."""
    d = dsl or PORT_DSL
    col, F, T = d.col, d.F, d.DataType
    item = _dim(s, t, "item", ["i_item_sk", "i_category", "i_brand"]) \
        .select(col("i_item_sk").alias("ss_item_sk"), col("i_category"),
                col("i_brand"))
    sales = _sales(s, t).select(
        col("ss_item_sk"),
        (col("ss_sales_price") * col("ss_quantity")).cast(T.FLOAT64)
        .alias("amt"))
    return (sales.join(item, on="ss_item_sk")
            .rollup("i_category", "i_brand")
            .agg(F.sum(col("amt")).alias("total"))
            .window([F.rank().alias("rk")],
                    partition_by=[col("i_category")],
                    order_by=[col("total").desc()])
            .filter(col("rk") <= ROLLUP_RANK_TOP)
            .sort(col("i_category").asc(), col("rk").asc(),
                  col("i_brand").asc()))


def _rollup_rank_oracle(p):
    import pandas as pd
    ss, it = p["store_sales"], p["item"]
    j = ss.merge(it, left_on="ss_item_sk", right_on="i_item_sk")
    j = j.assign(amt=j.ss_sales_price * j.ss_quantity)
    levels = [
        j.groupby(["i_category", "i_brand"]).amt.sum().reset_index()
        .assign(spark_grouping_id=0),
        j.groupby("i_category").amt.sum().reset_index()
        .assign(i_brand=None, spark_grouping_id=1),
        pd.DataFrame({"i_category": [None], "i_brand": [None],
                      "amt": [j.amt.sum()], "spark_grouping_id": [3]}),
    ]
    g = pd.concat(levels, ignore_index=True).rename(columns={"amt": "total"})
    g["spark_grouping_id"] = g.spark_grouping_id.astype("int32")
    g["rk"] = g.groupby("i_category", dropna=False)["total"] \
        .rank(method="min", ascending=False).astype("int64")
    f = g[g.rk <= ROLLUP_RANK_TOP]
    f = f.sort_values(["i_category", "rk", "i_brand"],
                      na_position="first")
    return f[["i_category", "i_brand", "spark_grouping_id", "total", "rk"]]


# the window sweep: every window function over the joined tables

#: a row's identity in the window sweep: unique within a partition, so
#: no row-level result depends on the order of ties
WINDOW_SWEEP_ROW = ("ss_sold_date_sk", "ss_customer_sk", "ss_item_sk",
                    "ss_quantity", "ss_net_profit")


def window_sweep_dataframes(s, t) -> dict:
    """{name: DataFrame}: every function of ``ops.window``'s
    ``RANK_LIKE``, ``OFFSET_FNS`` and ``AGG_FNS`` over a quarter of the
    stores' sales joined with item and customer (both broadcast). The
    values: ``ss_quantity`` (int64), ``vf`` (``ss_net_paid``, float64
    with nulls, and on a few rows NaN in one category, +inf in another,
    -inf in that one and a third), ``c_email``
    (string), ``dn`` (decimal(7,2)) and ``dm`` (decimal(12,2), whose sum
    moves to the limbs); partition keys ``i_category`` (string),
    ``ss_store_sk`` or none. A column named ``f_*`` is a float64 sum or
    average whose rounding depends on the order of its terms; its
    ``a_*`` twin sums the terms' absolute values over the same frame,
    the scale of its tolerance.

    - ``peers``: ORDER BY ``ss_quantity`` desc, whose ties share the
      ranks and the running aggregates;
    - ``rows``: ORDER BY the row's identity: row numbers, offsets (a
      string default), ROWS frames ``(-1, 1)`` and ``(-3, 0)``;
    - ``whole``: no ORDER BY, the store's whole partition;
    - ``global``: no partition key, the sales of items below 200;
    - ``group_limit``: the 3 largest profits of each (category, brand);
    - ``cube``: a cube over (category, quantity, store) of exact
      aggregates, then ranks within each grouping set."""
    from auron_tpu_torch.ops.window import AGG_FNS, OFFSET_FNS, RANK_LIKE
    assert len(RANK_LIKE) + len(OFFSET_FNS) + len(AGG_FNS) == 17
    nan, inf = float("nan"), float("inf")
    item = _dim(s, t, "item", ["i_item_sk", "i_category", "i_brand"]) \
        .select(col("i_item_sk").alias("ss_item_sk"), col("i_category"),
                col("i_brand"))
    cust = _dim(s, t, "customer", ["c_customer_sk", "c_email"]) \
        .select(col("c_customer_sk").alias("ss_customer_sk"),
                col("c_email"))
    q, k, cat = col("ss_quantity"), col("ss_item_sk"), col("i_category")
    # NaN in Music, +inf in Shoes, -inf in Home and Shoes, on a few rows
    vf = F.if_((q == 19) & (k % 50 == 0) & (cat == "Music"), lit(nan),
               F.if_((q == 18) & (k % 40 == 0) & (cat == "Shoes"), lit(inf),
                     F.if_((q == 17) & (k % 45 == 0)
                           & cat.isin("Home", "Shoes"), lit(-inf),
                           col("ss_net_paid"))))
    price = col("ss_sales_price")
    base = (_sales(s, t).filter(col("ss_store_sk") % 4 == 0)
            .join(item, on="ss_item_sk").join(cust, on="ss_customer_sk")
            .select(*[col(c) for c in WINDOW_SWEEP_ROW], col("ss_store_sk"),
                    cat, col("i_brand"), col("c_email"),
                    vf.alias("vf"),
                    price.cast(DataType.DECIMAL, 7, 2).alias("dn"),
                    price.cast(DataType.DECIMAL, 12, 2).alias("dm")))
    vf, dn, dm, em = col("vf"), col("dn"), col("dm"), col("c_email")
    absf = F.abs(vf)
    row = [col(c).asc() for c in WINDOW_SWEEP_ROW]

    def agg(fn, c=None, frame=None, name=None):
        return F.win_agg(fn, c, frame=frame).alias(name)

    out = {
        "peers": base.window(
            [F.rank().alias("rank"), F.dense_rank().alias("dense_rank"),
             F.percent_rank().alias("percent_rank"),
             F.cume_dist().alias("cume_dist"),
             agg("sum", q, name="sum_q"), agg("avg", q, name="avg_q"),
             agg("count", vf, name="count_vf"),
             agg("count_star", name="count_star"),
             agg("min", vf, name="min_vf"), agg("max", vf, name="max_vf"),
             agg("sum", dn, name="sum_dn"), agg("avg", dn, name="avg_dn"),
             agg("sum", dm, name="sum_dm"), agg("max", dm, name="max_dm"),
             agg("sum", vf, name="f_sum_vf"), agg("avg", vf, name="f_avg_vf"),
             agg("sum", absf, name="a_sum_vf"),
             agg("avg", absf, name="a_avg_vf")],
            partition_by=["i_category"], order_by=[q.desc()]),
        "rows": base.window(
            [F.row_number().alias("row_number"),
             F.ntile(5).alias("ntile"),
             F.lead(q, 2, default=-1).alias("lead_q"),
             F.lag(vf).alias("lag_vf"),
             F.lag(em, 1, default="none@example.com").alias("lag_email"),
             F.lead(dn).alias("lead_dn"),
             F.first_value(em).alias("first_email"),
             F.last_value(vf).alias("last_vf"),
             F.nth_value(q, 3).alias("nth_q"),
             agg("sum", q, (-1, 1), "sum_q_c"),
             agg("count", vf, (-1, 1), "count_vf_c"),
             agg("count_star", None, (-1, 1), "count_c"),
             agg("avg", dn, (-1, 1), "avg_dn_c"),
             agg("sum", dm, (-3, 0), "sum_dm_t"),
             agg("avg", q, (-3, 0), "avg_q_t"),
             agg("sum", vf, (-1, 1), "f_sum_vf_c"),
             agg("sum", absf, (-1, 1), "a_sum_vf_c"),
             agg("avg", vf, (-3, 0), "f_avg_vf_t"),
             agg("avg", absf, (-3, 0), "a_avg_vf_t")],
            partition_by=["i_category"], order_by=row),
        "whole": base.window(
            [F.rank().alias("rank"), F.cume_dist().alias("cume_dist"),
             agg("sum", q, name="sum_q"), agg("count", em, name="count_em"),
             agg("min", dn, name="min_dn"), agg("max", vf, name="max_vf"),
             agg("sum", dm, name="sum_dm"),
             agg("avg", vf, name="f_avg_vf"),
             agg("avg", absf, name="a_avg_vf")],
            partition_by=["ss_store_sk"]),
        "global": base.filter(k < 200).window(
            [F.row_number().alias("row_number"),
             F.lag(vf).alias("lag_vf"), agg("max", dn, name="max_dn"),
             agg("sum", vf, name="f_sum_vf"),
             agg("sum", absf, name="a_sum_vf")],
            order_by=row),
        "group_limit": base.window(
            [F.rank().alias("rank")],
            partition_by=["i_category", "i_brand"],
            order_by=[col("ss_net_profit").desc()], group_limit=3),
        "cube": base.cube("i_category", "ss_quantity", "ss_store_sk")
        .agg(F.count_star().alias("n"), F.sum(q).alias("qty"),
             F.sum(dm).alias("amount"))
        .window([F.rank().alias("rank"), F.dense_rank().alias("dense")],
                partition_by=["spark_grouping_id"],
                order_by=[col("n").desc()]),
    }
    return out


# the in-memory query: one partition, a complete agg over the memory scan

def store_quantity_dataframe(s, table):
    """Rows and total quantity per store over ``Session.from_arrow`` of
    a store_sales table."""
    return (s.from_arrow(table)
            .group_by("ss_store_sk")
            .agg(F.count_star().alias("n"),
                 F.sum(col("ss_quantity")).alias("qty")))


def _store_quantity_oracle(p):
    return p["store_sales"].groupby("ss_store_sk").agg(
        n=("ss_quantity", "size"),
        qty=("ss_quantity", "sum")).reset_index()


QUERIES = [
    Query("q01_filter_agg", "scan→filter→two-phase agg", q01_dataframe,
          _q01_oracle),
    Query("q02_topk_revenue", "agg→exchange→global sort+limit",
          q02_dataframe, _q02_oracle),
    Query("q03_item_join_agg", "co-partitioned join→agg (IN filter)",
          q03_dataframe, _q03_oracle),
    Query("q04_store_join_agg", "join→agg by dim attribute", q04_dataframe,
          _q04_oracle),
    Query("q05_date_filter_join", "filtered dim join→agg", q05_dataframe,
          _q05_oracle),
    Query("q06_string_minmax", "join→min/max(string) agg", q06_dataframe,
          _q06_oracle),
    Query("q07_three_table", "3-table join→composite agg→top-k",
          q07_dataframe, _q07_oracle),
    Query("q08_semi_join", "semi join→agg", q08_dataframe, _q08_oracle),
    Query("q09_anti_join", "anti join→agg", q09_dataframe, _q09_oracle),
    Query("q10_having", "agg→filter-on-aggregate", q10_dataframe,
          _q10_oracle),
    Query("q11_union", "union of branches→agg", q11_dataframe, _q11_oracle),
    Query("q12_computed_topk", "project arithmetic→top-k", q12_dataframe,
          _q12_oracle),
    Query("q14_string_functions", "round-3 string fns→agg", q14_dataframe,
          _q14_oracle),
    Query("q15_wide_decimal", "decimal(>18) arith→sort", q15_dataframe,
          _q15_oracle),
    Query("q16_window_rank", "window rank→filter→sort", q16_dataframe,
          _q16_oracle),
    Query("q13_distinct_buyers", "nested aggs through exchange",
          q13_dataframe, _q13_oracle),
]
