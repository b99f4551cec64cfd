"""TPC-DS-class integration queries the port can run.

Copies of ``auron_tpu.it.queries``'s q01 to q13, with their pandas
oracles (q03, q04 and q06 to q09 group, filter or sort on strings). Each
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
  broadcast build side whose rows are ``BROADCAST_OUTER_ROWS``.

pyarrow and pandas are imported inside the functions.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.frontend.dataframe import col
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
    Query("q13_distinct_buyers", "nested aggs through exchange",
          q13_dataframe, _q13_oracle),
]
