"""TPC-DS-class integration queries the port can run.

Copies of ``auron_tpu.it.queries``'s q01, q02, q05, q10, q11, q12 and
q13, with their pandas oracles. Each query runs through the whole front
end: DataFrame DSL → protobuf TaskDefinition → physical planner →
operators (``ShuffleExchangeOp`` stages and hash joins included).
More queries of the same shapes:

- ``store_quantity_dataframe``, over an in-memory table
  (``Session.from_arrow``), whose single partition lets the planner
  derive a dense key domain;
- ``q05_dataframe(co_partitioned=False)``, q05 without its two
  repartitions, whose date_dim side is broadcast;
- ``cheap_sales_items_dataframe``, q09's anti join (or its semi join)
  with a keyless count, since q09 groups on a string;
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
    Query("q05_date_filter_join", "filtered dim join→agg", q05_dataframe,
          _q05_oracle),
    Query("q10_having", "agg→filter-on-aggregate", q10_dataframe,
          _q10_oracle),
    Query("q11_union", "union of branches→agg", q11_dataframe, _q11_oracle),
    Query("q12_computed_topk", "project arithmetic→top-k", q12_dataframe,
          _q12_oracle),
    Query("q13_distinct_buyers", "nested aggs through exchange",
          q13_dataframe, _q13_oracle),
]
