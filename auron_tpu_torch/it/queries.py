"""TPC-DS-class integration queries the port can run.

Copies of ``auron_tpu.it.queries``'s q01, q02, q10, q11, q12 and q13,
with their pandas oracles. Each query runs through the whole front end:
DataFrame DSL → protobuf TaskDefinition → physical planner → operators
(``ShuffleExchangeOp`` stages included). ``store_quantity_dataframe``
is one more query over an in-memory table (``Session.from_arrow``),
whose single partition lets the planner derive a dense key domain.

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
    Query("q10_having", "agg→filter-on-aggregate", q10_dataframe,
          _q10_oracle),
    Query("q11_union", "union of branches→agg", q11_dataframe, _q11_oracle),
    Query("q12_computed_topk", "project arithmetic→top-k", q12_dataframe,
          _q12_oracle),
    Query("q13_distinct_buyers", "nested aggs through exchange",
          q13_dataframe, _q13_oracle),
]
