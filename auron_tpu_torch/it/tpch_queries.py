"""TPC-H q5 / q9 / q18 over the it/tpch.py dataset — the join-heavy
BASELINE.md targets, expressed in the DataFrame DSL and diffed against
independent pandas oracles (reference gate analogue:
dev/auron-it's TPC-DS differ, Main.scala:60-128).

The port's copy of ``auron_tpu.it.tpch_queries``: the same queries and
oracles, built in the port's DSL."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import pyarrow as pa

from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.frontend.dataframe import col, functions as F, lit

#: epoch days of the q5/q9 date parameters
_D1994 = (np.datetime64("1994-01-01")
          - np.datetime64("1970-01-01")).astype(int)
_D1995 = (np.datetime64("1995-01-01")
          - np.datetime64("1970-01-01")).astype(int)


@dataclass(frozen=True)
class Query:
    name: str
    description: str
    run: Callable
    oracle: Callable


QUERIES: list = []


def _q(name, description):
    def deco(fns):
        run, oracle = fns
        QUERIES.append(Query(name, description, run, oracle))
        return fns
    return deco


def _rd(s, t, name):
    parts = 4 if name == "lineitem" else (2 if name == "orders" else 1)
    return s.read_parquet(t[name], partitions=parts)


def _rename(df, **kw):
    cols = []
    for f in df.schema:
        cols.append(col(f.name).alias(kw.get(f.name, f.name)))
    return df.select(*cols)


def _join(fact, dim, fk, dk, how="inner"):
    return fact.join(_rename(dim, **{dk: fk}), on=fk, how=how)


def _pd(a):
    return {k: t.to_pandas() for k, t in a.items()}


# --- q5: local supplier volume (6-way join, region+year filters) ----------

def _q5_run(s, t):
    li = _rd(s, t, "lineitem").select("l_orderkey", "l_suppkey",
                                      "l_extendedprice", "l_discount")
    o = _rd(s, t, "orders").filter(
        (col("o_orderdate") >= lit(int(_D1994), DataType.DATE32))
        & (col("o_orderdate") < lit(int(_D1995), DataType.DATE32))) \
        .select("o_orderkey", "o_custkey")
    c = _rd(s, t, "customer").select("c_custkey", "c_nationkey")
    su = _rd(s, t, "supplier").select("s_suppkey", "s_nationkey")
    n = _rd(s, t, "nation").select("n_nationkey", "n_name", "n_regionkey")
    r = _rd(s, t, "region").filter(col("r_name") == "ASIA") \
        .select("r_regionkey")
    j = _join(li, o, "l_orderkey", "o_orderkey")
    j = _join(j, c, "o_custkey", "c_custkey")
    j = _join(j, su, "l_suppkey", "s_suppkey")
    # TPC-H q5: customer and supplier must share the nation
    j = j.filter(col("c_nationkey") == col("s_nationkey"))
    j = _join(j, n, "s_nationkey", "n_nationkey")
    j = _join(j, r, "n_regionkey", "r_regionkey")
    rev = (col("l_extendedprice").cast(DataType.FLOAT64)
           * (lit(1.0) - col("l_discount").cast(DataType.FLOAT64)))
    j = j.with_column("rev", rev)
    return (j.group_by("n_name").agg(F.sum(col("rev")).alias("revenue"))
            .sort(col("revenue").desc(), col("n_name").asc())
            .limit(100).collect())


def _q5_oracle(a):
    p = _pd(a)
    o = p["orders"]
    o = o[(o.o_orderdate >= np.datetime64("1994-01-01"))
          & (o.o_orderdate < np.datetime64("1995-01-01"))]
    j = p["lineitem"].merge(o, left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(p["customer"], left_on="o_custkey", right_on="c_custkey")
    j = j.merge(p["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    j = j[j.c_nationkey == j.s_nationkey]
    j = j.merge(p["nation"], left_on="s_nationkey",
                right_on="n_nationkey")
    r = p["region"]
    j = j.merge(r[r.r_name == "ASIA"], left_on="n_regionkey",
                right_on="r_regionkey")
    j["rev"] = j.l_extendedprice.astype(float) \
        * (1.0 - j.l_discount.astype(float))
    g = j.groupby("n_name")["rev"].sum().reset_index() \
        .rename(columns={"rev": "revenue"})
    g = g.sort_values(["revenue", "n_name"],
                      ascending=[False, True]).head(100)
    return pa.Table.from_pandas(g.reset_index(drop=True),
                                preserve_index=False)


_q("q5", "local supplier volume in ASIA (6-way join)")(
    (_q5_run, _q5_oracle))


# --- q9: product-type profit by nation and year ---------------------------

def _q9_run(s, t):
    li = _rd(s, t, "lineitem").select(
        "l_orderkey", "l_partkey", "l_suppkey", "l_quantity",
        "l_extendedprice", "l_discount")
    pt = _rd(s, t, "part").filter(col("p_name").contains("green")) \
        .select("p_partkey")
    su = _rd(s, t, "supplier").select("s_suppkey", "s_nationkey")
    ps = _rd(s, t, "partsupp").select("ps_partkey", "ps_suppkey",
                                      "ps_supplycost")
    o = _rd(s, t, "orders").select("o_orderkey", "o_orderdate")
    n = _rd(s, t, "nation").select("n_nationkey", "n_name")
    j = _join(li, pt, "l_partkey", "p_partkey")
    j = _join(j, su, "l_suppkey", "s_suppkey")
    # partsupp join on BOTH keys
    ps2 = _rename(ps, ps_partkey="l_partkey", ps_suppkey="l_suppkey")
    j = j.join(ps2, on=["l_partkey", "l_suppkey"], how="inner")
    j = _join(j, o, "l_orderkey", "o_orderkey")
    j = _join(j, n, "s_nationkey", "n_nationkey")
    amount = (col("l_extendedprice").cast(DataType.FLOAT64)
              * (lit(1.0) - col("l_discount").cast(DataType.FLOAT64))
              - col("ps_supplycost").cast(DataType.FLOAT64)
              * col("l_quantity").cast(DataType.FLOAT64))
    j = j.with_column("amount", amount)
    j = j.with_column("o_year",
                      F.year(col("o_orderdate").cast(DataType.DATE32)))
    g = (j.group_by("n_name", "o_year")
         .agg(F.sum(col("amount")).alias("sum_profit")))
    return (g.sort(col("n_name").asc(), col("o_year").desc())
            .limit(200).collect())


def _q9_oracle(a):
    p = _pd(a)
    pt = p["part"]
    pt = pt[pt.p_name.str.contains("green")]
    j = p["lineitem"].merge(pt[["p_partkey"]], left_on="l_partkey",
                            right_on="p_partkey")
    j = j.merge(p["supplier"], left_on="l_suppkey", right_on="s_suppkey")
    j = j.merge(p["partsupp"],
                left_on=["l_partkey", "l_suppkey"],
                right_on=["ps_partkey", "ps_suppkey"])
    j = j.merge(p["orders"], left_on="l_orderkey", right_on="o_orderkey")
    j = j.merge(p["nation"], left_on="s_nationkey",
                right_on="n_nationkey")
    j["amount"] = (j.l_extendedprice.astype(float)
                   * (1.0 - j.l_discount.astype(float))
                   - j.ps_supplycost.astype(float)
                   * j.l_quantity.astype(float))
    j["o_year"] = j.o_orderdate.map(lambda d: d.year).astype("int64")
    g = j.groupby(["n_name", "o_year"])["amount"].sum().reset_index() \
        .rename(columns={"amount": "sum_profit"})
    g = g.sort_values(["n_name", "o_year"],
                      ascending=[True, False]).head(200)
    return pa.Table.from_pandas(g.reset_index(drop=True),
                                preserve_index=False)


_q("q9", "product-type profit by nation/year ('green' parts, 6-way)")(
    (_q9_run, _q9_oracle))


# --- q18: large-volume customers (agg-filtered IN as semi join) -----------

_Q18_QTY = 180


def _q18_run(s, t):
    li = _rd(s, t, "lineitem").select("l_orderkey", "l_quantity")
    big = (li.group_by("l_orderkey")
           .agg(F.sum(col("l_quantity")).alias("sum_qty"))
           .filter(col("sum_qty") > lit(_Q18_QTY, DataType.INT64))
           .select("l_orderkey"))
    o = _rd(s, t, "orders").select("o_orderkey", "o_custkey",
                                   "o_orderdate", "o_totalprice")
    o = o.join(_rename(big, l_orderkey="o_orderkey"), on="o_orderkey",
               how="semi")
    c = _rd(s, t, "customer").select("c_custkey", "c_name")
    j = _join(o, c, "o_custkey", "c_custkey")
    li2 = _rd(s, t, "lineitem").select(
        col("l_orderkey").alias("o_orderkey"), col("l_quantity"))
    j = j.join(li2, on="o_orderkey", how="inner")
    # the USING-style join dropped c_custkey; o_custkey carries the value
    g = (j.group_by("c_name", col("o_custkey").alias("c_custkey"),
                    "o_orderkey", "o_orderdate", "o_totalprice")
         .agg(F.sum(col("l_quantity")).alias("sum_qty")))
    return (g.sort(col("o_totalprice").cast(DataType.FLOAT64).desc(),
                   col("o_orderdate").asc(), col("o_orderkey").asc())
            .limit(100).collect())


def _q18_oracle(a):
    p = _pd(a)
    li = p["lineitem"]
    big = li.groupby("l_orderkey")["l_quantity"].sum()
    big = big[big > _Q18_QTY].index
    o = p["orders"]
    o = o[o.o_orderkey.isin(big)]
    j = o.merge(p["customer"], left_on="o_custkey", right_on="c_custkey")
    j = j.merge(li[["l_orderkey", "l_quantity"]],
                left_on="o_orderkey", right_on="l_orderkey")
    g = j.groupby(["c_name", "c_custkey", "o_orderkey", "o_orderdate",
                   "o_totalprice"])["l_quantity"].sum().reset_index() \
        .rename(columns={"l_quantity": "sum_qty"})
    g["tp"] = g.o_totalprice.astype(float)
    g = g.sort_values(["tp", "o_orderdate", "o_orderkey"],
                      ascending=[False, True, True]).head(100) \
        .drop(columns=["tp"])
    g["o_orderdate"] = g["o_orderdate"].astype("datetime64[s]").dt.date
    return pa.Table.from_pandas(g.reset_index(drop=True),
                                preserve_index=False)


_q("q18", "large-volume customers (agg-filtered semi join)")(
    (_q18_run, _q18_oracle))


# --- q1: pricing summary report -------------------------------------------

def _q1_run(s, t):
    li = _rd(s, t, "lineitem").select(
        "l_quantity", "l_extendedprice", "l_discount", "l_tax",
        "l_returnflag", "l_linestatus", "l_shipdate")
    cutoff = int(np.datetime64("1998-06-02").astype("datetime64[D]")
                 .astype(int))
    li = li.filter(col("l_shipdate") <= lit(cutoff, DataType.DATE32))
    price = col("l_extendedprice").cast(DataType.FLOAT64)
    disc = col("l_discount").cast(DataType.FLOAT64)
    tax = col("l_tax").cast(DataType.FLOAT64)
    li = li.with_column("disc_price", price * (lit(1.0) - disc))
    li = li.with_column("charge",
                        col("disc_price") * (lit(1.0) + tax))
    g = (li.group_by("l_returnflag", "l_linestatus")
         .agg(F.sum(col("l_quantity")).alias("sum_qty"),
              F.sum(price).alias("sum_base_price"),
              F.sum(col("disc_price")).alias("sum_disc_price"),
              F.sum(col("charge")).alias("sum_charge"),
              F.avg(col("l_quantity").cast(DataType.FLOAT64))
              .alias("avg_qty"),
              F.avg(price).alias("avg_price"),
              F.avg(disc).alias("avg_disc"),
              F.count_star().alias("count_order")))
    return (g.sort(col("l_returnflag").asc(), col("l_linestatus").asc())
            .collect())


def _q1_oracle(a):
    p = _pd(a)
    li = p["lineitem"]
    li = li[li.l_shipdate <= np.datetime64("1998-06-02")].copy()
    li["price"] = li.l_extendedprice.astype(float)
    li["disc"] = li.l_discount.astype(float)
    li["tax"] = li.l_tax.astype(float)
    li["disc_price"] = li.price * (1.0 - li.disc)
    li["charge"] = li.disc_price * (1.0 + li.tax)
    g = li.groupby(["l_returnflag", "l_linestatus"]).agg(
        sum_qty=("l_quantity", "sum"),
        sum_base_price=("price", "sum"),
        sum_disc_price=("disc_price", "sum"),
        sum_charge=("charge", "sum"),
        avg_qty=("l_quantity", "mean"),
        avg_price=("price", "mean"),
        avg_disc=("disc", "mean"),
        count_order=("price", "size")).reset_index()
    g = g.sort_values(["l_returnflag", "l_linestatus"])
    g["count_order"] = g.count_order.astype("int64")
    return pa.Table.from_pandas(g.reset_index(drop=True),
                                preserve_index=False)


_q("q1", "pricing summary report (8-agg scan)")((_q1_run, _q1_oracle))


# --- q3: shipping-priority revenue ----------------------------------------

def _q3_run(s, t):
    cutoff = int(np.datetime64("1995-03-15").astype("datetime64[D]")
                 .astype(int))
    c = _rd(s, t, "customer").filter(
        col("c_mktsegment") == "BUILDING").select("c_custkey")
    o = _rd(s, t, "orders").select("o_orderkey", "o_custkey",
                                   "o_orderdate", "o_shippriority")
    o = o.filter(col("o_orderdate") < lit(cutoff, DataType.DATE32))
    li = _rd(s, t, "lineitem").select(
        "l_orderkey", "l_extendedprice", "l_discount", "l_shipdate")
    li = li.filter(col("l_shipdate") > lit(cutoff, DataType.DATE32))
    j = _join(o, c, "o_custkey", "c_custkey")
    j = j.join(_rename(li, l_orderkey="o_orderkey"), on="o_orderkey",
               how="inner")
    rev = (col("l_extendedprice").cast(DataType.FLOAT64)
           * (lit(1.0) - col("l_discount").cast(DataType.FLOAT64)))
    g = (j.with_column("rev", rev)
         .group_by("o_orderkey", "o_orderdate", "o_shippriority")
         .agg(F.sum(col("rev")).alias("revenue")))
    return (g.sort(col("revenue").desc(), col("o_orderdate").asc(),
                   col("o_orderkey").asc())
            .limit(10).collect())


def _q3_oracle(a):
    p = _pd(a)
    cutoff = np.datetime64("1995-03-15")
    c = p["customer"]
    c = c[c.c_mktsegment == "BUILDING"][["c_custkey"]]
    o = p["orders"]
    o = o[o.o_orderdate < cutoff]
    li = p["lineitem"]
    li = li[li.l_shipdate > cutoff]
    j = o.merge(c, left_on="o_custkey", right_on="c_custkey")
    j = j.merge(li, left_on="o_orderkey", right_on="l_orderkey")
    j["rev"] = j.l_extendedprice.astype(float) \
        * (1.0 - j.l_discount.astype(float))
    g = j.groupby(["o_orderkey", "o_orderdate", "o_shippriority"])[
        "rev"].sum().reset_index(name="revenue")
    g = g.sort_values(["revenue", "o_orderdate", "o_orderkey"],
                      ascending=[False, True, True]).head(10)
    return pa.Table.from_pandas(g.reset_index(drop=True),
                                preserve_index=False)


_q("q3", "shipping-priority revenue (BUILDING segment top 10)")(
    (_q3_run, _q3_oracle))


# --- q6: forecast revenue change ------------------------------------------

def _q6_run(s, t):
    li = _rd(s, t, "lineitem").select(
        "l_shipdate", "l_quantity", "l_extendedprice", "l_discount")
    lo, hi = int(_D1994), int(_D1995)
    disc = col("l_discount").cast(DataType.FLOAT64)
    j = li.filter((col("l_shipdate") >= lit(lo, DataType.DATE32))
                  & (col("l_shipdate") < lit(hi, DataType.DATE32))
                  & (disc >= lit(0.03)) & (disc <= lit(0.07))
                  & (col("l_quantity") < 24))
    rev = col("l_extendedprice").cast(DataType.FLOAT64) * disc
    return (j.with_column("rev", rev).group_by()
            .agg(F.sum(col("rev")).alias("revenue")).collect())


def _q6_oracle(a):
    p = _pd(a)
    li = p["lineitem"]
    d = li.l_discount.astype(float)
    sel = li[(li.l_shipdate >= np.datetime64("1994-01-01"))
             & (li.l_shipdate < np.datetime64("1995-01-01"))
             & (d >= 0.03) & (d <= 0.07) & (li.l_quantity < 24)]
    rev = (sel.l_extendedprice.astype(float)
           * sel.l_discount.astype(float)).sum()
    return pa.Table.from_pydict({"revenue": [float(rev)]})


_q("q6", "forecast revenue change (selective filter-agg)")(
    (_q6_run, _q6_oracle))
