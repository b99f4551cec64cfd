"""The join queries of ``auron_tpu_torch.it.queries`` and their
counterparts in the JAX package's DSL, for the ``test_torch_*`` files
that hold the port's front end against the reference's.

``reference_dataframes`` builds each query with ``auron_tpu``'s
DataFrame DSL (q05 through the reference's own query function);
``port_dataframes`` calls the port's query functions. The two must give
identical task bytes, plan trees and rows.

- ``q05``, ``q05_broadcast``: q05, and q05 without its repartitions
  (a broadcast date_dim side);
- ``filtered_probe``: the broadcast form with a filter on the probe
  side, which the fusion pass wraps in a stage of its own;
- ``q09_semi``, ``q09_anti``: q09's join against sub-$1 sales, counted;
- ``inner`` … ``existence``: the co-partitioned join of every type
  (``outer_join_dataframe``);
- ``broadcast_right``, ``broadcast_full``: the right and full joins over
  a broadcast build side (ROADMAP Queue 3 item 8).
"""

from unittest import mock

import pyarrow as pa

from auron_tpu.frontend import dataframe as rdf
from auron_tpu.it import queries as rqueries
from auron_tpu_torch.frontend import dataframe as tdf
from auron_tpu_torch.it import queries as tqueries

JOIN_TYPES = ("inner", "left", "right", "full", "semi", "anti",
              "existence")
NAMES = ("q05", "q05_broadcast", "filtered_probe", "q09_semi",
         "q09_anti") + JOIN_TYPES + ("broadcast_right", "broadcast_full")


def _ref_q05_broadcast(s, t):
    col, F = rdf.col, rdf.functions
    dd = (s.read_parquet(t["date_dim"])
          .filter(col("d_year") == 2000)
          .select(col("d_date_sk").alias("ss_sold_date_sk"), col("d_moy")))
    return (s.read_parquet(t["store_sales"], partitions=4)
            .join(dd, on="ss_sold_date_sk")
            .group_by("d_moy")
            .agg(F.sum(col("ss_sales_price")).alias("total")))


def filtered_probe(s, t, dsl):
    """q05's broadcast form over the sales of more than 10 units, in
    either package's DSL."""
    col, F = dsl.col, dsl.functions
    dd = (s.read_parquet(t["date_dim"])
          .filter(col("d_year") == 2000)
          .select(col("d_date_sk").alias("ss_sold_date_sk"), col("d_moy")))
    return (s.read_parquet(t["store_sales"], partitions=4)
            .filter(col("ss_quantity") > 10)
            .join(dd, on="ss_sold_date_sk")
            .group_by("d_moy")
            .agg(F.sum(col("ss_sales_price")).alias("total")))


def _ref_cheap_sales_items(s, t, how):
    col, F = rdf.col, rdf.functions
    sold = (s.read_parquet(t["store_sales"], partitions=4)
            .filter(col("ss_sales_price") < 1.0)
            .select(col("ss_item_sk").alias("i_item_sk")))
    return (s.read_parquet(t["item"], columns=["i_item_sk"])
            .join(sold, on="i_item_sk", how=how)
            .group_by()
            .agg(F.count_star().alias("n")))


def _ref_outer_join(s, t, how):
    col = rdf.col
    sales = (s.read_parquet(t["store_sales"], partitions=4)
             .filter((col("ss_quantity") == 1)
                     & (col("ss_sales_price") < 10.0))
             .select(col("ss_item_sk"), col("ss_customer_sk"),
                     col("ss_net_paid"))
             .repartition(4, "ss_item_sk"))
    items = (s.read_parquet(t["item"],
                            columns=["i_item_sk", "i_current_price"])
             .filter(col("i_current_price") < 150.0)
             .select(col("i_item_sk").alias("ss_item_sk"),
                     col("i_current_price"))
             .repartition(4, "ss_item_sk"))
    return sales.join(items, on="ss_item_sk", how=how)


def _ref_broadcast_outer(s, how):
    probe = s.from_arrow(pa.table({"k": [1, 2, 3, 4],
                                   "x": [10, 20, 30, 40]})).repartition(2)
    build = s.from_arrow(pa.table({"k": [2, 5], "y": [7, 8]}))
    return probe.join(build, on="k", how=how)


def reference_dataframes(s, t) -> dict:
    """{name: reference DataFrame} over the tables ``t`` ({name: files};
    store_sales, date_dim and item)."""
    with mock.patch.object(rdf.DataFrame, "collect",
                           lambda self, *a, **k: self):
        out = {"q05": rqueries._q05_run(s, t)}
    out["q05_broadcast"] = _ref_q05_broadcast(s, t)
    out["filtered_probe"] = filtered_probe(s, t, rdf)
    for how in ("semi", "anti"):
        out[f"q09_{how}"] = _ref_cheap_sales_items(s, t, how)
    for how in JOIN_TYPES:
        out[how] = _ref_outer_join(s, t, how)
    for how in ("right", "full"):
        out[f"broadcast_{how}"] = _ref_broadcast_outer(s, how)
    return out


def port_dataframes(s, t) -> dict:
    """The same queries through ``auron_tpu_torch.it.queries``."""
    out = {"q05": tqueries.q05_dataframe(s, t),
           "q05_broadcast": tqueries.q05_dataframe(s, t,
                                                   co_partitioned=False),
           "filtered_probe": filtered_probe(s, t, tdf)}
    for how in ("semi", "anti"):
        out[f"q09_{how}"] = tqueries.cheap_sales_items_dataframe(s, t, how)
    for how in JOIN_TYPES:
        out[how] = tqueries.outer_join_dataframe(s, t, how)
    for how in ("right", "full"):
        out[f"broadcast_{how}"] = tqueries.broadcast_outer_dataframe(s, how)
    return out
