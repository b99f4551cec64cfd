"""Synthetic TPC-DS-class dataset, a copy of ``auron_tpu.it.tpcds_data``.

The same draws in the same order from the same seed, so a scale and a
seed give the reference's tables. Split in two:

- ``draw_tables(scale, seed)``: every table's columns, numpy only (the
  dimensions' strings as numpy or python strings), and
  ``store_sales_columns(scale, seed)``: the fact table as numpy
  ``(values, validity)`` pairs, so the card can make the data without
  pyarrow;
- ``generate(root, scale, seed)``: writes the reference's five tables
  as parquet (4 fact files, split at ``fact_file_bounds``), and
  ``write_store_sales`` / ``write_dimensions`` write the tables of one
  draw, importing pyarrow inside.

``q01_oracle`` is the q01 query in numpy: per ``ss_store_sk`` over rows
with ``ss_quantity > 5``, the float64 sum of ``ss_sales_price``, the
count of non-null ``ss_net_paid`` and the mean of ``ss_net_profit``.

scale 1.0 is 120,000 fact rows; scale 240 is 28,800,000, TPC-DS SF10's
store_sales (28,800,991 rows).
"""

from __future__ import annotations

import os

import numpy as np

FACT_FILES = 4

#: store_sales column order of the reference's parquet files
STORE_SALES = ("ss_sold_date_sk", "ss_customer_sk", "ss_item_sk",
               "ss_store_sk", "ss_quantity", "ss_sales_price",
               "ss_net_profit", "ss_net_paid")

_STATES = np.array(["CA", "TX", "NY", "WA", "GA", "OH", "IL", "MI"])
_CATS = np.array(["Books", "Music", "Shoes", "Home", "Sports",
                  "Electronics", "Jewelry"])


def sizes(scale: float) -> dict:
    return {"sales": int(120_000 * scale),
            "customers": int(4_000 * scale) or 1,
            "items": int(1_000 * scale) or 1,
            "stores": max(int(12 * scale), 2),
            "dates": 730}


def draw_tables(scale: float, seed: int) -> dict:
    """Every table's columns, drawn in the reference's order: customer,
    item, store, then the fact table. Dimension strings are built as the
    reference builds them."""
    rng = np.random.default_rng(seed)
    n = sizes(scale)
    nc, ni, ns, nd = n["customers"], n["items"], n["stores"], n["dates"]
    customer = {
        "c_customer_sk": np.arange(nc, dtype=np.int64),
        "c_birth_year": rng.integers(1930, 2005, nc).astype(np.int64),
        "c_state": _STATES[rng.integers(0, len(_STATES), nc)],
        # ~2% null emails; one uniform draw per customer, as the
        # reference's per-row rng.random() calls make them
        "c_email": [None if u < 0.02 else f"c{i}@example.com"
                    for i, u in enumerate(rng.random(nc))],
    }
    item = {
        "i_item_sk": np.arange(ni, dtype=np.int64),
        "i_category": _CATS[rng.integers(0, len(_CATS), ni)],
        "i_brand": [f"brand#{b:03d}" for b in rng.integers(0, 50, ni)],
        "i_current_price": np.round(rng.uniform(0.5, 300.0, ni), 2),
    }
    store = {
        "s_store_sk": np.arange(ns, dtype=np.int64),
        "s_state": _STATES[rng.integers(0, len(_STATES), ns)],
        "s_number_employees": rng.integers(50, 300, ns).astype(np.int64),
    }
    days = np.arange(nd, dtype=np.int64)
    date_dim = {"d_date_sk": days, "d_year": 2000 + days // 365,
                "d_moy": 1 + (days % 365) // 31}

    m = n["sales"]
    qty = rng.integers(1, 20, m)
    price = np.round(rng.uniform(0.5, 300.0, m), 2)
    profit = np.round(rng.normal(5.0, 40.0, m), 2)
    # ~1.5% of net_paid is NULL (returns in flight)
    paid_null = rng.random(m) < 0.015
    ones = np.ones(m, np.bool_)
    fact = {
        "ss_sold_date_sk": (rng.integers(0, nd, m).astype(np.int64), ones),
        "ss_customer_sk": (rng.integers(0, nc, m).astype(np.int64), ones),
        "ss_item_sk": (rng.integers(0, ni, m).astype(np.int64), ones),
        "ss_store_sk": (rng.integers(0, ns, m).astype(np.int64), ones),
        "ss_quantity": (qty.astype(np.int64), ones),
        "ss_sales_price": (price, ones),
        "ss_net_profit": (profit, ones),
        # a null row holds 0.0, as a scan of the reference's file does
        "ss_net_paid": (np.where(paid_null, 0.0, price * qty), ~paid_null),
    }
    return {"store_sales": fact, "customer": customer, "item": item,
            "store": store, "date_dim": date_dim}


def store_sales_columns(scale: float = 1.0, seed: int = 42
                        ) -> dict[str, tuple[np.ndarray, np.ndarray]]:
    """The fact table: {column: (values, validity)} in file order."""
    return draw_tables(scale, seed)["store_sales"]


def fact_file_bounds(rows: int, n_files: int = FACT_FILES
                     ) -> list[tuple[int, int]]:
    """[start, stop) row range of each fact file: the reference writes
    ``ceil(rows / n_files)`` rows per file."""
    per = (rows + n_files - 1) // n_files
    return [(min(i * per, rows), min((i + 1) * per, rows))
            for i in range(n_files)]


def write_store_sales(root: str, fact: dict) -> list[str]:
    """The fact columns as the reference's 4 parquet files under
    ``root``; returns their paths."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(root, exist_ok=True)
    rows = fact["ss_store_sk"][0].shape[0]
    files = []
    for i, (lo, hi) in enumerate(fact_file_bounds(rows)):
        tbl = pa.table({
            name: pa.array(v[lo:hi], mask=None if valid.all()
                           else ~valid[lo:hi])
            for name, (v, valid) in fact.items()})
        path = os.path.join(root, f"store_sales_{i}.parquet")
        pq.write_table(tbl, path)
        files.append(path)
    return files


DIMENSIONS = ("customer", "item", "store", "date_dim")

_STRING_COLUMNS = frozenset({"c_email", "c_state", "i_category", "i_brand",
                             "s_state"})


def write_dimensions(root: str, tables: dict,
                     names=DIMENSIONS) -> dict[str, list[str]]:
    """The dimension tables ``names`` of one ``draw_tables`` as the
    reference's parquet files (one per table) under ``root``; returns
    {table: [file]}."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    os.makedirs(root, exist_ok=True)
    out = {}
    for name in names:
        tbl = pa.table({c: pa.array(list(v) if c in _STRING_COLUMNS else v,
                                    pa.string() if c in _STRING_COLUMNS
                                    else None)
                        for c, v in tables[name].items()})
        path = os.path.join(root, f"{name}_0.parquet")
        pq.write_table(tbl, path)
        out[name] = [path]
    return out


def generate(root: str, scale: float = 1.0, seed: int = 42) -> dict:
    """Write the dataset under ``root`` as the reference does; returns
    {table: [files]}."""
    tables = draw_tables(scale, seed)
    out = {"store_sales": write_store_sales(root, tables["store_sales"])}
    out.update(write_dimensions(root, tables))
    return out


def q01_oracle(cols: dict) -> dict[str, np.ndarray]:
    """q01 in numpy over ``store_sales_columns``: per store with
    ``ss_quantity > 5`` rows, sorted by store, the keys, the float64 sum
    of ss_sales_price, the count of non-null ss_net_paid, the mean of
    ss_net_profit, the rows per store, and the per-store sums of |price|
    and |profit| (the scales of the float tolerances)."""
    keep = cols["ss_quantity"][0] > 5
    k = cols["ss_store_sk"][0][keep]
    price = cols["ss_sales_price"][0][keep]
    profit = cols["ss_net_profit"][0][keep]
    paid_ok = cols["ss_net_paid"][1][keep]
    size = int(k.max()) + 1 if k.size else 0
    rows = np.bincount(k, minlength=size)
    present = np.flatnonzero(rows)
    n = rows[present]

    def per_store(w):
        return np.bincount(k, weights=w, minlength=size)[present]

    return {"ss_store_sk": present.astype(np.int64),
            "total": per_store(price),
            "paid_cnt": np.bincount(k, weights=paid_ok.astype(np.float64),
                                    minlength=size)[present].astype(np.int64),
            "avg_profit": per_store(profit) / n,
            "rows": n,
            "total_abs": per_store(np.abs(price)),
            "profit_abs": per_store(np.abs(profit))}
