"""TPC-H dataset generator (SF-scaled, coherent star/snowflake FKs).

BASELINE.md lists TPC-H q5/q9/q18 as join-heavy measurement targets;
this generator produces the eight TPC-H tables with the columns those
queries touch, with dbgen-like value domains (25 nations over 5 regions,
part names carrying color words, decimal(12,2) money, order dates over
1992-1998) at ``scale`` × 60k lineitems. Same design rules as the
TPC-DS generator (it/tpcds.py): numpy-vectorized, parquet on disk,
deterministic seed.

The port's copy of ``auron_tpu.it.tpch``: it writes the same tables for
the same ``(seed, scale)``, with the money columns built from their
unscaled cents instead of row by row. ``scale=100`` is TPC-H SF1
(6,000,000 lineitems)."""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

REGIONS = ["AFRICA", "AMERICA", "ASIA", "EUROPE", "MIDDLE EAST"]
NATIONS = [
    ("ALGERIA", 0), ("ARGENTINA", 1), ("BRAZIL", 1), ("CANADA", 1),
    ("EGYPT", 4), ("ETHIOPIA", 0), ("FRANCE", 3), ("GERMANY", 3),
    ("INDIA", 2), ("INDONESIA", 2), ("IRAN", 4), ("IRAQ", 4),
    ("JAPAN", 2), ("JORDAN", 4), ("KENYA", 0), ("MOROCCO", 0),
    ("MOZAMBIQUE", 0), ("PERU", 1), ("CHINA", 2), ("ROMANIA", 3),
    ("SAUDI ARABIA", 4), ("VIETNAM", 2), ("RUSSIA", 3),
    ("UNITED KINGDOM", 3), ("UNITED STATES", 1),
]
COLORS = ["green", "blue", "red", "ivory", "navy", "plum", "khaki",
          "puff", "snow", "rose"]
#: epoch days of 1992-01-01 and exclusive end 1998-08-03
DATE_LO = (np.datetime64("1992-01-01") - np.datetime64("1970-01-01")) \
    .astype(int)
DATE_HI = (np.datetime64("1998-08-03") - np.datetime64("1970-01-01")) \
    .astype(int)


def _cents(cents):
    """decimal(12,2) array straight from unscaled int64 cents: Arrow's
    decimal128 buffer holds two little-endian int64 limbs per value, the
    high one the sign extension."""
    cents = np.asarray(cents, np.int64)
    limbs = np.stack([cents, cents >> 63], axis=1)
    return pa.Array.from_buffers(
        pa.decimal128(12, 2), len(cents),
        [None, pa.py_buffer(np.ascontiguousarray(limbs).tobytes())])


def _money(rng, n, lo_c=100, hi_c=10_000_000):
    return _cents(rng.integers(lo_c, hi_c, n))


def _write(root, name, table, n_files=1):
    files = []
    rows = table.num_rows
    per = max(1, (rows + n_files - 1) // n_files)
    for i in range(n_files):
        part = table.slice(i * per, per)
        if part.num_rows == 0 and i > 0:
            break
        path = os.path.join(root, f"{name}_{i}.parquet")
        pq.write_table(part, path)
        files.append(path)
    return files


def generate(root: str, scale: float = 1.0, seed: int = 11) -> dict:
    """Write the eight TPC-H tables at ``scale`` (1.0 = 60k lineitems);
    returns {table: [files]}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    out = {}

    n_nation = len(NATIONS)
    nation = pa.table({
        "n_nationkey": pa.array(np.arange(n_nation, dtype=np.int64)),
        "n_name": pa.array([n for n, _ in NATIONS]),
        "n_regionkey": pa.array(
            np.asarray([r for _, r in NATIONS], np.int64)),
    })
    out["nation"] = _write(root, "nation", nation)

    region = pa.table({
        "r_regionkey": pa.array(np.arange(5, dtype=np.int64)),
        "r_name": pa.array(REGIONS),
    })
    out["region"] = _write(root, "region", region)

    n_supp = max(int(100 * scale), 20)
    supplier = pa.table({
        "s_suppkey": pa.array(np.arange(1, n_supp + 1, dtype=np.int64)),
        "s_name": pa.array([f"Supplier#{i:09d}"
                            for i in range(1, n_supp + 1)]),
        "s_nationkey": pa.array(
            rng.integers(0, n_nation, n_supp).astype(np.int64)),
    })
    out["supplier"] = _write(root, "supplier", supplier)

    n_part = max(int(2000 * scale), 200)
    pcolor = rng.integers(0, len(COLORS), n_part)
    part = pa.table({
        "p_partkey": pa.array(np.arange(1, n_part + 1, dtype=np.int64)),
        "p_name": pa.array([
            f"{COLORS[pcolor[i]]} polished {COLORS[(pcolor[i]+3) % len(COLORS)]} item {i+1}"
            for i in range(n_part)]),
        "p_retailprice": _money(rng, n_part, 90_000, 200_000),
    })
    out["part"] = _write(root, "part", part)

    # partsupp: 2 suppliers per part
    ps_part = np.repeat(np.arange(1, n_part + 1, dtype=np.int64), 2)
    ps_supp = rng.integers(1, n_supp + 1, 2 * n_part).astype(np.int64)
    partsupp = pa.table({
        "ps_partkey": pa.array(ps_part),
        "ps_suppkey": pa.array(ps_supp),
        "ps_supplycost": _money(rng, 2 * n_part, 100, 100_000),
    })
    out["partsupp"] = _write(root, "partsupp", partsupp)

    n_cust = max(int(1500 * scale), 150)
    segments = np.array(["AUTOMOBILE", "BUILDING", "FURNITURE",
                         "HOUSEHOLD", "MACHINERY"])
    customer = pa.table({
        "c_custkey": pa.array(np.arange(1, n_cust + 1, dtype=np.int64)),
        "c_mktsegment": pa.array(
            segments[rng.integers(0, 5, n_cust)]),
        "c_name": pa.array([f"Customer#{i:09d}"
                            for i in range(1, n_cust + 1)]),
        "c_nationkey": pa.array(
            rng.integers(0, n_nation, n_cust).astype(np.int64)),
    })
    out["customer"] = _write(root, "customer", customer)

    n_ord = max(int(15_000 * scale), 1500)
    o_date = rng.integers(DATE_LO, DATE_HI, n_ord)
    orders = pa.table({
        "o_orderkey": pa.array(np.arange(1, n_ord + 1, dtype=np.int64)),
        "o_custkey": pa.array(
            rng.integers(1, n_cust + 1, n_ord).astype(np.int64)),
        "o_orderdate": pa.array(o_date.astype("datetime64[D]")),
        "o_shippriority": pa.array(np.zeros(n_ord, np.int64)),
        "o_totalprice": _money(rng, n_ord, 100_000, 40_000_000),
    })
    out["orders"] = _write(root, "orders", orders, 2)

    n_li = max(int(60_000 * scale), 6000)
    l_ord = rng.integers(1, n_ord + 1, n_li).astype(np.int64)
    # supplier must exist in partsupp for the part for q9 realism: pick a
    # random partsupp row per lineitem
    ps_row = rng.integers(0, 2 * n_part, n_li)
    qty = rng.integers(1, 51, n_li)
    price_c = rng.integers(90_000, 200_000, n_li)
    disc_c = rng.integers(0, 11, n_li)            # 0.00..0.10
    lineitem = pa.table({
        "l_orderkey": pa.array(l_ord),
        "l_partkey": pa.array(ps_part[ps_row]),
        "l_suppkey": pa.array(ps_supp[ps_row]),
        "l_quantity": pa.array(qty.astype(np.int64)),
        "l_extendedprice": _cents(price_c * qty),
        "l_discount": _cents(disc_c),
        "l_shipdate": pa.array(
            (o_date[l_ord - 1]
             + rng.integers(1, 122, n_li)).astype("datetime64[D]")),
        "l_tax": _cents(rng.integers(0, 9, n_li)),
        "l_returnflag": pa.array(
            np.array(["A", "N", "R"])[rng.integers(0, 3, n_li)]),
        "l_linestatus": pa.array(
            np.array(["F", "O"])[rng.integers(0, 2, n_li)]),
    })
    out["lineitem"] = _write(root, "lineitem", lineitem, 4)
    return out


def load_arrow(tables: dict) -> dict:
    return {name: pa.concat_tables([pq.read_table(f) for f in files])
            for name, files in tables.items()}
