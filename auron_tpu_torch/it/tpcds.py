"""Real-schema TPC-DS dataset generator.

Emits the TPC-DS star schema (fact + dimension tables with the spec's
table/column names and types — money as decimal(7,2), surrogate-key
joins, nullable foreign keys) at a row scale where ``scale=1.0`` is a
1M-row store_sales fact table. Deterministic per (seed, scale); written
as multi-file parquet so scans have real input splits.

This backs the ``tpcds`` integration suite (tpcds_queries.py): the same
query shapes the reference gates on with its 1 GB TPC-DS checkout
(reference: .github/workflows/tpcds-reusable.yml:70-83,
dev/auron-it/.../QueryResultComparator.scala:21-100). dsdgen itself is
not in this image, so the generator reproduces the *schema and
distribution shape* (skewed FKs, null FK fractions, seasonal dates,
price/cost relationships), not dsdgen's exact rows.

The port's copy of ``auron_tpu.it.tpcds``: it writes the same tables for
the same ``(seed, scale)``, with the nullable foreign keys built as
masked arrays instead of row by row. ``scale=2.88`` gives TPC-DS SF1's
fact row counts (store_sales 2,880,000).
"""

from __future__ import annotations

import os

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq

FACT_FILES = 8

#: TPC-DS Julian-ish date surrogate keys: d_date_sk for 1998-01-01
DATE_SK0 = 2450815
N_DATES = 365 * 5 + 2          # 1998-01-01 .. 2002-12-31


def _money_from_cents(cents, precision=7, scale=2):
    """decimal128(p, s) array straight from unscaled int64 cents — the
    arrow buffer layout is 128-bit little-endian unscaled ints, so two
    int64 limbs per value (high limb = sign extension)."""
    cents = np.asarray(cents, np.int64)
    limbs = np.zeros((len(cents), 2), np.int64)
    limbs[:, 0] = cents
    limbs[:, 1] = cents >> 63          # arithmetic: 0 or -1
    return pa.Array.from_buffers(
        pa.decimal128(precision, scale), len(cents),
        [None, pa.py_buffer(np.ascontiguousarray(limbs).tobytes())])


def _money(rng, n, lo=0.5, hi=300.0):
    return _money_from_cents(rng.integers(int(lo * 100), int(hi * 100), n))


def _fk_array(rng, n, n_dim, null_frac=0.0, skew=False):
    """Surrogate-key FK column 1..n_dim, optionally zipf-skewed, with a
    null fraction (TPC-DS fact FKs are nullable)."""
    if skew:
        ranks = rng.zipf(1.3, n).astype(np.int64)
        fk = (ranks - 1) % n_dim + 1
    else:
        fk = rng.integers(1, n_dim + 1, n).astype(np.int64)
    if null_frac:
        return pa.array(fk, pa.int64(), mask=rng.random(n) < null_frac)
    return pa.array(fk, pa.int64())


def _write(root, name, table, n_files=1):
    paths = []
    n = table.num_rows
    per = max(1, (n + n_files - 1) // n_files)
    for i in range(0, max(n_files, 1)):
        lo = i * per
        if lo >= n and i > 0:
            break
        chunk = table.slice(lo, per)
        p = os.path.join(root, f"{name}_{i}.parquet")
        pq.write_table(chunk, p, row_group_size=64 * 1024)
        paths.append(p)
    return paths


def generate(root: str, scale: float = 1.0, seed: int = 7) -> dict:
    """Write the dataset; returns {table: [parquet files]}."""
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    out: dict[str, list[str]] = {}

    n_ss = int(1_000_000 * scale)
    n_sr = n_ss // 10
    n_cs = n_ss // 2
    n_ws = n_ss // 4
    n_inv = n_ss // 2
    n_item = max(int(18_000 * min(scale, 1.0)), 200)
    n_cust = max(int(100_000 * min(scale, 1.0)), 500)
    n_addr = max(n_cust // 2, 250)
    n_store = max(int(12 * max(scale, 0.5)), 6)
    n_wh = 5
    n_web = 6
    n_cc = 4
    n_cd = 1920     # TPC-DS customer_demographics cross product size class
    n_hd = 7200

    # -- date_dim -----------------------------------------------------------
    doff = np.arange(N_DATES)
    base = np.datetime64("1998-01-01")
    dates = base + doff
    dow = ((doff + 3) % 7)           # 1998-01-01 was a Thursday
    day_names = np.array(["Monday", "Tuesday", "Wednesday", "Thursday",
                          "Friday", "Saturday", "Sunday"])
    years = dates.astype("datetime64[Y]").astype(int) + 1970
    months = dates.astype("datetime64[M]").astype(int) % 12 + 1
    dom = (dates - dates.astype("datetime64[M]")).astype(int) + 1
    date_dim = pa.table({
        "d_date_sk": pa.array(DATE_SK0 + doff, pa.int64()),
        "d_date": pa.array(dates.astype("datetime64[D]"), pa.date32()),
        "d_year": pa.array(years.astype(np.int64)),
        "d_moy": pa.array(months.astype(np.int64)),
        "d_dom": pa.array(dom.astype(np.int64)),
        "d_qoy": pa.array(((months - 1) // 3 + 1).astype(np.int64)),
        "d_day_name": pa.array(day_names[dow]),
        "d_month_seq": pa.array(((years - 1998) * 12 + months - 1)
                                .astype(np.int64)),
        # week boundary on Monday; base offset keeps values dsdgen-like
        "d_week_seq": pa.array(((doff + 3) // 7 + 5270).astype(np.int64)),
    })
    out["date_dim"] = _write(root, "date_dim", date_dim)

    # -- time_dim -----------------------------------------------------------
    tsk = np.arange(86400 // 60)     # one row per minute
    time_dim = pa.table({
        "t_time_sk": pa.array(tsk, pa.int64()),
        "t_hour": pa.array(tsk // 60, pa.int64()),
        "t_minute": pa.array(tsk % 60, pa.int64()),
    })
    out["time_dim"] = _write(root, "time_dim", time_dim)

    # -- item ---------------------------------------------------------------
    cats = np.array(["Books", "Electronics", "Home", "Jewelry", "Men",
                     "Music", "Shoes", "Sports", "Women", "Children"])
    isk = np.arange(1, n_item + 1)
    cat_idx = rng.integers(0, len(cats), n_item)
    class_id = rng.integers(1, 17, n_item)
    brand_id = rng.integers(1, 1000, n_item)
    item = pa.table({
        "i_item_sk": pa.array(isk, pa.int64()),
        "i_item_id": pa.array([f"AAAAAAAA{k:08d}" for k in isk]),
        "i_item_desc": pa.array([f"item desc {k % 977}" for k in isk]),
        "i_brand_id": pa.array(brand_id, pa.int64()),
        "i_brand": pa.array([f"brand#{b}" for b in brand_id]),
        "i_class_id": pa.array(class_id, pa.int64()),
        "i_class": pa.array([f"class{c:02d}" for c in class_id]),
        "i_category_id": pa.array(cat_idx.astype(np.int64) + 1),
        "i_category": pa.array(cats[cat_idx]),
        "i_manufact_id": pa.array(rng.integers(1, 1000, n_item), pa.int64()),
        "i_manufact": pa.array([f"manufact#{m}" for m in
                                rng.integers(1, 100, n_item)]),
        "i_manager_id": pa.array(rng.integers(1, 100, n_item), pa.int64()),
        "i_current_price": _money(rng, n_item, 0.09, 99.0),
        "i_color": pa.array(np.array(
            ["red", "blue", "green", "black", "white", "plum",
             "orchid", "slate"])[rng.integers(0, 8, n_item)]),
        "i_size": pa.array(np.array(
            ["small", "medium", "large", "extra large",
             "economy"])[rng.integers(0, 5, n_item)]),
        "i_units": pa.array(np.array(
            ["Each", "Dozen", "Case", "Pound"])[rng.integers(
                0, 4, n_item)]),
    })
    out["item"] = _write(root, "item", item)

    # -- customer & co ------------------------------------------------------
    csk = np.arange(1, n_cust + 1)
    firsts = np.array(["James", "Mary", "John", "Ana", "Wei", "Omar",
                       "Kai", "Zoe", "Ivan", "Lena"])
    lasts = np.array(["Smith", "Lee", "Garcia", "Khan", "Chen", "Olsen",
                      "Patel", "Okafor", "Ross", "Kim"])
    customer = pa.table({
        "c_customer_sk": pa.array(csk, pa.int64()),
        "c_customer_id": pa.array([f"AAAAAAAA{k:08d}" for k in csk]),
        "c_current_cdemo_sk": _fk_array(rng, n_cust, n_cd, 0.02),
        "c_current_hdemo_sk": _fk_array(rng, n_cust, n_hd, 0.02),
        "c_current_addr_sk": _fk_array(rng, n_cust, n_addr),
        "c_first_name": pa.array(firsts[rng.integers(0, 10, n_cust)]),
        "c_last_name": pa.array(lasts[rng.integers(0, 10, n_cust)]),
        "c_birth_month": pa.array(rng.integers(1, 13, n_cust), pa.int64()),
        "c_birth_year": pa.array(rng.integers(1924, 1993, n_cust),
                                 pa.int64()),
        "c_birth_country": pa.array(np.array(
            ["UNITED STATES", "CANADA", "MEXICO", "BRAZIL", "JAPAN",
             "GERMANY"])[rng.integers(0, 6, n_cust)]),
    })
    out["customer"] = _write(root, "customer", customer, 2)

    states = np.array(["CA", "TX", "NY", "WA", "GA", "OH", "IL", "MI",
                       "TN", "SD", "KY", "FL"])
    cities = np.array(["Fairview", "Midway", "Oak Grove", "Five Points",
                       "Centerville", "Liberty", "Georgetown", "Salem",
                       "Riverside", "Greenfield"])
    counties = np.array(["Ziebach County", "Walker County", "Daviess County",
                         "Barrow County", "Fairfield County",
                         "Luce County", "Richland County", "Bronx County"])
    ask = np.arange(1, n_addr + 1)
    customer_address = pa.table({
        "ca_address_sk": pa.array(ask, pa.int64()),
        "ca_city": pa.array(cities[rng.integers(0, len(cities), n_addr)]),
        "ca_county": pa.array(counties[rng.integers(0, len(counties),
                                                    n_addr)]),
        "ca_state": pa.array(states[rng.integers(0, len(states), n_addr)]),
        "ca_zip": pa.array([f"{z:05d}" for z in
                            rng.integers(10000, 99999, n_addr)]),
        "ca_country": pa.array(["United States"] * n_addr),
        "ca_gmt_offset": pa.array(rng.choice([-5.0, -6.0, -7.0, -8.0],
                                             n_addr), pa.float64()),
    })
    out["customer_address"] = _write(root, "customer_address",
                                     customer_address)

    cd_sk = np.arange(1, n_cd + 1)
    genders = np.array(["M", "F"])
    marital = np.array(["M", "S", "D", "W", "U"])
    edu = np.array(["Primary", "Secondary", "College", "2 yr Degree",
                    "4 yr Degree", "Advanced Degree", "Unknown"])
    customer_demographics = pa.table({
        "cd_demo_sk": pa.array(cd_sk, pa.int64()),
        "cd_gender": pa.array(genders[(cd_sk - 1) % 2]),
        "cd_marital_status": pa.array(marital[(cd_sk - 1) // 2 % 5]),
        "cd_education_status": pa.array(edu[(cd_sk - 1) // 10 % 7]),
        "cd_dep_count": pa.array(((cd_sk - 1) // 70 % 7).astype(np.int64)),
    })
    out["customer_demographics"] = _write(root, "customer_demographics",
                                          customer_demographics)

    hd_sk = np.arange(1, n_hd + 1)
    buy_pot = np.array([">10000", "5001-10000", "1001-5000", "501-1000",
                        "0-500", "Unknown"])
    household_demographics = pa.table({
        "hd_demo_sk": pa.array(hd_sk, pa.int64()),
        "hd_income_band_sk": pa.array(((hd_sk - 1) % 20 + 1)
                                      .astype(np.int64)),
        "hd_buy_potential": pa.array(buy_pot[(hd_sk - 1) % 6]),
        "hd_dep_count": pa.array(((hd_sk - 1) // 6 % 10).astype(np.int64)),
        "hd_vehicle_count": pa.array(((hd_sk - 1) // 60 % 5)
                                     .astype(np.int64) - 1),
    })
    out["household_demographics"] = _write(root, "household_demographics",
                                           household_demographics)

    ssk = np.arange(1, n_store + 1)
    store = pa.table({
        "s_store_sk": pa.array(ssk, pa.int64()),
        "s_store_id": pa.array([f"AAAAAAAA{k:08d}" for k in ssk]),
        "s_store_name": pa.array([f"store_{chr(97 + (k - 1) % 26)}"
                                  for k in ssk]),
        "s_number_employees": pa.array(rng.integers(200, 300, n_store),
                                       pa.int64()),
        "s_city": pa.array(cities[rng.integers(0, len(cities), n_store)]),
        "s_county": pa.array(counties[rng.integers(0, len(counties),
                                                   n_store)]),
        "s_state": pa.array(states[rng.integers(0, len(states), n_store)]),
        "s_zip": pa.array([f"{z:05d}" for z in
                           rng.integers(10000, 99999, n_store)]),
        "s_gmt_offset": pa.array(rng.choice([-5.0, -6.0], n_store),
                                 pa.float64()),
        "s_market_id": pa.array(rng.integers(1, 11, n_store), pa.int64()),
    })
    out["store"] = _write(root, "store", store)

    n_promo = 300
    psk = np.arange(1, n_promo + 1)
    yn = np.array(["Y", "N"])
    promotion = pa.table({
        "p_promo_sk": pa.array(psk, pa.int64()),
        "p_promo_id": pa.array([f"AAAAAAAA{k:08d}" for k in psk]),
        "p_channel_dmail": pa.array(yn[rng.integers(0, 2, n_promo)]),
        "p_channel_email": pa.array(yn[rng.integers(0, 2, n_promo)]),
        "p_channel_tv": pa.array(yn[rng.integers(0, 2, n_promo)]),
    })
    out["promotion"] = _write(root, "promotion", promotion)

    wsk = np.arange(1, n_wh + 1)
    warehouse = pa.table({
        "w_warehouse_sk": pa.array(wsk, pa.int64()),
        "w_warehouse_name": pa.array([f"warehouse {k}" for k in wsk]),
        "w_warehouse_sq_ft": pa.array(rng.integers(50_000, 1_000_000, n_wh),
                                      pa.int64()),
    })
    out["warehouse"] = _write(root, "warehouse", warehouse)

    sm_types = np.array(["EXPRESS", "NEXT DAY", "OVERNIGHT", "REGULAR",
                         "TWO DAY", "LIBRARY"])
    smk = np.arange(1, 21)
    ship_mode = pa.table({
        "sm_ship_mode_sk": pa.array(smk, pa.int64()),
        "sm_type": pa.array(sm_types[(smk - 1) % 6]),
        "sm_code": pa.array([f"code{k % 4}" for k in smk]),
    })
    out["ship_mode"] = _write(root, "ship_mode", ship_mode)

    cck = np.arange(1, n_cc + 1)
    call_center = pa.table({
        "cc_call_center_sk": pa.array(cck, pa.int64()),
        "cc_name": pa.array([f"cc_{k}" for k in cck]),
    })
    out["call_center"] = _write(root, "call_center", call_center)

    webk = np.arange(1, n_web + 1)
    web_site = pa.table({
        "web_site_sk": pa.array(webk, pa.int64()),
        "web_name": pa.array([f"site_{k}" for k in webk]),
    })
    out["web_site"] = _write(root, "web_site", web_site)

    # -- store_sales (the 1M-row fact) --------------------------------------
    # seasonal date skew: Nov/Dec holidays sell more (like dsdgen)
    date_w = 1.0 + 0.8 * np.isin(months, (11, 12))
    date_p = date_w / date_w.sum()
    # a TICKET is one basket: every line of a ticket shares customer,
    # store, household, address, date and time (dsdgen's coherence —
    # without it the per-ticket queries q68/q73/q79 group nothing)
    n_tickets = max(n_ss // 6, 2)
    tk_date = rng.choice(N_DATES, n_tickets, p=date_p).astype(np.int64)
    tk_time = rng.integers(0, 1440, n_tickets)
    tk_cust = rng.integers(1, n_cust + 1, n_tickets)
    tk_cust_null = rng.random(n_tickets) < 0.02
    tk_hd = rng.integers(1, n_hd + 1, n_tickets)
    tk_addr = rng.integers(1, n_addr + 1, n_tickets)
    tk_store = rng.integers(1, n_store + 1, n_tickets)
    tickets = rng.integers(0, n_tickets, n_ss).astype(np.int64)
    sold_date = tk_date[tickets]
    qty = rng.integers(1, 101, n_ss)
    wholesale_c = rng.integers(100, 10_000, n_ss)         # cents
    markup = 1.0 + rng.random(n_ss) * 1.5
    list_c = (wholesale_c * markup).astype(np.int64)
    discount = rng.choice([1.0, 1.0, 1.0, 0.9, 0.8, 0.5], n_ss)
    sales_c = (list_c * discount).astype(np.int64)
    coupon_c = np.where(rng.random(n_ss) < 0.1,
                        (sales_c * 0.2).astype(np.int64), 0)
    ss_cust = pa.array(tk_cust[tickets], pa.int64(),
                       mask=tk_cust_null[tickets])
    store_sales = pa.table({
        "ss_sold_date_sk": pa.array(DATE_SK0 + sold_date, pa.int64()),
        "ss_sold_time_sk": pa.array(tk_time[tickets], pa.int64()),
        "ss_item_sk": _fk_array(rng, n_ss, n_item, skew=True),
        "ss_customer_sk": ss_cust,
        "ss_cdemo_sk": _fk_array(rng, n_ss, n_cd, 0.02),
        "ss_hdemo_sk": pa.array(tk_hd[tickets], pa.int64()),
        "ss_addr_sk": pa.array(tk_addr[tickets], pa.int64()),
        "ss_store_sk": pa.array(tk_store[tickets], pa.int64()),
        "ss_promo_sk": _fk_array(rng, n_ss, n_promo, 0.05),
        "ss_ticket_number": pa.array(tickets + 1, pa.int64()),
        "ss_quantity": pa.array(qty.astype(np.int64)),
        "ss_wholesale_cost": _money_from_cents(wholesale_c),
        "ss_list_price": _money_from_cents(list_c),
        "ss_sales_price": _money_from_cents(sales_c),
        "ss_ext_sales_price": _money_from_cents(sales_c * qty),
        "ss_ext_list_price": _money_from_cents(list_c * qty),
        "ss_ext_wholesale_cost": _money_from_cents(wholesale_c * qty),
        "ss_coupon_amt": _money_from_cents(coupon_c),
        "ss_net_paid": _money_from_cents(sales_c * qty - coupon_c),
        "ss_net_profit": _money_from_cents(
            (sales_c - wholesale_c) * qty - coupon_c),
    })
    out["store_sales"] = _write(root, "store_sales", store_sales, FACT_FILES)

    # -- store_returns ------------------------------------------------------
    # returns reference real sales rows so sr⋈ss joins hit
    ret_idx = rng.choice(n_ss, n_sr, replace=False)
    ret_lag = rng.integers(1, 90, n_sr)
    ret_amt = (sales_c[ret_idx] * rng.integers(1, qty[ret_idx] + 1)
               * rng.choice([1.0, 0.5], n_sr)).astype(np.int64)
    sr_cust = pa.array(ss_cust.to_pylist(), pa.int64()).take(
        pa.array(ret_idx, pa.int64()))
    store_returns = pa.table({
        "sr_returned_date_sk": pa.array(
            np.minimum(DATE_SK0 + sold_date[ret_idx] + ret_lag,
                       DATE_SK0 + N_DATES - 1), pa.int64()),
        "sr_item_sk": store_sales.column("ss_item_sk").take(
            pa.array(ret_idx, pa.int64())),
        "sr_customer_sk": sr_cust,
        "sr_ticket_number": pa.array(tickets[ret_idx] + 1, pa.int64()),
        "sr_store_sk": store_sales.column("ss_store_sk").take(
            pa.array(ret_idx, pa.int64())),
        "sr_return_quantity": pa.array(
            rng.integers(1, 50, n_sr).astype(np.int64)),
        "sr_return_amt": _money_from_cents(ret_amt),
        "sr_fee": _money(rng, n_sr, 0.5, 100.0),
        "sr_net_loss": _money(rng, n_sr, 0.5, 300.0),
    })
    out["store_returns"] = _write(root, "store_returns", store_returns, 2)

    # -- catalog_sales ------------------------------------------------------
    # ORDER coherence (like ss tickets): lines of one order share the
    # customer, addresses, call center and date — q16/q94-class queries
    # group and EXISTS-probe on order_number
    n_orders = max(n_cs // 4, 2)
    ord_date = rng.choice(N_DATES, n_orders, p=date_p).astype(np.int64)
    ord_cust = rng.integers(1, n_cust + 1, n_orders)
    ord_cust_null = rng.random(n_orders) < 0.02
    ord_addr = rng.integers(1, n_addr + 1, n_orders)
    ord_ship_addr = rng.integers(1, n_addr + 1, n_orders)
    ord_cc = rng.integers(1, n_cc + 1, n_orders)
    cs_ord = rng.integers(0, n_orders, n_cs).astype(np.int64)
    cs_date = ord_date[cs_ord]
    cs_qty = rng.integers(1, 101, n_cs)
    cs_whole = rng.integers(100, 10_000, n_cs)
    cs_list = rng.integers(100, 30_000, n_cs)
    cs_sales = (cs_list * rng.choice([1.0, 0.9, 0.7], n_cs)).astype(np.int64)
    cs_coupon = np.where(rng.random(n_cs) < 0.08,
                         (cs_sales * 0.15).astype(np.int64), 0)
    cs_disc = np.maximum(cs_list - cs_sales, 0) * cs_qty
    cs_cust = pa.array(ord_cust[cs_ord], pa.int64(),
                       mask=ord_cust_null[cs_ord])
    catalog_sales = pa.table({
        "cs_sold_date_sk": pa.array(DATE_SK0 + cs_date, pa.int64()),
        "cs_ship_date_sk": pa.array(
            DATE_SK0 + cs_date + rng.integers(1, 150, n_cs), pa.int64()),
        "cs_item_sk": _fk_array(rng, n_cs, n_item, skew=True),
        "cs_bill_customer_sk": cs_cust,
        "cs_bill_cdemo_sk": _fk_array(rng, n_cs, n_cd, 0.02),
        "cs_bill_addr_sk": pa.array(ord_addr[cs_ord], pa.int64()),
        "cs_ship_addr_sk": pa.array(ord_ship_addr[cs_ord], pa.int64()),
        "cs_warehouse_sk": _fk_array(rng, n_cs, n_wh, 0.01),
        "cs_ship_mode_sk": _fk_array(rng, n_cs, 20, 0.01),
        "cs_call_center_sk": pa.array(ord_cc[cs_ord], pa.int64()),
        "cs_promo_sk": _fk_array(rng, n_cs, n_promo, 0.05),
        "cs_order_number": pa.array(cs_ord + 1, pa.int64()),
        "cs_quantity": pa.array(cs_qty.astype(np.int64)),
        "cs_wholesale_cost": _money_from_cents(cs_whole),
        "cs_list_price": _money_from_cents(cs_list),
        "cs_sales_price": _money_from_cents(cs_sales),
        "cs_coupon_amt": _money_from_cents(cs_coupon),
        "cs_ext_discount_amt": _money_from_cents(cs_disc),
        "cs_ext_ship_cost": _money(rng, n_cs, 0.5, 200.0),
        "cs_ext_sales_price": _money_from_cents(cs_sales * cs_qty),
        "cs_net_profit": _money_from_cents(
            (cs_sales - cs_whole) * cs_qty - cs_coupon),
    })
    out["catalog_sales"] = _write(root, "catalog_sales", catalog_sales, 4)

    # -- catalog_returns (reference real cs order lines) --------------------
    n_cr = n_cs // 10
    cr_idx = rng.choice(n_cs, n_cr, replace=False)
    cr_lag = rng.integers(1, 90, n_cr)
    cr_amt = (cs_sales[cr_idx]
              * rng.integers(1, cs_qty[cr_idx] + 1)
              * rng.choice([1.0, 0.5], n_cr)).astype(np.int64)
    catalog_returns = pa.table({
        "cr_returned_date_sk": pa.array(
            np.minimum(DATE_SK0 + cs_date[cr_idx] + cr_lag,
                       DATE_SK0 + N_DATES - 1), pa.int64()),
        "cr_item_sk": catalog_sales.column("cs_item_sk").take(
            pa.array(cr_idx, pa.int64())),
        "cr_order_number": pa.array(cs_ord[cr_idx] + 1, pa.int64()),
        "cr_returning_customer_sk": cs_cust.take(
            pa.array(cr_idx, pa.int64())),
        "cr_returning_addr_sk": pa.array(ord_addr[cs_ord[cr_idx]],
                                         pa.int64()),
        "cr_call_center_sk": pa.array(ord_cc[cs_ord[cr_idx]], pa.int64()),
        "cr_return_quantity": pa.array(
            rng.integers(1, 50, n_cr).astype(np.int64)),
        "cr_return_amount": _money_from_cents(cr_amt),
        "cr_net_loss": _money(rng, n_cr, 0.5, 300.0),
    })
    out["catalog_returns"] = _write(root, "catalog_returns",
                                    catalog_returns, 2)

    # -- web_sales ----------------------------------------------------------
    n_worders = max(n_ws // 3, 2)
    wo_date = rng.choice(N_DATES, n_worders, p=date_p).astype(np.int64)
    wo_time = rng.integers(0, 1440, n_worders)
    wo_cust = rng.integers(1, n_cust + 1, n_worders)
    wo_cust_null = rng.random(n_worders) < 0.02
    wo_addr = rng.integers(1, n_addr + 1, n_worders)
    wo_ship_addr = rng.integers(1, n_addr + 1, n_worders)
    n_wp = 60
    ws_ord = rng.integers(0, n_worders, n_ws).astype(np.int64)
    ws_date = wo_date[ws_ord]
    ws_qty = rng.integers(1, 101, n_ws)
    ws_whole = rng.integers(100, 10_000, n_ws)
    ws_sales = rng.integers(100, 30_000, n_ws)
    ws_cust = pa.array(wo_cust[ws_ord], pa.int64(),
                       mask=wo_cust_null[ws_ord])
    web_sales = pa.table({
        "ws_sold_date_sk": pa.array(DATE_SK0 + ws_date, pa.int64()),
        "ws_sold_time_sk": pa.array(wo_time[ws_ord], pa.int64()),
        "ws_ship_date_sk": pa.array(
            DATE_SK0 + ws_date + rng.integers(1, 150, n_ws), pa.int64()),
        "ws_item_sk": _fk_array(rng, n_ws, n_item, skew=True),
        "ws_bill_customer_sk": ws_cust,
        "ws_bill_addr_sk": pa.array(wo_addr[ws_ord], pa.int64()),
        "ws_ship_addr_sk": pa.array(wo_ship_addr[ws_ord], pa.int64()),
        "ws_web_site_sk": _fk_array(rng, n_ws, n_web, 0.01),
        "ws_web_page_sk": _fk_array(rng, n_ws, n_wp, 0.01),
        "ws_ship_hdemo_sk": _fk_array(rng, n_ws, n_hd, 0.01),
        "ws_warehouse_sk": _fk_array(rng, n_ws, n_wh, 0.01),
        "ws_ship_mode_sk": _fk_array(rng, n_ws, 20, 0.01),
        "ws_order_number": pa.array(ws_ord + 1, pa.int64()),
        "ws_quantity": pa.array(ws_qty.astype(np.int64)),
        "ws_sales_price": _money_from_cents(ws_sales),
        "ws_ext_sales_price": _money_from_cents(ws_sales * ws_qty),
        "ws_ext_discount_amt": _money_from_cents(
            np.maximum((ws_sales * 0.3).astype(np.int64)
                       - rng.integers(0, 5000, n_ws), 0) * ws_qty),
        "ws_ext_ship_cost": _money(rng, n_ws, 0.5, 200.0),
        "ws_net_paid": _money_from_cents(ws_sales * ws_qty),
        "ws_net_profit": _money_from_cents((ws_sales - ws_whole) * ws_qty),
    })
    out["web_sales"] = _write(root, "web_sales", web_sales, 2)

    # -- web_returns (reference real ws order lines) ------------------------
    n_wr = n_ws // 10
    wr_idx = rng.choice(n_ws, n_wr, replace=False)
    wr_lag = rng.integers(1, 90, n_wr)
    wr_amt = (ws_sales[wr_idx] * rng.integers(1, ws_qty[wr_idx] + 1)
              * rng.choice([1.0, 0.5], n_wr)).astype(np.int64)
    web_returns = pa.table({
        "wr_returned_date_sk": pa.array(
            np.minimum(DATE_SK0 + ws_date[wr_idx] + wr_lag,
                       DATE_SK0 + N_DATES - 1), pa.int64()),
        "wr_item_sk": web_sales.column("ws_item_sk").take(
            pa.array(wr_idx, pa.int64())),
        "wr_order_number": pa.array(ws_ord[wr_idx] + 1, pa.int64()),
        "wr_returning_customer_sk": ws_cust.take(
            pa.array(wr_idx, pa.int64())),
        "wr_refunded_cdemo_sk": _fk_array(rng, n_wr, n_cd, 0.02),
        "wr_returning_cdemo_sk": _fk_array(rng, n_wr, n_cd, 0.02),
        "wr_refunded_addr_sk": pa.array(wo_addr[ws_ord[wr_idx]],
                                        pa.int64()),
        "wr_reason_sk": _fk_array(rng, n_wr, 35, 0.01),
        "wr_return_quantity": pa.array(
            rng.integers(1, 50, n_wr).astype(np.int64)),
        "wr_return_amt": _money_from_cents(wr_amt),
        "wr_fee": _money(rng, n_wr, 0.5, 100.0),
        "wr_net_loss": _money(rng, n_wr, 0.5, 300.0),
    })
    out["web_returns"] = _write(root, "web_returns", web_returns, 2)

    # -- small dims: web_page / income_band / reason ------------------------
    wpk = np.arange(1, n_wp + 1)
    web_page = pa.table({
        "wp_web_page_sk": pa.array(wpk, pa.int64()),
        "wp_char_count": pa.array(rng.integers(100, 8_000, n_wp),
                                  pa.int64()),
    })
    out["web_page"] = _write(root, "web_page", web_page)

    ibk = np.arange(1, 21)
    income_band = pa.table({
        "ib_income_band_sk": pa.array(ibk, pa.int64()),
        "ib_lower_bound": pa.array((ibk - 1) * 10_000, pa.int64()),
        "ib_upper_bound": pa.array(ibk * 10_000 - 1, pa.int64()),
    })
    out["income_band"] = _write(root, "income_band", income_band)

    rk = np.arange(1, 36)
    reasons = pa.table({
        "r_reason_sk": pa.array(rk, pa.int64()),
        "r_reason_desc": pa.array([f"reason {k}" for k in rk]),
    })
    out["reason"] = _write(root, "reason", reasons)

    # -- inventory ----------------------------------------------------------
    inventory = pa.table({
        "inv_date_sk": pa.array(
            DATE_SK0 + rng.integers(0, N_DATES, n_inv), pa.int64()),
        "inv_item_sk": _fk_array(rng, n_inv, n_item),
        "inv_warehouse_sk": _fk_array(rng, n_inv, n_wh),
        "inv_quantity_on_hand": pa.array(
            rng.integers(0, 1000, n_inv).astype(np.int64)),
    })
    out["inventory"] = _write(root, "inventory", inventory, 2)

    return out


def load_arrow(tables: dict) -> dict:
    """{name: pyarrow Table} for the oracle side."""
    out = {}
    for name, files in tables.items():
        out[name] = pa.concat_tables([pq.read_table(f) for f in files])
    return out
