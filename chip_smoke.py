#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py [--profile-at-sf10]

Phases p, s, j, t, e, d and w run at TPC-DS SF1 (scale 24 of
``it.tpcds_data``: 2,880,000 store_sales rows), a depth cut that keeps
the script inside its 1200 s beside phase q; the sizes below are
SF10's, ten times SF1's. ``--profile-at-sf10`` runs them at SF10 (scale
240) and profiles each Session query there instead of at SF1: the
launches and busy shares of the timed query, for measurement; the
script then runs past its limit.

Phases, in order; any failure raises and the script exits non-zero:

1. environment: torch, CUDA, nvcc and the card (fails without CUDA);
2. build every CUDA kernel from ``auron_tpu_torch/kernels/csrc``;
3. hold each kernel against its plain PyTorch version on the card: the
   flagship's shapes, Zipf-skewed and sorted keys, a small domain
   through both the shared-memory and the global path, an operand slice
   that is not 16-byte aligned, a 6-row tail and a NaN value; both
   variants of ``grouped_agg._launch`` on each;
4. drive the flagship q01 stage through ``auron_tpu_torch.entry.entry()``
   at 2^20 and 2^22 rows, with every launch counter set to 0 first, and
   check its output against the sort twin and a float64 numpy oracle;
5. time the kernels, their plain versions, one PyTorch library call, the
   stage and its sort twin with CUDA events (5 warm-up runs, median of
   50);
6. profile the kernel and the stage with torch.profiler: device time by
   kernel and the share of the wall time the device was busy;
7. compare kernel variants by device time (torch.profiler, or CUDA
   events where 5 profiler windows in a row record no kernel), in turns
   (a, b, b, a): the redesign against the first design's kernel
   (``pr1``) at both sizes with warm
   and cold L2 (a 64 MB write between launches evicts the operands), on
   a single group, Zipf-skewed and sorted keys; and the shared-memory
   path against the global path over a sweep of key domains.

The general path on the device hash table (``auron_tpu_torch.hashtable``,
PyTorch ops, no hand-written kernel), run after phase 4:

a. the hash twin ``entry._q01_kernel_hash`` at 2^20 and 2^22 rows,
   against the float64 oracle and the dense stage's counts, its claim
   rounds and host syncs per call, and on ``entry()``'s example batch
   against the same call on the CPU (slot order is deterministic);
b. a streaming ``HashAggState`` from 4096 slots over 4 batches of 2^20
   rows with keys uniform over 100,000 values (TPC-DS SF1's
   ``customer`` table, the range of ``ss_customer_sk``): int64 sum,
   count, min, max and first held exactly against numpy, and a float64
   sum that ``auron.hashtable.backend=hash`` forces onto the table; the
   time, capacity and bytes of each batch, growth included;
c. ``DeviceHashTable`` insert and probe over 2^20 keys (10% of the probe
   keys absent) against numpy, and ``build_join_index`` over sorted
   hashes against ``torch.searchsorted``;
d. the hash twin timed in phase 5 beside the dense stage and the sort
   twin, and all three profiled in phase 6: device time by kernel, busy
   share, device launches per call.

The q01 operator pipeline (``auron_tpu_torch.entry.q01_pipeline``:
parquet or device scan → filter → partial AggOp → 4-way hash exchange →
final AggOp → collect), run after phase c:

p. TPC-DS SF10's store_sales, made on the machine by
   ``it.tpcds_data.store_sales_columns(240, --seed)`` (scale 24 at
   SF1): 28,800,000 rows,
   8 int64/float64 columns, 2,880 stores, cut at the reference's 4 file
   ranges into 2^16-row device batches (4 partitions of 110 batches).
   Two plans over ``DeviceBatchScanOp``: (a) the reference planner's,
   on the sort path, and (b) the dense plan with ``key_domain =
   bucket_rows(2880)``, whose partial AggOp launches
   ``cuda_dense_sum_count`` twice per batch. Each is checked against
   the numpy oracle (keys and counts identical; float sums and means
   within 1e-12 (a) or 1e-5 (b) of the store's sum of |v|), for the
   operators' recorded path, and for ``cuda_sum_count.launches`` rising
   by exactly the count the plan implies (0 for (a)); plan (a) on the
   card gives the CPU's key order and counts at scale 1. Then each is
   timed (median of 3 queries after a warm-up), profiled once
   (torch.profiler: busy share, device launches, top items), and its
   host syncs counted (``ops.base.host_readback.syncs``, and PyTorch's
   sync debug mode's warnings). Where pyarrow imports, the 4 files are
   written under the checkout and plan (a) runs through
   ``ParquetScanOp`` too, checked once and not timed: it is phase s's
   q01, which times it; where pyarrow does not import, a line says so.

The front end (``auron_tpu_torch.frontend``: Session → DataFrame →
protobuf TaskDefinition → planner → collect), run after phase p:

s. q01, q10, q11 and q13 of ``it/queries.py`` through
   ``Session(device="cuda").read_parquet(files, partitions=4)`` over
   the 4 store_sales files, each checked against a numpy oracle on the
   generated columns (keys, counts and integer sums identical, float
   sums and means within 1e-12 of the group's sum of |v|); q01 also
   against plan (a) over the same rows, row for row and in order, with
   the same plan above the scan. Then ``store_quantity_dataframe`` over
   ``Session.from_arrow`` of the same table: the planner must derive
   ``key_domain = max(ss_store_sk) + 1`` and the AggOp take the dense
   path. ``cuda_sum_count.launches`` must stay 0 across the phase: the
   planner derives no dense domain for a float sum, as the reference's
   does not. Then a keyless aggregate over the files (sum and count of
   every row: one row, the oracle's), and the sorts: q02 (customers by
   revenue, top 100), q12 (a cast in the projection, a filter, top 20)
   and q02 without its limit (the full sort of 960,000 customers through
   a range exchange into 4 partitions, whose key ranges must be disjoint
   and ascending), each held in order against a numpy oracle: exact keys
   identical, float64 sum keys within 1e-12 of the customer's sum of |v|
   with swaps allowed only between near-ties, and rows that tie on every
   key in either order. Each query but the keyless one is run once
   checked, which is also its warm-up and where its host syncs per
   input batch are counted, then timed by the CUDA-synchronised wall of
   one more run, and profiled once (device activity only) over SF1's
   tables (``sf1_data``: scale 24 of the same generator and seed,
   written once under the same directory; a depth cut that keeps the
   script inside its limit, which ``--profile-at-sf10`` lifts).

Hash joins and the broadcast exchange through the same Session, run
after phase s (phase p also writes the date_dim, item, customer and
store tables of its draw, 730, 240,000, 960,000 and 2,880 rows, beside
its fact files):

j. q05 (``it/queries.q05_dataframe``: date_dim of the year 2000 and
   store_sales, each hash-exchanged on the date, a ``HashJoinOp`` per
   partition, an aggregate by month) and its broadcast form (no
   repartitions: the date_dim side goes through a
   ``BroadcastExchangeOp`` to the 4 store_sales partitions), each
   checked against a numpy oracle (months identical, totals within
   1e-12 of the month's sum of |v|, the join's output rows equal to the
   oracle's joined rows, the hash-run index on every build side); then
   q09's anti and semi joins with a count (``cheap_sales_items_
   dataframe``: the 240,000 items against the sales under $1, broadcast)
   against numpy's counts. Each is timed, profiled at SF1 and its syncs
   counted as in phase s. Then, checked only: every join type over
   co-partitioned sides at SF1 (``outer_join_dataframe``), each row
   multiset held against numpy, and the right and full joins over a
   broadcast build side, held against the reference's rows
   (``it.queries.BROADCAST_OUTER_ROWS``). ``cuda_sum_count.launches``
   stays 0 across the phase.

String columns through the same Session, run after phase j over the
same files (customer's ``c_state`` and ``c_email``, item's
``i_category`` and store's ``s_state`` are strings, of widths 8, 32, 16
and 8):

t. q03 (a co-partitioned join on the item, ``i_category IN (...)``, a
   group by the category), q04 (a join on the store, a group by
   ``s_state``), q06 (a join on the customer, ``min``, ``max`` and
   ``count`` of ``c_email`` per ``c_state``), q07 (two joins, a group by
   ``(i_category, s_state)``, the top 50 by a float sum then both
   strings), q08 (``i_category == 'Electronics'`` over a broadcast item
   side, a semi join of the customers, a group by ``c_state``) and q09
   (an anti join of the items, a group by ``i_category``), each checked
   against a numpy oracle on the generated columns (string keys, counts
   and emails identical; float sums within 1e-12 of the group's sum of
   |v|; q07's rows in order, swaps allowed only between near-ties). Each
   query's time is the CUDA-synchronised wall of its checked run (one
   run), its host syncs per input batch are counted there, and it is
   profiled once at SF1. Every AggOp's path and reason is checked:
   ``sort`` (``float_sum_inexact``; ``acc_kind:smin`` for q06) or
   ``hashtable`` (q08, q09). ``cuda_sum_count.launches`` stays 0.

Scalar expressions and functions through the same Session, run after
phase t over the same customer and item files:

e. q14 (``it/queries.q14_dataframe``: ``initcap``, ``substring_index``
   and ``concat_ws`` over the 240,000 items, a filter, ``count(*)`` and
   ``min`` of a string per title-cased category, a sort) checked against
   a numpy oracle (titles, counts and least paths identical, in order),
   timed by its checked run, its host syncs counted, its AggOp held on
   ``sort`` (``acc_kind:smin``), profiled once at SF1; then the
   expression sweep (``it/queries.expression_sweep_dataframe``: every
   scalar function and expression node of the port) over SF10's
   customer (960,000 rows) and item tables, run on the card and through
   ``Session(device="cpu")`` over the same files, compared cell by cell
   (``it.comparator.compare_cells``: exact, but the transcendental
   columns within ``it.comparator.ULP_BOUND`` units in the last place);
   each card run timed by its checked run, its syncs counted and
   profiled once at SF1. ``cuda_sum_count.launches`` stays 0.

Decimal columns through the same Session, run after phase e over phase
p's SF10 store_sales files:

d. ``columnar/decimal128.py`` on the card against the same functions on
   the CPU, bit for bit, over 2^20 seeded 128-bit values and their limb
   edges (add, sub, mul, cmp, to_float64, and mul_pow10,
   div_pow10_half_up, div_pow10_trunc and fits_precision at k in {1, 9,
   10, 18, 19, 38}), with the launches and device time of one mul128
   and one div_pow10_half_up at k = 38; then q15
   (``it/queries.q15_dataframe``: decimal(25,2) x decimal(20,0) on the
   limbs, a top-25 sort on the decimal(38,2) product),
   ``decimal_money_dataframe`` (narrow and wide sums and averages, wide
   min and max, a narrow product whose sum moves to the limbs, per
   store) and ``decimal_price_key_dataframe`` (a decimal(20,2) group key
   through the hash table, a top-100 sort on it), each checked exactly
   against its Python ``decimal`` oracle (rows, order and result types),
   timed by its checked run, its syncs counted, its AggOps' paths held
   (``sort``/``acc_kind:dsum`` for the money query, ``hashtable`` for the
   price key), and profiled once at SF1. ``cuda_sum_count.launches``
   stays 0.

Window functions and grouping sets through the same Session, run after
phase d over phase p's files and item:

w. q16 (``it/queries.q16_dataframe``: a float sum per (store, item),
   ~28.2 M groups, ``rank()`` within the store by the sum descending,
   the top 3, a sort) and ``rollup_rank_dataframe`` (a broadcast join
   on the item, ``rollup(i_category, i_brand)`` of price × quantity,
   ``rank()`` within the category, the top 5), each held against a
   numpy oracle (``check_ranked``: keys exact, sums within 1e-12 of the
   group's sum of |v|, ranks within what the oracle's near-ties allow
   and at most the cut, no more rows than the groups that may pass it,
   every group of a certain rank present, rows in order), timed by its
   checked run, its host syncs counted per input batch and the window
   operator's per window batch, each window batch's peak device bytes
   recorded, and profiled once at SF1; q16 at SF1 once more with each
   device-to-host copy charged to its caller (``d2h_sources``); then
   the window sweep
   (``it/queries.window_sweep_dataframes``: every window function, ROWS
   frames, string, narrow and wide decimal and float values with NaN and
   ±inf, a group limit, no partition key, a cube over 3 keys) over SF1's
   tables on the card against ``Session(device="cpu")`` on the same
   files, cell by cell (exact; float sums and averages within 1e-12 of
   their frame's sum of |v|). ``cuda_sum_count.launches`` stays 0.

The TPC-DS and TPC-H suites through the same Session, run after phase
w (``it/tpcds.py``, ``it/tpcds_queries.py``, ``it/tpch.py``,
``it/tpch_queries.py``, generated under the same directory):

q. TPC-DS at scale 1.0 (store_sales 1,000,000 rows, catalog_sales
   500,000, web_sales 250,000, store_returns 100,000; item 18,000,
   customer 100,000: the reference's own full-gate setting) and TPC-H at
   scale 10 (600,000 lineitems). Both are depth cuts for the limit:
   TPC-DS at 2.88 has SF1's fact rows, TPC-H at 100 is SF1. The
   oracles (pyarrow and pandas) run first in worker processes
   (``it.runner.suite_oracles``); then every query runs in a fresh
   ``Session`` on the card through ``it.runner``, in ``QUERIES`` order,
   and must match its oracle with the reference's comparator (TPC-DS:
   1e-7 relative, 1e-6 absolute; TPC-H 1e-7 and 1e-5; decimals cast to
   float64) and return rows: 95 TPC-DS queries and 6 TPC-H ones. q16,
   q94, q95 and q28 must raise ``NotImplementedError`` naming ROADMAP
   item 16f-c (DISTINCT aggregates). Per query: the wall ms of its
   checked run (the oracle's ms apart), its rows, host syncs, scalar
   subqueries resolved and their ms, and ``cuda_sum_count.launches``;
   per suite the totals. q14 and the slowest query are profiled once.

The input is bench.py's measured distribution, made with numpy from seed
0: keys uniform on [0, 65536), v normal with 5% nulls, f uniform on
[0, 40). 2^22 rows also hold all 2,880,404 rows of TPC-DS SF1
store_sales in one batch.

Output: progress lines, then a JSON line of the stage's numbers, the
pipeline, Session, join, string, expression, decimal, window and suite
phases and the comparisons, the
``{"kernels": [...]}`` line, the card's name and power limit as
nvidia-smi prints them, and last ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
import warnings
from pathlib import Path

import numpy as np
import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch.columnar.batch import (PrimitiveColumn, batch_from_numpy,
                                            batch_to_numpy)
from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.entry import (_DOMAIN, _HASH_AGG_CAPACITY,
                                   _q01_kernel_hash, _q01_kernel_sort, entry)
from auron_tpu_torch.hashtable import (DeviceHashTable, HashAggState,
                                       build_join_index)
from auron_tpu_torch.hashtable import core as htcore
from auron_tpu_torch.kernels import _build, dispatch
from auron_tpu_torch.kernels import grouped_agg as gagg
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.base import host_readback

SIZES = (1 << 20, 1 << 22)
WARMUP, ITERS = 5, 50
SEED = 0
#: calls per torch.profiler window of a device-time comparison, and the
#: windows taken before CUDA events time the calls instead
PROFILE_ITERS, PROFILE_WINDOWS = 20, 5
#: device-time comparisons the profiler missed: windows that recorded no
#: kernel, and calls that CUDA events timed
EVENT_TIMED = {"missed_windows": 0, "calls": 0}
#: clock cycles of the spin kernel ahead of an event-timed call (~0.5 ms)
SPIN_CYCLES = 1_000_000
#: a write of this many bytes between launches evicts the 50 MB L2
FLUSH_BYTES = 64 << 20
#: the small domain, and the domains of the shared-vs-global sweep
SMALL_DOMAIN = 1000
SWEEP_DOMAINS = (2048, 4096, 8192, 16384)
#: the redesign, then the first design's kernel
VARIANTS = gagg._VARIANTS

#: per-key tolerance of f32 sums, as a share of the key's sum of |v|:
#: f32 accumulation (2^-24 relative per add) of ~16-64 terms per key,
#: added in an order that changes from run to run
F32_SUM_TOL = 1e-5
#: the same for the float64 sort twin against the float64 oracle
F64_SUM_TOL = 1e-12

#: peak rates for the bound: f32 adds outside the tensor cores
F32_OPS_PER_S = 67e12

#: the streaming phase: batches, rows per batch, distinct keys (TPC-DS
#: SF1's customer table) and the table's first capacity
STREAM_BATCHES, STREAM_ROWS, STREAM_KEYS = 4, 1 << 20, 100_000
STREAM_CAPACITY = 4096
#: 100,000 keys at load factor 0.5 need 2^18 slots: six doublings
STREAM_DOUBLINGS = 6
#: int64 sum, count, min, max, first, and a float64 sum
STREAM_KINDS = ("sum", "sum", "min", "max", "first", "sum")
I64 = np.iinfo(np.int64)
#: the build/probe phase: rows, and distinct keys of the join's build side
TABLE_ROWS, JOIN_KEYS = 1 << 20, 1 << 18
#: the pipeline phase with ``--profile-at-sf10``: scale 240 is 28,800,000
#: store_sales rows (TPC-DS SF10 has 28,800,991), in 4 partitions (else
#: it runs at JOIN_CHECK_SCALE, SF1); the row-order check's scale
PIPE_SCALE, PIPE_PARTITIONS, PIPE_ORDER_SCALE = 240, 4, 1
#: timed queries per plan, after one warm-up
PIPE_RUNS = 3
#: the dimension tables of phases j and t, written beside the
#: fact files; the scale of phase j's checked-only joins and of phase t's
#: profiled queries (SF1's 2,880,000 rows)
JOIN_DIMENSIONS = ("date_dim", "item", "customer", "store")
JOIN_CHECK_SCALE = 24
#: the string queries of phase t, in it/queries.py's order
STRING_QUERIES = ("q03", "q04", "q06", "q07", "q08", "q09")
#: phase q: TPC-DS at scale 1.0 (1,000,000 store_sales rows) and TPC-H
#: at scale 10 (600,000 lineitems), depth cuts for the limit: SF1 is
#: 2.88 (2,880,000 store_sales rows) and 100 (6,000,000 lineitems)
SUITE_TPCDS_SCALE, SUITE_TPCH_SCALE = 1.0, 10
#: the TPC-DS queries whose DISTINCT aggregates wait for ROADMAP item 16f-c
SUITE_DISTINCT = ("q16", "q94", "q95", "q28")
#: the directory of the repo, under which the parquet run writes its files
ROOT = Path(__file__).resolve().parent


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def run(cmd: list[str]) -> str:
    return subprocess.run(cmd, check=True, capture_output=True,
                          text=True).stdout.strip()


def mem_bytes_per_s(name: str) -> float:
    """Device-memory rate of the card from its name (NVIDIA data sheets)."""
    if "H200" in name:
        return 4.8e12
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12   # H100 SXM


def time_ms(fn) -> float:
    """Median over ITERS of one call, bracketed by CUDA events."""
    for _ in range(WARMUP):
        fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def bench_columns(n: int, seed: int = SEED) -> dict:
    """bench.py's make_batch distribution, drawn in the same order."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 65536, size=n).astype(np.int64)
    v = rng.normal(size=n)
    f = rng.integers(0, 40, size=n).astype(np.int32)
    v_valid = rng.random(n) > 0.05
    return {"k": k, "v": v, "f": f, "v_valid": v_valid}


def stage_operands(host: dict, dev) -> tuple:
    """(k, v, c) as the flagship stage hands them to the kernel."""
    keep = (host["f"] > 10) & host["v_valid"]
    k = np.clip(host["k"], 0, _DOMAIN - 1).astype(np.int32)
    v = np.where(keep, host["v"], 0.0).astype(np.float32)
    c = keep.astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev) for a in (k, v, c))


def abs_sums(k, v, key_domain: int) -> torch.Tensor:
    """Per-key sum of |v| in float64, the scale of each key's tolerance."""
    ok = (k >= 0) & (k < key_domain)
    return torch.zeros(key_domain, dtype=torch.float64, device=k.device) \
        .index_add_(0, k[ok].long(), v[ok].abs().double())


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_env() -> str:
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"torch CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script measures "
                         "the port on the card and has no CPU mode")
    log("nvcc: " + run([_build._nvcc(), "--version"]).splitlines()[-1])
    card = run(["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"]).splitlines()[0]
    log(f"card: {card}; torch sees {torch.cuda.device_count()} "
        f"device(s), {torch.cuda.get_device_name(0)}")
    return card


def sass_summary(lib: Path) -> dict:
    """Per kernel of ``lib``: its registers and the atomic and reduction
    ops of its SASS, from cuobjdump; empty where the toolkit lacks it."""
    tool = Path(_build._nvcc()).parent / "cuobjdump"
    if not tool.exists():
        log(f"{tool} not found: no SASS summary")
        return {}
    out, fn = {}, None
    for line in run([str(tool), "-sass", str(lib)]).splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = {"atomics": set()}
        m = re.search(r"\b((?:REDG|RED|ATOMG|ATOMS|ATOM)\.[\w.]+)", line)
        if m and fn:
            out[fn]["atomics"].add(m.group(1))
    for line in run([str(tool), "-res-usage", str(lib)]).splitlines():
        m = re.search(r"Function (\S+?):?$", line.strip())
        if m:
            fn = m.group(1)
        m = re.search(r"REG:(\d+)", line)
        if m and fn in out:
            out[fn]["registers"] = int(m.group(1))
    return {name: {**d, "atomics": sorted(d["atomics"])}
            for name, d in out.items()}


def phase_build() -> tuple[float, dict]:
    t0 = time.perf_counter()
    libs = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"built {[p.name for p in libs]} in {build_s:.2f} s")
    sass = {}
    for lib in libs:
        sass.update(sass_summary(lib))
    for name, d in sass.items():
        log(f"SASS {name}: {json.dumps(d)}")
    return build_s, sass


def zipf_keys(rng, n: int, domain: int, exponent: float = 1.1):
    """Keys with P(rank r) proportional to r^-exponent over ``domain``
    keys, the ranks scattered over the domain by a permutation."""
    p = np.arange(1, domain + 1, dtype=np.float64) ** -exponent
    ranks = rng.choice(domain, size=n, p=p / p.sum())
    return rng.permutation(domain)[ranks]


def kernel_cases(dev):
    """The shapes the kernel is held to: (name, k, v, c, key_domain,
    exact) with ``exact`` where the sums must be identical."""
    rng = np.random.default_rng(1)
    n = SIZES[0]

    def tensors(k, v, valid):
        v = np.where(valid, v, 0.0).astype(np.float32)
        return (torch.from_numpy(k.astype(np.int32)).to(dev),
                torch.from_numpy(v).to(dev),
                torch.from_numpy(valid.astype(np.float32)).to(dev))

    keys = rng.integers(0, _DOMAIN, n)
    valid = rng.random(n) > 0.05
    yield ("random_f32", *tensors(keys, rng.normal(size=n), valid),
           _DOMAIN, False)
    yield ("integer_valued",
           *tensors(keys, rng.integers(-100, 100, n), valid), _DOMAIN, True)
    # all rows on one key: partial sums stay below 8 * 2^20 < 2^24
    yield ("single_group", *tensors(np.full(n, 37), rng.integers(-8, 8, n),
                                    np.ones(n, bool)), _DOMAIN, True)
    full = np.arange(_DOMAIN)
    yield ("full_domain", *tensors(full, full % 97,
                                   np.ones(_DOMAIN, bool)), _DOMAIN, True)
    oor = rng.integers(0, SMALL_DOMAIN, n)
    oor[rng.integers(0, n, 5000)] = rng.choice(
        [-1, 1000, 1500, 3000, 70000], 5000)
    yield ("out_of_range", *tensors(oor, rng.integers(-100, 100, n), valid),
           SMALL_DOMAIN, True)
    yield ("zipf_1.1", *tensors(zipf_keys(rng, n, _DOMAIN),
                                rng.normal(size=n), valid), _DOMAIN, False)
    # a sorted or clustered column: runs of ~16 equal keys
    yield ("sorted_runs", *tensors(np.sort(keys), rng.integers(-100, 100, n),
                                   valid), _DOMAIN, True)
    yield ("small_domain", *tensors(rng.integers(0, SMALL_DOMAIN, n),
                                    rng.integers(-100, 100, n), valid),
           SMALL_DOMAIN, True)
    # a contiguous slice 4 bytes past a 256-byte boundary: scalar loads
    m = 2049
    k, v, c = tensors(rng.integers(0, _DOMAIN, m), rng.integers(-9, 9, m),
                      rng.random(m) > 0.05)
    yield ("unaligned_slice", k[1:], v[1:], c[1:], _DOMAIN, True)
    # n % 4 rows only, with an out-of-range key on each side
    yield ("tail_only_n6", *tensors(np.array([5, 5, 7, 70000, -1, 5]),
                                    np.arange(1, 7), np.ones(6, bool)),
           SMALL_DOMAIN, True)


def nan_case(dev):
    """One NaN value, on key 3 of a small domain with integer values."""
    rng = np.random.default_rng(2)
    n = 1 << 16
    k = rng.integers(0, SMALL_DOMAIN, n).astype(np.int32)
    v = rng.integers(-100, 100, n).astype(np.float32)
    k[123] = 3
    v[123] = np.nan
    return (torch.from_numpy(k).to(dev), torch.from_numpy(v).to(dev),
            torch.ones(n, dtype=torch.float32, device=dev), SMALL_DOMAIN)


def launches_of(k, dom: int):
    """(label, fn) for every way the kernel is held on a case: the
    wrapper, each variant of ``_launch`` and, where the domain fits
    shared memory, both paths of the redesign."""
    out = [("cuda_sum_count", lambda k, v, c: gagg.cuda_sum_count(
        k, v, c, dom))]
    for var in VARIANTS:
        out.append((var, lambda k, v, c, var=var: gagg._launch(
            k, v, c, dom, var)))
    if dom <= SWEEP_DOMAINS[-1]:
        for path in (gagg.PATH_GLOBAL, gagg.PATH_SHARED):
            out.append((f"path{path}", lambda k, v, c, path=path:
                        gagg._launch(k, v, c, dom, path=path)))
    return out


def phase_kernel_checks(dev) -> float:
    """cuda_sum_count and every variant against sum_count_reference."""
    max_err = 0.0
    for name, k, v, c, dom, exact in kernel_cases(dev):
        ref_s, ref_c = gagg.sum_count_reference(k, v, c, dom)
        tol = F32_SUM_TOL * abs_sums(k, v, dom)
        for label, fn in launches_of(k, dom):
            sums, counts = fn(k, v, c)
            torch.cuda.synchronize()
            what = f"{name} via {label}"
            check(torch.equal(counts, ref_c), f"{what}: counts identical")
            err = (sums.double() - ref_s.double()).abs()
            if exact:
                check(torch.equal(sums, ref_s), f"{what}: sums identical")
            else:
                check(bool((err <= tol).all()),
                      f"{what}: |dsum| <= {F32_SUM_TOL} * sum|v| per key")
            max_err = max(max_err, float(err.max()))
        log(f"kernel check {name}: rows {k.shape[0]}, key_domain {dom}, "
            f"{len(launches_of(k, dom))} launches, max |dsum| "
            f"{float(err.max()):.3e}: ok")

    k, v, c, dom = nan_case(dev)
    ref_s, ref_c = gagg.sum_count_reference(k, v, c, dom)
    check(torch.isnan(ref_s).nonzero().flatten().tolist() == [3],
          "nan: the plain version puts NaN on key 3 only")
    for label, fn in launches_of(k, dom):
        sums, counts = fn(k, v, c)
        torch.cuda.synchronize()
        check(torch.equal(torch.isnan(sums), torch.isnan(ref_s)),
              f"nan via {label}: NaN on its own key only")
        rest = ~torch.isnan(ref_s)
        check(torch.equal(sums[rest], ref_s[rest])
              and torch.equal(counts, ref_c),
              f"nan via {label}: every other key identical")
    log("kernel check nan_value: NaN on key 3 only: ok")
    return max_err


def groups(out) -> dict:
    """Valid groups of a stage output as numpy arrays sorted by key."""
    gk, gv, gs, gc, ga = (t.cpu().numpy() for t in out)
    order = np.argsort(gk[gv], kind="stable")
    return {"keys": gk[gv][order], "sums": gs[gv][order],
            "counts": gc[gv][order], "avg": ga[gv][order]}


def hold_stage(out, host: dict, label: str, tol: float = F32_SUM_TOL
               ) -> tuple[dict, np.ndarray, np.ndarray]:
    """The stage's output against a float64 oracle, sums within ``tol``
    of each key's sum of |v|; returns its groups and the oracle's sums
    and sum of |v| for the same keys."""
    keep = (host["f"] > 10) & host["v_valid"]
    k, v = host["k"][keep], host["v"][keep]
    o_cnt = np.bincount(k, minlength=_DOMAIN)
    o_sum = np.bincount(k, weights=v, minlength=_DOMAIN)
    o_abs = np.bincount(k, weights=np.abs(v), minlength=_DOMAIN)
    present = np.nonzero(o_cnt)[0]

    dense = groups(out)
    check(np.array_equal(dense["keys"], present), f"{label}: group set")
    check(np.array_equal(dense["counts"], o_cnt[present]),
          f"{label}: counts vs oracle")
    check(bool(np.all(np.abs(dense["sums"] - o_sum[present])
                      <= tol * o_abs[present])),
          f"{label}: sums vs float64 oracle")
    return dense, o_sum[present], o_abs[present]


def phase_stage(dev) -> tuple[int, dict]:
    """The main path: entry()'s stage at each size, launch counts from 0."""
    fn, (example,) = entry()
    check(example.device.type == "cuda", "entry() runs on the card")
    ex, twin = groups(fn(example)), groups(_q01_kernel_sort(example))
    check(np.array_equal(ex["keys"], twin["keys"])
          and np.array_equal(ex["counts"], twin["counts"]),
          "entry()'s example batch: groups and counts vs sort twin")
    data = {n: bench_columns(n) for n in SIZES}
    batches = {}
    for n, host in data.items():
        ones = np.ones(n, np.bool_)
        batches[n] = batch_from_numpy(
            [(host["k"], ones), (host["v"], host["v_valid"]),
             (host["f"], ones)], n, dev)
    torch.cuda.synchronize()

    gagg.cuda_sum_count.launches = 0
    outs = {}
    for i, n in enumerate(SIZES, 1):
        outs[n] = fn(batches[n])
        check(gagg.cuda_sum_count.launches == i,
              f"stage at {n} rows launched cuda_dense_sum_count once")
    torch.cuda.synchronize()
    launches = gagg.cuda_sum_count.launches

    dense_groups = {}
    for n in SIZES:
        dense, o_sum, o_abs = hold_stage(outs[n], data[n], f"stage {n}")
        dense_groups[n] = dense
        twin = groups(_q01_kernel_sort(batches[n]))
        check(np.array_equal(twin["keys"], dense["keys"]),
              f"stage {n}: group set vs sort twin")
        check(np.array_equal(twin["counts"], dense["counts"]),
              f"stage {n}: counts vs sort twin")
        check(bool(np.all(np.abs(twin["sums"] - dense["sums"])
                          <= F32_SUM_TOL * o_abs)),
              f"stage {n}: sums vs sort twin")
        check(bool(np.all(np.abs(twin["sums"] - o_sum)
                          <= F64_SUM_TOL * o_abs)),
              f"stage {n}: sort twin vs float64 oracle")
        log(f"stage {n} rows: {dense['keys'].size} groups, matches sort "
            f"twin and oracle")
    return launches, {"data": data, "batches": batches, "fn": fn,
                      "dense": dense_groups}


def loop_counts() -> tuple[int, int]:
    """(claim rounds, host syncs) of the hash table's loops so far."""
    return (htcore.insert_loop.rounds + htcore.probe_loop.rounds,
            htcore.insert_loop.syncs + htcore.probe_loop.syncs)


def phase_hash_twin(dev, stage: dict) -> dict:
    """a. The hash twin on the card against the float64 oracle and the
    dense stage's counts; its claim rounds and host syncs per call."""
    _fn, (example,) = entry()
    on_card = [t.cpu() for t in _q01_kernel_hash(example)]
    on_cpu = _q01_kernel_hash(batch_from_numpy(
        *batch_to_numpy(example), "cpu"))
    for i in (0, 1, 3):
        check(torch.equal(on_card[i], on_cpu[i]),
              "hash twin on the example batch: slot order, keys and counts "
              "identical on the card and on the CPU")
    out = {}
    for n in SIZES:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        r0, s0 = loop_counts()
        res = _q01_kernel_hash(stage["batches"][n])
        torch.cuda.synchronize()
        r1, s1 = loop_counts()
        peak = torch.cuda.max_memory_allocated() - base
        check(all(t.device.type == "cuda" for t in res),
              f"hash twin {n}: every output on the card")
        check(res[1].shape[0] == _HASH_AGG_CAPACITY,
              f"hash twin {n}: one entry per slot")
        got, o_sum, o_abs = hold_stage(res, stage["data"][n], f"hash twin {n}",
                                       F64_SUM_TOL)
        dense = stage["dense"][n]
        check(np.array_equal(got["keys"], dense["keys"])
              and np.array_equal(got["counts"], dense["counts"]),
              f"hash twin {n}: groups and counts vs the dense stage")
        out[n] = {"groups": int(got["keys"].size), "claim_rounds": r1 - r0,
                  "host_syncs": s1 - s0, "peak_bytes": peak,
                  "max_rel_err": float(np.max(np.abs(got["sums"] - o_sum)
                                              / np.maximum(o_abs, 1e-300)))}
        log(f"hash twin {n} rows: {json.dumps(out[n])}: matches oracle "
            "and dense stage")
    return out


def stream_oracle(k, v, ok, fv) -> dict:
    """Per key, sorted by key: int64 sum, count, min, max, first and the
    float64 sum and sum of |v|, from numpy over the rows in order."""
    order = np.argsort(k, kind="stable")
    ks = k[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    vo, oko, fvo = v[order], ok[order], fv[order]

    def red(ufunc, a):
        return ufunc.reduceat(a, starts)

    return {"keys": ks[starts],
            "sum": red(np.add, np.where(oko, vo, 0)),
            "count": red(np.add, oko.astype(np.int64)),
            "min": red(np.minimum, np.where(oko, vo, I64.max)),
            "max": red(np.maximum, np.where(oko, vo, I64.min)),
            "first": vo[starts],
            "fsum": red(np.add, np.where(oko, fvo, 0.0)),
            "fabs": red(np.add, np.where(oko, np.abs(fvo), 0.0))}


def phase_hash_stream(dev) -> dict:
    """b. HashAggState from 4096 slots over 4 batches: growth, exact
    integer accumulators, a float64 sum the hash backend forces."""
    key = (DataType.INT64,)
    forced = dispatch.select_hash_agg(
        key_dtypes=key, acc_kinds=STREAM_KINDS, has_float_sum=True,
        conf=cfg.AuronConfig({cfg.HASHTABLE_BACKEND: "hash"}), record=False)
    auto = dispatch.select_hash_agg(
        key_dtypes=key, acc_kinds=STREAM_KINDS, has_float_sum=True,
        conf=cfg.AuronConfig(), record=False)
    check(forced.is_hash and auto.reason == "float_sum_inexact",
          "backend=hash forces the float64 sum onto the table; auto not")
    state = HashAggState(STREAM_KINDS, initial_capacity=STREAM_CAPACITY,
                         load_factor=forced.load_factor,
                         max_probe_rounds=forced.max_probe_rounds)
    rng = np.random.default_rng(SEED + 10)
    host = {"k": [], "v": [], "ok": [], "fv": []}
    batches = []
    for b in range(STREAM_BATCHES):
        n = STREAM_ROWS
        k = rng.integers(0, STREAM_KEYS, n).astype(np.int64)
        v = rng.integers(-10**6, 10**6, n).astype(np.int64)
        ok = rng.random(n) > 0.05
        fv = rng.normal(size=n)
        for name, a in zip(host, (k, v, ok, fv)):
            host[name].append(a)
        kt, vt, okt, fvt = (torch.from_numpy(a).to(dev)
                            for a in (k, v, ok, fv))
        contribs = (torch.where(okt, vt, 0), okt.to(torch.int64),
                    torch.where(okt, vt, I64.max),
                    torch.where(okt, vt, I64.min), vt,
                    torch.where(okt, fvt, 0.0))
        torch.cuda.synchronize()
        r0, s0 = loop_counts()
        t0 = time.perf_counter()
        state.update((PrimitiveColumn(kt, torch.ones_like(okt)),), contribs,
                     torch.ones_like(okt))
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        r1, s1 = loop_counts()
        batches.append({"batch": b, "ms": ms, "capacity": state.cap,
                        "groups": state.count, "table_bytes": state.nbytes(),
                        "claim_rounds": r1 - r0, "host_syncs": s1 - s0})
        log(f"stream batch {b}: {json.dumps(batches[-1])}")
    doublings = (state.cap // STREAM_CAPACITY).bit_length() - 1
    check(doublings >= STREAM_DOUBLINGS,
          f"stream: the table grew {STREAM_DOUBLINGS} times or more "
          f"(to {state.cap} slots)")

    cols, accs, ng, cap, h = state.to_sorted_table()
    ng = int(ng)
    want = stream_oracle(*(np.concatenate(host[x]) for x in host))
    check(ng == want["keys"].size == state.count, "stream: group count")
    hh = h.cpu().numpy()
    check(np.all(hh[ng:] == htcore.EMPTY)
          and np.all(np.diff(hh[:ng].view(np.uint64)) > 0),
          "stream: export sorted by hash as uint64, dead slots last")
    keys = cols[0].data[:ng].cpu().numpy()
    order = np.argsort(keys)
    check(np.array_equal(keys[order], want["keys"]), "stream: group keys")
    got = {name: a[:ng].cpu().numpy()[order] for name, a in zip(
        ("sum", "count", "min", "max", "first", "fsum"), accs)}
    for name in ("sum", "count", "min", "max", "first"):
        check(np.array_equal(got[name], want[name]),
              f"stream: int64 {name} identical to numpy")
    check(bool(np.all(np.abs(got["fsum"] - want["fsum"])
                      <= F64_SUM_TOL * want["fabs"])),
          f"stream: float64 sums within {F64_SUM_TOL} * sum|v| per key")
    log(f"stream: {ng} groups in {cap} slots, every accumulator holds")
    return {"batches": batches, "groups": ng, "capacity": cap,
            "doublings": doublings, "table_bytes": state.nbytes(),
            "rows_per_s": STREAM_BATCHES * STREAM_ROWS
            / (sum(b["ms"] for b in batches) / 1e3)}


def phase_hash_table(dev) -> dict:
    """c. DeviceHashTable insert/probe against numpy; the join index
    against torch.searchsorted."""
    rng = np.random.default_rng(SEED + 20)
    n = TABLE_ROWS
    keys = rng.integers(0, 1 << 19, n).astype(np.int64) * 2097143
    kt = torch.from_numpy(keys).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    col = (PrimitiveColumn(kt, ones),)
    table = DeviceHashTable(initial_capacity=1 << 21)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    slot, is_new = table.insert(col, ones)
    torch.cuda.synchronize()
    insert_ms = (time.perf_counter() - t0) * 1e3
    uniq, first, inv = np.unique(keys, return_index=True, return_inverse=True)
    sl = slot.cpu().numpy()
    check(table.count == uniq.size, "table: one slot per distinct key")
    check(np.array_equal(np.flatnonzero(is_new.cpu().numpy()),
                         np.sort(first)), "table: is_new on first rows")
    check(np.array_equal(sl[first][inv], sl)
          and np.unique(sl[first]).size == uniq.size,
          "table: equal keys share a slot, distinct keys do not")
    stored = table.keys_columns()[0]
    check(torch.equal(stored.data[slot], kt), "table: stored keys")

    m = n // 10
    probe = np.concatenate([keys[rng.integers(0, n, n - m)],
                            -rng.integers(1, 1 << 40, m)])
    rng.shuffle(probe)
    pt = torch.from_numpy(probe).to(dev)
    pcol = (PrimitiveColumn(pt, ones),)
    r0, s0 = loop_counts()
    p_slot, found = table.probe(pcol, ones)
    torch.cuda.synchronize()
    r1, s1 = loop_counts()
    fnp = found.cpu().numpy()
    check(np.array_equal(fnp, np.isin(probe, keys)),
          "probe: found exactly the inserted keys")
    check(torch.equal(stored.data[p_slot][found], pt[found]),
          "probe: each found key's slot holds it")
    probe_ms = time_ms(lambda: table.probe(pcol, ones))

    jk = torch.from_numpy(rng.integers(0, JOIN_KEYS, n).astype(
        np.int64)).to(dev)
    h = hashing.xxhash64_columns([PrimitiveColumn(jk, ones)], n)
    h_sorted = torch.sort(h).values
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    index = build_join_index(h_sorted)
    torch.cuda.synchronize()
    build_ms = (time.perf_counter() - t0) * 1e3
    check(index is not None, "join index built")
    ph = torch.cat([h[torch.randint(0, n, (n - m,), device=dev)],
                    torch.randint(-(1 << 62), 1 << 62, (m,), device=dev)])
    lo, cnt = index.lookup(ph)
    left = torch.searchsorted(h_sorted, ph)
    right = torch.searchsorted(h_sorted, ph, right=True)
    check(torch.equal(cnt.long(), right - left)
          and torch.equal(lo.long(), torch.where(right > left, left, 0)),
          "join index: (lo, count) identical to searchsorted")
    out = {"rows": n, "distinct": int(uniq.size), "capacity": table.cap,
           "insert_ms": insert_ms, "probe_ms": probe_ms,
           "probe_claim_rounds": r1 - r0, "probe_host_syncs": s1 - s0,
           "join_build_ms": build_ms,
           "join_lookup_ms": time_ms(lambda: index.lookup(ph)),
           "searchsorted_ms": time_ms(lambda: (
               torch.searchsorted(h_sorted, ph),
               torch.searchsorted(h_sorted, ph, right=True)))}
    log(f"table and join index: {json.dumps(out)}: match numpy and "
        "searchsorted")
    return out


def device_profile(fn, iters: int = 20, top: int = 8,
                   host_ops: bool = True, warm: bool = False) -> dict:
    """Per call: wall ms, device ms summed over CUDA kernels, the busy
    share of the device, the device kernels and memsets launched, and
    the kernels that took the most device time. The device events are
    read from the trace's raw records: building the profiler's per-event
    tables takes ~0.2 ms per launch, minutes for a query of 10^6
    launches.
    The profiler's own cost is inside the wall time. Device numbers are
    None when the profiler saw no CUDA kernel. ``host_ops=False`` leaves
    the host's operators out of the trace, which keeps a trace of
    ~10^5 launches cheap to record and to read. ``warm=True`` skips the
    warm-up call, for a caller that has just run ``fn``."""
    from torch.profiler import ProfilerActivity, profile

    if not warm:
        fn()
    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA]
    if host_ops:
        activities.insert(0, ProfilerActivity.CPU)
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / iters
    by_kernel, launched = {}, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA \
                and not e.is_user_annotation():
            by_kernel[e.name()] = by_kernel.get(e.name(), 0.0) \
                + e.duration_ns() / 1e6 / iters
            launched += 1
    device_ms = sum(by_kernel.values()) if by_kernel else None
    most = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": None if device_ms is None else device_ms / wall_ms,
            "launches_per_call": launched / iters,
            "top_kernels_ms": [[name[:80], ms] for name, ms in most]}


def phase_profile(dev, stage: dict) -> dict:
    out = {}
    for n in SIZES:
        k, v, c = stage_operands(stage["data"][n], dev)
        kern = device_profile(lambda: gagg.cuda_sum_count(k, v, c, _DOMAIN))
        mine = [ms for name, ms in kern["top_kernels_ms"]
                if "dense_sum_count" in name]
        kern["dense_sum_count_ms"] = mine[0] if mine else None
        batch = stage["batches"][n]
        out[n] = {"kernel": kern,
                  "stage": device_profile(lambda: stage["fn"](batch)),
                  "sort_twin": device_profile(
                      lambda: _q01_kernel_sort(batch)),
                  "hash_twin": device_profile(
                      lambda: _q01_kernel_hash(batch), top=12)}
        log(f"profile at {n} rows: {json.dumps(out[n])}")
    return out


def bound_ms(rows: int, key_domain: int, rate: float) -> tuple[float, str]:
    """Least time for the function: 12 B/row in and 8 B/key out at the
    memory rate, or 2 f32 adds/row at the f32 rate, whichever is longer."""
    by_bytes = (12 * rows + 8 * key_domain) / rate * 1e3
    by_ops = 2 * rows / F32_OPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                           "operations")


def phase_times(dev, stage: dict, rate: float) -> tuple[list, dict]:
    def library(k, v, c):
        s = torch.zeros(_DOMAIN, dtype=torch.float32, device=dev)
        cn = torch.zeros(_DOMAIN, dtype=torch.float32, device=dev)
        s.index_add_(0, k, v)
        cn.index_add_(0, k, c)

    launches_before = gagg.cuda_sum_count.launches
    per_size, stage_times = [], []
    for n in SIZES:
        k, v, c = stage_operands(stage["data"][n], dev)
        bnd, by = bound_ms(n, _DOMAIN, rate)
        row = {"rows": n, "key_domain": _DOMAIN,
               "ms": time_ms(lambda: gagg.cuda_sum_count(k, v, c, _DOMAIN)),
               "plain_ms": time_ms(
                   lambda: gagg.sum_count_reference(k, v, c, _DOMAIN)),
               "library_ms": time_ms(lambda: library(k, v, c)),
               "bound_ms": bnd, "bound_by": by}
        per_size.append(row)
        log(f"kernel at {n} rows: {json.dumps(row)}")
        batch = stage["batches"][n]
        st_ms = time_ms(lambda: stage["fn"](batch))
        sort_ms = time_ms(lambda: _q01_kernel_sort(batch))
        hash_ms = time_ms(lambda: _q01_kernel_hash(batch))
        stage_times.append({"rows": n, "stage_ms": st_ms,
                            "stage_rows_per_s": n / (st_ms / 1e3),
                            "sort_twin_ms": sort_ms,
                            "sort_twin_rows_per_s": n / (sort_ms / 1e3),
                            "hash_twin_ms": hash_ms,
                            "hash_twin_rows_per_s": n / (hash_ms / 1e3)})
        log(f"stage at {n} rows: {json.dumps(stage_times[-1])}")

    n = SIZES[0]
    k = torch.full((n,), 37, dtype=torch.int32, device=dev)
    v = torch.ones(n, dtype=torch.float32, device=dev)
    single = {"rows": n, "ms": time_ms(
        lambda: gagg.cuda_sum_count(k, v, v, _DOMAIN)),
        "plain_ms": time_ms(lambda: gagg.sum_count_reference(k, v, v,
                                                             _DOMAIN)),
        "bound_ms": bound_ms(n, _DOMAIN, rate)[0]}
    log(f"single group at {n} rows: {json.dumps(single)}")
    check(gagg.cuda_sum_count.launches > launches_before,
          "timed runs launched the kernel")
    return per_size, {"stages": stage_times, "single_group": single}


def kernel_device_ms(fn, flush=None, iters: int = PROFILE_ITERS,
                     windows: int = PROFILE_WINDOWS) -> float:
    """Mean device ms per call of the dense_sum_count kernels ``fn``
    launches, from torch.profiler; ``flush`` runs before each call, and
    its kernels are not counted. A profiler window now and then records
    no kernel at all; such a window is taken again, up to ``windows``
    times in all, and after that the calls are timed with CUDA events
    (``event_ms``) and counted in ``EVENT_TIMED``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(windows):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if flush is not None:
                    flush()
                fn()
            torch.cuda.synchronize()
        total = sum(e.self_device_time_total for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA
                    and "dense_sum_count" in e.key)
        if total > 0:
            return total / 1e3 / iters
        EVENT_TIMED["missed_windows"] += 1
        log("a profiler window recorded no dense_sum_count kernel; "
            "taking it again")
    EVENT_TIMED["calls"] += 1
    ms = event_ms(fn, flush, iters)
    log(f"the profiler saw no dense_sum_count kernel in {windows} "
        f"windows; CUDA events time the call at {ms} ms")
    return ms


def event_ms(fn, flush=None, iters: int = PROFILE_ITERS) -> float:
    """Mean ms per call of ``fn`` between two CUDA events recorded
    around it on the stream; ``flush`` runs outside the events. A spin
    kernel ahead of each start event keeps the stream busy while the
    host enqueues the call, so the events hold its device work and not
    the host's launch time."""
    pairs = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    for start, end in pairs:
        if flush is not None:
            flush()
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.mean(s.elapsed_time(e) for s, e in pairs)


def in_turns(fns: dict, flush=None) -> dict:
    """Device ms of each of ``fns``, timed in turns a, b, .., .., b, a:
    {name: [first turn, second turn]}."""
    got = {name: [] for name in fns}
    for name in [*fns, *reversed(fns)]:
        got[name].append(kernel_device_ms(fns[name], flush))
    return got


def mean_of(turns: dict) -> dict:
    return {name: statistics.mean(ts) for name, ts in turns.items()}


def phase_compare(dev, stage: dict) -> dict:
    """Kernel variants and launch paths by device time, in turns."""
    def variants(k, v, c, dom):
        return {var: (lambda var=var: gagg._launch(k, v, c, dom, var))
                for var in VARIANTS}

    def paths(k, v, c, dom):
        return {"shared": lambda: gagg._launch(
                    k, v, c, dom, path=gagg.PATH_SHARED),
                "global": lambda: gagg._launch(
                    k, v, c, dom, path=gagg.PATH_GLOBAL)}

    scratch = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    out = {"flagship": {}, "shapes": {}, "small_domain": {}, "sweep": {},
           "plan": {}}
    for n in SIZES:
        k, v, c = stage_operands(stage["data"][n], dev)
        out["flagship"][n] = {
            "warm": in_turns(variants(k, v, c, _DOMAIN)),
            "cold": in_turns(variants(k, v, c, _DOMAIN), scratch.zero_)}
        log(f"variants at {n} rows x {_DOMAIN} keys, device ms: "
            f"{json.dumps(out['flagship'][n])}")
        small = k % SMALL_DOMAIN
        out["small_domain"][n] = in_turns(
            {**paths(small, v, c, SMALL_DOMAIN),
             "pr1": lambda: gagg._launch(small, v, c, SMALL_DOMAIN, "pr1")})
        log(f"paths at {n} rows x {SMALL_DOMAIN} keys, device ms: "
            f"{json.dumps(out['small_domain'][n])}")
        for dom in SWEEP_DOMAINS:
            kd = k % dom
            out["sweep"][f"{n}x{dom}"] = in_turns(paths(kd, v, c, dom))
            out["plan"][f"{n}x{dom}"] = gagg._device_plan(
                dev.index or 0, n, dom, None)
        log(f"path sweep at {n} rows, device ms: "
            f"{json.dumps({d: out['sweep'][f'{n}x{d}'] for d in SWEEP_DOMAINS})}"
            f"; _plan's (path, blocks, smem_bytes): "
            f"{json.dumps({d: out['plan'][f'{n}x{d}'] for d in SWEEP_DOMAINS})}")

    n = SIZES[0]
    k, v, c = stage_operands(stage["data"][n], dev)
    rng = np.random.default_rng(3)
    shapes = {
        "single_group": torch.full_like(k, 37),
        "zipf_1.1": torch.from_numpy(zipf_keys(rng, n, _DOMAIN).astype(
            np.int32)).to(dev),
        "sorted_runs": torch.sort(k).values}
    for name, keys in shapes.items():
        out["shapes"][name] = in_turns(variants(keys, v, c, _DOMAIN))
        log(f"variants on {name} at {n} rows, device ms: "
            f"{json.dumps(out['shapes'][name])}")
    return out


# ---------------------------------------------------------------------------
# the q01 operator pipeline
# ---------------------------------------------------------------------------

def check_q01(got: dict, oracle: dict, tol: float, label: str) -> float:
    """A collected q01 result against the numpy oracle: the store set,
    counts and null masks identical, the float sums within ``tol`` of
    each store's sum of |price| and the means within ``tol`` of its mean
    |profit|. Returns the largest error as a share of its bound's
    scale."""
    keys = got["ss_store_sk"][0]
    order = np.argsort(keys, kind="stable")
    check(np.array_equal(keys[order], oracle["ss_store_sk"]),
          f"{label}: the store set")
    for name in got:
        check(bool(got[name][1].all()), f"{label}: no null {name}")
    check(np.array_equal(got["paid_cnt"][0][order], oracle["paid_cnt"]),
          f"{label}: counts identical to the oracle")
    worst = 0.0
    for name, scale in (("total", oracle["total_abs"]),
                        ("avg_profit", oracle["profit_abs"]
                         / oracle["rows"])):
        rel = np.abs(got[name][0][order] - oracle[name]) / scale
        check(bool((rel <= tol).all()),
              f"{label}: {name} within {tol} of the store's sum of |v|")
        worst = max(worst, float(rel.max()))
    return worst


def count_sync_warnings(fn) -> int:
    """Synchronizing CUDA calls PyTorch's sync debug mode reports during
    ``fn()``."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            fn()
            torch.cuda.synchronize()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    return sum(1 for w in caught if "synchroniz" in str(w.message))


def dense_launches_per_batch(plan) -> int:
    """cuda_sum_count launches per input batch of the plan's partial
    AggOp: one per float sum or avg on the dense path, none otherwise."""
    partial = plan.child.child
    if partial.key_domain is None:
        return 0
    return sum(1 for spec in partial.specs if spec.fn in ("sum", "avg")
               and spec.state_fields[0][1].is_floating)


def run_plan(label: str, make_source, key_domain, oracle, tol, rows: int,
             batches: int, dev, timed: bool = True) -> dict:
    """One plan: a checked run with the launch and sync counters from 0,
    then, if ``timed``, PIPE_RUNS timed queries after a warm-up, one
    profiled query, one under PyTorch's sync debug mode. Returns the
    report and the checked run's rows."""
    from auron_tpu_torch import entry as tentry

    def query(metrics=None):
        return tentry.q01_pipeline(make_source(), PIPE_PARTITIONS,
                                   key_domain, metrics=metrics)

    plan = tentry.q01_pipeline_plan(make_source(), PIPE_PARTITIONS,
                                    key_domain)
    log(f"pipeline {label}, the plan:\n{plan.tree_string().rstrip()}")
    want = dense_launches_per_batch(plan) * batches
    metrics = {}
    steps = {}
    t_step = time.perf_counter()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    gagg.cuda_sum_count.launches = 0
    s0 = host_readback.syncs
    t0 = time.perf_counter()
    got = query(metrics)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    launches = gagg.cuda_sum_count.launches
    syncs = host_readback.syncs - s0
    peak = torch.cuda.max_memory_allocated()
    worst = check_q01(got, oracle, tol, label)
    check(launches == want, f"{label}: cuda_sum_count launched {launches} "
          f"times, the plan implies {want}")
    # every partition's partial AggOp records its path, and every final
    # AggOp the sort path
    agg = metrics["agg"].snapshot()
    dense = agg.get("dispatch_cuda_dense", 0)
    check(dense == (PIPE_PARTITIONS if key_domain else 0)
          and agg.get("dispatch_sort", 0) == 2 * PIPE_PARTITIONS - dense,
          f"{label}: the AggOps recorded the planned paths: {agg}")
    elapsed = {name: m.snapshot().get("elapsed_compute", 0) / 1e6
               for name, m in metrics.items()
               if "elapsed_compute" in m.snapshot()}
    steps["checked_s"] = time.perf_counter() - t_step
    out = {"rows": rows, "input_batches": batches,
           "key_domain": key_domain, "first_ms": first_ms,
           "host_syncs": syncs, "host_syncs_per_batch": syncs / batches,
           "cuda_sum_count_launches": launches,
           "elapsed_compute_ms": elapsed,
           "peak_bytes": peak, "peak_above_inputs_bytes": peak - base,
           "max_err_share": worst,
           "groups": int(got["ss_store_sk"][0].size), "steps_s": steps,
           "plan": plan.tree_string()}
    if not timed:
        log(f"pipeline {label}: {json.dumps(out)}")
        return out, got

    t_step = time.perf_counter()
    query()
    torch.cuda.synchronize()
    runs = []
    for _ in range(PIPE_RUNS):
        t0 = time.perf_counter()
        query()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    ms = statistics.median(runs)
    steps["timed_s"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    prof = device_profile(query, iters=1, top=10, host_ops=False,
                          warm=True)
    steps["profile_s"] = time.perf_counter() - t_step
    t_step = time.perf_counter()
    sync_warnings = count_sync_warnings(query)
    steps["sync_debug_s"] = time.perf_counter() - t_step
    out.update(ms=ms, runs_ms=runs, rows_per_s=rows / (ms / 1e3),
               sync_warnings=sync_warnings, profile=prof)
    log(f"pipeline {label}: {json.dumps(out)}")
    return out, got


def pipeline_kernel_shape(cols: dict, domain: int, dev, rate: float
                          ) -> dict:
    """cuda_sum_count at the shape the dense plan gives it (2^16 rows of
    q01's first batch, the key domain bucket_rows(2880)) against its
    plain version, and timed beside it and the library call."""
    n = 1 << 16
    keep = cols["ss_quantity"][0][:n] > 5
    k = torch.from_numpy(cols["ss_store_sk"][0][:n].astype(np.int32)).to(dev)
    v = torch.from_numpy(np.where(keep, cols["ss_sales_price"][0][:n],
                                  0.0).astype(np.float32)).to(dev)
    c = torch.from_numpy(keep.astype(np.float32)).to(dev)
    sums, counts = gagg.cuda_sum_count(k, v, c, domain)
    ref_s, ref_c = gagg.sum_count_reference(k, v, c, domain)
    torch.cuda.synchronize()
    err = (sums.double() - ref_s.double()).abs()
    check(torch.equal(counts, ref_c), "pipeline shape: counts identical")
    check(bool((err <= F32_SUM_TOL * abs_sums(k, v, domain)).all()),
          "pipeline shape: sums within 1e-5 of each key's sum of |v|")

    def library():
        s = torch.zeros(domain, dtype=torch.float32, device=dev)
        cn = torch.zeros(domain, dtype=torch.float32, device=dev)
        s.index_add_(0, k, v)
        cn.index_add_(0, k, c)

    bnd, by = bound_ms(n, domain, rate)
    out = {"rows": n, "key_domain": domain,
           "ms": time_ms(lambda: gagg.cuda_sum_count(k, v, c, domain)),
           "plain_ms": time_ms(lambda: gagg.sum_count_reference(
               k, v, c, domain)),
           "library_ms": time_ms(library), "bound_ms": bnd,
           "bound_by": by, "max_abs_err": float(err.max()),
           "plan": gagg._device_plan(dev.index or 0, n, domain, None)}
    log(f"kernel at the pipeline's shape: {json.dumps(out)}")
    return out


def phase_pipeline(dev, seed: int, rate: float, root: str, scale: int
                   ) -> tuple[dict, dict]:
    """p. The q01 operator pipeline at ``scale`` on the card. Writes the
    4 parquet files under ``root`` where pyarrow imports. Returns the
    report and what the later phases read: the scale, the columns, the
    files (None without pyarrow) and plan (a)'s rows and tree."""
    from auron_tpu_torch import entry as tentry
    from auron_tpu_torch.it import tpcds_data
    from auron_tpu_torch.utils.shapes import bucket_rows

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    drawn = tpcds_data.draw_tables(scale, seed)
    cols = drawn["store_sales"]
    gen_s = time.perf_counter() - t0
    rows = cols["ss_store_sk"][0].size
    stores = tpcds_data.sizes(scale)["stores"]
    domain = bucket_rows(stores)
    oracle = tpcds_data.q01_oracle(cols)
    check(oracle["ss_store_sk"].size == stores, "every store has rows")
    t0 = time.perf_counter()
    src = tentry.store_sales_batches(cols, dev, PIPE_PARTITIONS)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    batches = sum(len(p) for p in src)
    log(f"pipeline data: {rows} rows, {stores} stores, made in "
        f"{gen_s:.2f} s; {batches} device batches of "
        f"{src[0][0].capacity} rows, {torch.cuda.memory_allocated()} B on "
        f"the card, uploaded in {upload_s:.2f} s")

    # row order: plan (a) on the card gives the CPU's key order
    t0 = time.perf_counter()
    small = tpcds_data.store_sales_columns(PIPE_ORDER_SCALE, seed)
    on_cpu = tentry.q01_pipeline(tentry.store_sales_batches(
        small, "cpu", PIPE_PARTITIONS, 1 << 16), device="cpu")
    on_card = tentry.q01_pipeline(tentry.store_sales_batches(
        small, dev, PIPE_PARTITIONS, 1 << 16))
    for name in ("ss_store_sk", "paid_cnt"):
        check(np.array_equal(on_cpu[name][0], on_card[name][0]),
              f"row order at scale {PIPE_ORDER_SCALE}: {name} identical "
              "on the card and on the CPU, in order")
    order_s = time.perf_counter() - t0
    log(f"row order at scale {PIPE_ORDER_SCALE}: the card's "
        f"{on_card['ss_store_sk'][0].size} groups in the CPU's order "
        f"({order_s:.2f} s)")

    out = {"scale": scale, "rows": rows, "stores": stores,
           "partitions": PIPE_PARTITIONS, "batches": batches,
           "batch_rows": src[0][0].capacity, "generate_s": gen_s,
           "upload_s": upload_s, "row_order_s": order_s,
           "input_bytes": sum(c.data.nbytes + c.validity.nbytes
                              for p in src for b in p for c in b.columns)}
    out["sort"], sort_rows = run_plan("(a) sort plan", lambda: src, None,
                                      oracle, F64_SUM_TOL, rows, batches,
                                      dev)
    out["dense"], _ = run_plan("(b) dense plan", lambda: src, domain,
                               oracle, F32_SUM_TOL, rows, batches, dev)
    out["kernel_shape"] = pipeline_kernel_shape(cols, domain, dev, rate)
    del src
    torch.cuda.empty_cache()

    for_session = {"scale": scale, "cols": cols, "files": None,
                   "sort_rows": sort_rows,
                   "sort_plan": out["sort"]["plan"], "batches": batches,
                   "dims": {n: drawn[n] for n in JOIN_DIMENSIONS},
                   "dim_files": None}
    try:
        import pyarrow  # noqa: F401
    except ImportError:
        log("pyarrow does not import on this machine: the parquet run "
            "is skipped (the plan's scan source, not the device or the "
            "kernel)")
        out["parquet"] = None
        out["phase_s"] = time.perf_counter() - t_phase
        return out, for_session
    t0 = time.perf_counter()
    files = tpcds_data.write_store_sales(root, cols)
    # phase j's dimension tables beside the fact files, from the same draw
    for_session["dim_files"] = tpcds_data.write_dimensions(
        root, drawn, JOIN_DIMENSIONS)
    out["parquet_write_s"] = time.perf_counter() - t0
    # plan (a) over parquet is phase s's q01 (the same tree, checked
    # there): here its checked run only, so the script stays within
    # ~650 s; the Session's q01 gives its time, profile and syncs
    out["parquet"], _ = run_plan("(a) sort plan over parquet",
                                 lambda: files, None, oracle, F64_SUM_TOL,
                                 rows, batches, dev, timed=False)
    for_session["files"] = files
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"pipeline phase: {out['phase_s']:.1f} s")
    return out, for_session


# ---------------------------------------------------------------------------
# the front end: Session → DataFrame → TaskDefinition → planner → collect
# ---------------------------------------------------------------------------

def session_oracles(cols: dict) -> dict:
    """The phase s queries in numpy over the generated columns: per query
    ({column: values by ascending group key}, {float column: its bound's
    scale}), the scale being the group's sum of |v|, over its rows for a
    mean."""
    from auron_tpu_torch.it import tpcds_data
    k = cols["ss_store_sk"][0]
    qty = cols["ss_quantity"][0]
    price = cols["ss_sales_price"][0]
    q01 = tpcds_data.q01_oracle(cols)
    out = {"q01": ({c: q01[c] for c in ("ss_store_sk", "total",
                                        "paid_cnt", "avg_profit")},
                   {"total": q01["total_abs"],
                    "avg_profit": q01["profit_abs"] / q01["rows"]})}
    rows_q = np.bincount(qty)
    qk = np.flatnonzero(rows_q)
    n = rows_q[qk]
    mean = np.bincount(qty, weights=price)[qk] / n
    scale = np.bincount(qty, weights=np.abs(price))[qk] / n
    having = n > 100
    out["q10"] = ({"ss_quantity": qk[having], "n": n[having],
                   "avg_price": mean[having]},
                  {"avg_price": scale[having]})
    # integer sums far below 2^53 are exact as float64 bincount weights
    both = (price < 10.0) | (price > 250.0)
    kb = k[both]
    rows_b = np.bincount(kb)
    sk = np.flatnonzero(rows_b)
    out["q11"] = ({"ss_store_sk": sk,
                   "qty": np.bincount(kb, weights=qty[both])[sk]
                   .astype(np.int64),
                   "n": rows_b[sk]}, {})
    # distinct (store, customer) pairs by a sort: numpy 2.3's np.unique
    # took 74 s over these 28.8 M keys on an H100's host, np.sort 0.44 s
    pairs = np.sort(k * (1 << 32) + cols["ss_customer_sk"][0])
    pairs = pairs[np.r_[True, pairs[1:] != pairs[:-1]]]
    buyers = np.bincount(pairs >> 32)
    bk = np.flatnonzero(buyers)
    out["q13"] = ({"ss_store_sk": bk, "buyers": buyers[bk]}, {})
    rows_s = np.bincount(k)
    ak = np.flatnonzero(rows_s)
    out["store_quantity"] = ({"ss_store_sk": ak, "n": rows_s[ak],
                              "qty": np.bincount(k, weights=qty)[ak]
                              .astype(np.int64)}, {})
    return out


def sort_oracles(cols: dict) -> dict:
    """The sort queries of phase s in numpy over the generated columns.

    q02: per customer with rows, sorted by customer, the float64 sum of
    ``ss_net_paid`` (null rows hold 0.0), the sum of its |v| (the scale
    of the tolerance), whether it has a non-null value, and the order of
    the customers by (revenue desc, nulls last, customer asc).

    q12: the rows of ``ss_sales_price * float64(ss_quantity)`` with
    ``ss_net_profit > 0`` whose revenue reaches the 20th largest, in the
    order (revenue desc, item asc, row number): every row that ties with
    the 20th on both keys is among them. The product is IEEE-exact in
    numpy and on the card, so the keys are identical."""
    cust = cols["ss_customer_sk"][0]
    paid, paid_ok = cols["ss_net_paid"]
    size = int(cust.max()) + 1
    present = np.flatnonzero(np.bincount(cust, minlength=size))
    rev = np.bincount(cust, weights=np.where(paid_ok, paid, 0.0),
                      minlength=size)[present]
    scale = np.bincount(cust, weights=np.abs(np.where(paid_ok, paid, 0.0)),
                        minlength=size)[present]
    has = np.bincount(cust, weights=paid_ok.astype(np.float64),
                      minlength=size)[present] > 0
    q02 = {"customer": present, "revenue": rev, "scale": scale, "has": has,
           "order": np.lexsort((present, -rev, ~has))}
    keep = np.flatnonzero(cols["ss_net_profit"][0] > 0)
    revenue = cols["ss_sales_price"][0][keep] \
        * cols["ss_quantity"][0][keep].astype(np.float64)
    top = np.partition(revenue, revenue.size - 20)[revenue.size - 20]
    at = np.flatnonzero(revenue >= top)
    item = cols["ss_item_sk"][0][keep][at]
    order = np.lexsort((at, item, -revenue[at]))
    q12 = {"ss_item_sk": item[order], "revenue": revenue[at][order],
           "ss_net_profit": cols["ss_net_profit"][0][keep][at][order]}
    return {"q02": q02, "q12": q12}


def check_float_sort(table, oracle: dict, label: str, limit=None,
                     sizes=None) -> dict:
    """q02's rows, sorted by a float64 sum (revenue desc, nulls last,
    customer asc), against the oracle.

    The sums are within 1e-12 of the customer's sum of |v|, not
    bit-identical, so two customers whose sums lie closer than that may
    swap places. The tie rule: the table's own order must be exact on
    its own values; every revenue must be within tolerance of the
    oracle's for that customer; and at each position where the table's
    customer is not the oracle's, the two customers' oracle revenues
    must lie within the sum of their tolerances (a near-tie, counted as
    a swap). ``limit``: the top-k's k, None for the full sort.
    ``sizes``: the rows of each partition of a full sort, whose key
    ranges must be disjoint and ascending."""
    cust = table["ss_customer_sk"].to_numpy()
    null = table["revenue"].is_null().to_numpy(zero_copy_only=False)
    rev = table["revenue"].to_numpy(zero_copy_only=False)
    n = cust.size
    want = oracle["order"][:n]
    groups = oracle["order"].size
    check(n == (groups if limit is None else min(limit, groups)),
          f"{label}: {n} rows of the oracle's {groups} customers")
    at = np.searchsorted(oracle["customer"], cust)
    check(bool((at < oracle["customer"].size).all()
               and (oracle["customer"][np.minimum(at, oracle["customer"]
                                                  .size - 1)] == cust)
               .all()), f"{label}: every customer is the oracle's")
    check(np.array_equal(null, ~oracle["has"][at]),
          f"{label}: null revenues where the oracle has no value")
    check(not null.any() or bool(null[int(np.argmax(null)):].all()),
          f"{label}: null revenues last")
    err = np.abs(rev[~null] - oracle["revenue"][at][~null])
    tol = F64_SUM_TOL * oracle["scale"][at][~null]
    check(bool((err <= tol).all()),
          f"{label}: revenue within {F64_SUM_TOL} of the customer's sum "
          "of |v|")
    # the table's own order, exact on its own values: strictly
    # descending revenue, customer ascending on equal revenue
    a, b = rev[~null][:-1], rev[~null][1:]
    ca, cb = cust[~null][:-1], cust[~null][1:]
    check(bool(((a > b) | ((a == b) & (ca < cb))).all()),
          f"{label}: rows in (revenue desc, customer asc) order")
    tail = cust[null]
    check(bool((tail[1:] > tail[:-1]).all()),
          f"{label}: null-revenue rows in customer order")
    moved = np.flatnonzero(at != want)
    o_rev, o_scale = oracle["revenue"], oracle["scale"]
    near = np.abs(o_rev[at[moved]] - o_rev[want[moved]]) <= F64_SUM_TOL * (
        o_scale[at[moved]] + o_scale[want[moved]])
    check(bool(near.all()),
          f"{label}: the oracle's customer order, up to near-ties "
          f"({moved.size} positions differ)")
    out = {"rows": n, "near_tie_swaps": int(moved.size),
           "max_err_share": float((err / np.maximum(
               oracle["scale"][at][~null], 1e-300)).max())}
    if sizes is not None:
        check(sum(sizes) == n, f"{label}: partitions add up to the rows")
        edges = np.cumsum(sizes)[:-1]
        for e, lo, hi in zip(edges, sizes[:-1], sizes[1:]):
            if lo and hi:
                # the last row of one partition strictly before the first
                # of the next: key ranges disjoint and ascending
                i = e - 1
                check(bool(rev[i] > rev[i + 1] or (rev[i] == rev[i + 1]
                                                   and cust[i] < cust[i + 1])),
                      f"{label}: partition key ranges disjoint and "
                      "ascending")
        out["partition_rows"] = list(sizes)
    log(f"{label}: {json.dumps(out)}")
    return out


def check_exact_sort(table, want: dict, keys: list, label: str) -> dict:
    """A top-k whose sort keys are exact (q12) against the oracle's
    rows in order (``want``: every candidate row, at least as many as
    the table has). The key columns must be identical in order. Rows
    that tie on every key may come in either order, so the other
    columns are compared as multisets within each run of equal keys,
    and a run that the limit cuts may hold any of the oracle's rows of
    that run."""
    from collections import Counter
    n = table.num_rows
    got = {c: table[c].to_numpy() for c in want}
    check(0 < n <= want[keys[0]].size, f"{label}: {n} rows")
    for c in keys:
        check(np.array_equal(got[c], want[c][:n]),
              f"{label}: {c} identical to the oracle's, in order")
    m = want[keys[0]].size
    new_run = np.zeros(m, bool)
    new_run[0] = True
    for c in keys:
        new_run[1:] |= want[c][1:] != want[c][:-1]
    run = np.cumsum(new_run) - 1
    others = [c for c in want if c not in keys]
    tied = 0
    for r in np.unique(run[:n]):
        mine = np.flatnonzero(run[:n] == r)
        full = np.flatnonzero(run == r)
        tied += int(mine.size > 1)
        g = Counter(tuple(got[c][i] for c in others) for i in mine)
        w = Counter(tuple(want[c][i] for c in others) for i in full)
        ok = g == w if mine.size == full.size else not (g - w)
        check(ok, f"{label}: rows of the tie run {int(r)} are the oracle's")
    out = {"rows": n, "tie_runs": tied}
    log(f"{label}: {json.dumps(out)}")
    return out


def check_session_result(table, oracle, label: str) -> float:
    """A collected Session result against its numpy oracle: the group
    keys and every integer column identical, every float column within
    1e-12 of its group's scale, and no nulls. Returns the largest error
    as a share of its bound's scale."""
    want, scales = oracle
    key = next(iter(want))
    keys = table[key].to_numpy()
    order = np.argsort(keys, kind="stable")
    check(table.num_rows == want[key].size,
          f"{label}: {table.num_rows} groups, the oracle has "
          f"{want[key].size}")
    check(list(table.column_names) == list(want),
          f"{label}: columns {table.column_names}")
    worst = 0.0
    for name, values in want.items():
        check(table[name].null_count == 0, f"{label}: no null {name}")
        got = table[name].to_numpy()[order]
        if name not in scales:
            check(np.array_equal(got, values),
                  f"{label}: {name} identical to the oracle")
            continue
        rel = np.abs(got - values) / scales[name]
        check(bool((rel <= F64_SUM_TOL).all()),
              f"{label}: {name} within {F64_SUM_TOL} of the group's sum "
              "of |v|")
        worst = max(worst, float(rel.max()))
    return worst


def collect_partitions(session, df, metrics: dict):
    """``df.collect(metrics=...)`` one partition at a time, as the
    executor runs them: (the table, each partition's row count, the
    physical plan)."""
    import pyarrow as pa
    from auron_tpu_torch.columnar.arrow_bridge import (schema_to_arrow,
                                                       to_arrow)
    from auron_tpu_torch.runtime.executor import run_partition
    plan = session.plan_physical(df)
    schema = plan.schema()
    sizes, batches = [], []
    for p in range(df.num_partitions):
        part = [to_arrow(b, schema) for b in run_partition(
            plan, p, df.num_partitions, session.config, metrics)]
        sizes.append(sum(b.num_rows for b in part))
        batches += part
    return (pa.Table.from_batches(batches, schema=schema_to_arrow(schema)),
            sizes, plan)


def run_session_query(label: str, make_df, verify, rows: int,
                      make_profiled, by_partition=None,
                      timed: bool = True) -> dict:
    """One query through the Session: a checked run, which is also the
    warm-up, with its host syncs counted (``host_readback`` and the hash
    table's claim rounds); when ``timed``, one timed query, whose wall
    is the query's time (else the checked run's wall is); one profiled
    query of ``make_profiled``'s DataFrame (device activity only).
    ``verify(table, partition_sizes)`` checks the result and returns a
    summary of the check; the sizes are None unless ``by_partition``
    (the session) asks the checked run to collect one partition at a
    time."""
    df = make_df()
    t0 = time.perf_counter()
    tree = df.explain()
    plan_ms = (time.perf_counter() - t0) * 1e3
    log(f"session {label}, the plan:\n{tree.rstrip()}")
    metrics = {}
    torch.cuda.synchronize()
    s0, (_r, h0) = host_readback.syncs, loop_counts()
    t0 = time.perf_counter()
    if by_partition is None:
        table, sizes = df.collect(metrics=metrics), None
    else:
        table, sizes, _plan = collect_partitions(by_partition, df, metrics)
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    # the operators' readbacks and the hash table's claim-round reads
    hash_syncs = loop_counts()[1] - h0
    syncs = host_readback.syncs - s0 + hash_syncs
    worst = verify(table, sizes)
    scans = [m.snapshot() for name, m in metrics.items()
             if name in ("parquet_scan", "memory_scan")]
    batches = sum(sc["output_batches"] for sc in scans)
    scanned = sum(sc["output_rows"] for sc in scans)
    agg = metrics["agg"].snapshot() if "agg" in metrics else {}
    join = metrics["hash_join"].snapshot() if "hash_join" in metrics \
        else None
    window = metrics["window"].snapshot() if "window" in metrics else None

    ms = first_ms
    if timed:
        t0 = time.perf_counter()
        make_df().collect()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    prof = device_profile(lambda: make_profiled().collect(), iters=1, top=6,
                          host_ops=False, warm=True)
    profile_s = time.perf_counter() - t0
    out = {"rows": rows, "scanned_rows": scanned, "input_batches": batches,
           "plan_ms": plan_ms, "first_ms": first_ms, "ms": ms,
           "timed": timed, "rows_per_s": rows / (ms / 1e3),
           "host_syncs": syncs, "host_syncs_hash_table": hash_syncs,
           "host_syncs_per_batch": syncs / batches,
           "groups": table.num_rows, "check": worst,
           "partition_rows": sizes,
           "agg_paths": {k: v for k, v in agg.items()
                         if k.startswith("dispatch_")},
           "join": None if join is None else {
               k: v for k, v in join.items()
               if k.startswith("dispatch_") or k == "output_rows"},
           "window": window,
           "profile": prof, "profile_s": profile_s, "plan": tree,
           "table": table}
    log(f"session {label}: " + json.dumps(
        {k: v for k, v in out.items() if k != "table"}))
    return out


#: SF1's tables, drawn and written once (``sf1_data``)
_SF1: dict = {}


def sf1_data(seed: int, root: str) -> tuple[dict, dict]:
    """TPC-DS SF1 (scale JOIN_CHECK_SCALE) from the same generator and
    seed: (the drawn tables, {table: [parquet files]} under ``root``),
    written on first use. Phases s, j and t profile their queries over
    it, and phase j's checked-only joins run over it."""
    from auron_tpu_torch.it import tpcds_data
    if not _SF1:
        t0 = time.perf_counter()
        drawn = tpcds_data.draw_tables(JOIN_CHECK_SCALE, seed)
        sf1 = str(Path(root) / "sf1")
        files = {"store_sales": tpcds_data.write_store_sales(
            sf1, drawn["store_sales"]),
            **tpcds_data.write_dimensions(sf1, drawn, JOIN_DIMENSIONS)}
        _SF1.update(drawn=drawn, files=files,
                    write_s=time.perf_counter() - t0)
        log(f"SF1 tables written in {_SF1['write_s']:.2f} s")
    return _SF1["drawn"], _SF1["files"]


def phase_session(dev, pipe: dict, seed: int, root: str,
                  profile_sf10: bool) -> dict:
    """s. q01, q10, q11 and q13, a keyless aggregate, q02, q12 and q02's
    full sort through ``Session.read_parquet`` over ``pipe``'s 4 files,
    and a query over ``Session.from_arrow`` of the same table, on the
    card; each profiled once at SF1 (over ``pipe``'s files with
    ``profile_sf10``)."""
    import pyarrow as pa
    from auron_tpu_torch import entry as tentry
    from auron_tpu_torch.frontend.dataframe import col
    from auron_tpu_torch.frontend.dataframe import functions as F
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq

    t_phase = time.perf_counter()
    check(pipe["files"] is not None,
          "the Session reads parquet: pyarrow imports")
    cols = pipe["cols"]
    rows = cols["ss_store_sk"][0].size
    t0 = time.perf_counter()
    oracles = session_oracles(cols)
    oracle_s = time.perf_counter() - t0
    tables = {"store_sales": pipe["files"]}
    small, sf1 = sf1_data(seed, root)
    prof_tables = tables if profile_sf10 else sf1
    session = Session(device=dev)
    queries = {"q01": tq.q01_dataframe, "q10": tq.q10_dataframe,
               "q11": tq.q11_dataframe, "q13": tq.q13_dataframe}
    out = {"scale": pipe["scale"], "rows": rows, "oracle_s": oracle_s,
           "profile_scale": PIPE_SCALE if profile_sf10 else JOIN_CHECK_SCALE}
    gagg.cuda_sum_count.launches = 0
    for name, fn in queries.items():
        out[name] = run_session_query(
            name, lambda fn=fn: fn(session, tables),
            lambda t, _s, name=name: check_session_result(
                t, oracles[name], name), rows,
            make_profiled=lambda fn=fn: fn(session, prof_tables))

    # a global aggregate over the 4 files: partial → single exchange →
    # final, with no group key to hash
    t0 = time.perf_counter()
    keyless = (session.read_parquet(tables["store_sales"], partitions=4)
               .group_by().agg(F.sum(col("ss_quantity")).alias("q"),
                               F.count_star().alias("n")).collect())
    torch.cuda.synchronize()
    out["keyless"] = {"ms": (time.perf_counter() - t0) * 1e3,
                      "rows": keyless.to_pylist()}
    check(out["keyless"]["rows"] == [{"q": int(cols["ss_quantity"][0].sum()),
                                      "n": rows}],
          f"keyless aggregate: {out['keyless']['rows']}")
    log(f"session keyless: {json.dumps(out['keyless'])}")

    # the sorts: q02 and q12 (top-k: a map-side sort → single exchange →
    # final top-k), and q02 without its limit (a range exchange → a
    # sort per partition)
    t0 = time.perf_counter()
    sorts = sort_oracles(cols)
    out["sort_oracle_s"] = time.perf_counter() - t0
    out["q02"] = run_session_query(
        "q02", lambda: tq.q02_dataframe(session, tables),
        lambda t, _s: check_float_sort(t, sorts["q02"], "q02", 100),
        rows, make_profiled=lambda: tq.q02_dataframe(session, prof_tables))
    out["q12"] = run_session_query(
        "q12", lambda: tq.q12_dataframe(session, tables),
        lambda t, _s: check_exact_sort(t, sorts["q12"],
                                       ["revenue", "ss_item_sk"], "q12"),
        rows, make_profiled=lambda: tq.q12_dataframe(session, prof_tables))
    out["q02_full_sort"] = run_session_query(
        "q02_full_sort", lambda: tq.q02_dataframe(session, tables,
                                                  limit=None),
        lambda t, sizes: check_float_sort(t, sorts["q02"], "q02_full_sort",
                                          sizes=sizes),
        rows, by_partition=session,
        make_profiled=lambda: tq.q02_dataframe(session, prof_tables,
                                               limit=None))
    check(len(out["q02_full_sort"]["partition_rows"]) == 4,
          "q02_full_sort: 4 range partitions")

    # q01 through the Session is phase p's plan (a): the same operators
    # above the scan, the same rows in the same order
    got, want = out["q01"]["table"], pipe["sort_rows"]
    for name in ("ss_store_sk", "paid_cnt"):
        check(np.array_equal(got[name].to_numpy(), want[name][0]),
              f"q01: {name} identical to phase p's plan (a), in order")
    _, scales = oracles["q01"]
    at = np.searchsorted(oracles["q01"][0]["ss_store_sk"],
                         want["ss_store_sk"][0])
    for name in ("total", "avg_profit"):
        err = np.abs(got[name].to_numpy() - want[name][0])
        check(bool((err <= F64_SUM_TOL * scales[name][at]).all()),
              f"q01: {name} within {F64_SUM_TOL} of phase p's plan (a)")
        out["q01"][f"{name}_bit_identical_to_plan_a"] = bool(
            (err == 0).all())
    above_scan = out["q01"]["plan"].splitlines()[:-1]
    check(above_scan == pipe["sort_plan"].splitlines()[:-1],
          "q01: the Session's plan is phase p's plan (a) above the scan")
    check(out["q01"]["plan"] == tentry.q01_pipeline_plan(
        pipe["files"], PIPE_PARTITIONS).tree_string(),
        "q01: explain() equals the entry's parquet plan")

    # the in-memory table: one partition, a complete AggOp straight over
    # the memory scan, whose key domain the planner derives
    def arrow_of(columns):
        return pa.table({name: pa.array(v, mask=None if ok.all() else ~ok)
                         for name, (v, ok) in columns.items()})

    t0 = time.perf_counter()
    arrow = arrow_of(cols)
    arrow_prof = arrow if profile_sf10 else arrow_of(small["store_sales"])
    out["arrow_table_s"] = time.perf_counter() - t0
    plan = session.plan_physical(tq.store_quantity_dataframe(session, arrow))
    domain = int(cols["ss_store_sk"][0].max()) + 1
    check(plan.key_domain == domain,
          f"from_arrow: the planner derived key_domain {plan.key_domain}, "
          f"max(ss_store_sk) + 1 is {domain}")
    out["store_quantity"] = run_session_query(
        "store_quantity (from_arrow)",
        lambda: tq.store_quantity_dataframe(session, arrow),
        lambda t, _s: check_session_result(t, oracles["store_quantity"],
                                           "store_quantity"), rows,
        make_profiled=lambda: tq.store_quantity_dataframe(session,
                                                          arrow_prof))
    paths = out["store_quantity"]["agg_paths"]
    check(set(paths) == {"dispatch_cuda_dense"}
          and paths["dispatch_cuda_dense"] == 1,
          f"from_arrow: the AggOp took the dense path: {paths}")
    out["key_domain"] = plan.key_domain
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the Session path (the planner "
          "derives no dense domain for a float sum)")
    log(f"session: cuda_sum_count.launches = "
        f"{out['cuda_sum_count_launches']} across the phase")
    for name in ("q01", "q10", "q11", "q13", "q02", "q12",
                 "q02_full_sort", "store_quantity"):
        del out[name]["table"]
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"session phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# hash joins and the broadcast exchange, through the Session
# ---------------------------------------------------------------------------

def join_oracles(cols: dict, dims: dict) -> dict:
    """q05, its broadcast form and q09's semi and anti joins in numpy
    over the generated columns, in ``check_session_result``'s form.
    q05: per month of the year 2000, the float64 sum of ss_sales_price
    over the sales joined to its days, the sum of |v| (the tolerance's
    scale) and the joined rows. q09: the items with (semi) and without
    (anti) a sale under $1."""
    dd = dims["date_dim"]
    days = cols["ss_sold_date_sk"][0]
    price = cols["ss_sales_price"][0]
    # d_date_sk is the row number of date_dim
    check(np.array_equal(dd["d_date_sk"], np.arange(dd["d_date_sk"].size)),
          "date_dim: d_date_sk is the row number")
    keep = dd["d_year"][days] == 2000
    moy = dd["d_moy"][days[keep]]
    months = np.flatnonzero(np.bincount(moy))
    q05 = ({"d_moy": months,
            "total": np.bincount(moy, weights=price[keep])[months]},
           {"total": np.bincount(moy, weights=np.abs(price[keep]))[months]})
    items = dims["item"]["i_item_sk"]
    sold = np.isin(items, cols["ss_item_sk"][0][price < 1.0])
    semi = int(sold.sum())
    return {"q05": q05, "q05_joined_rows": int(keep.sum()),
            "q09_semi": ({"n": np.array([semi])}, {}),
            "q09_anti": ({"n": np.array([items.size - semi])}, {}),
            "q09_build_rows": int((price < 1.0).sum())}


def join_rows(table) -> "Counter":
    """The multiset of a table's rows, nulls as None."""
    from collections import Counter
    names = table.column_names
    return Counter(tuple(r[c] for c in names) for r in table.to_pylist())


def outer_join_oracle(tables: dict, how: str) -> "Counter":
    """``it.queries.outer_join_dataframe``'s rows in numpy, as a
    multiset: store_sales rows of quantity 1 under $10 (item, customer,
    net paid) joined on the item with the items under $150 (price). An
    unmatched item row has a null ss_item_sk, as in the reference."""
    from collections import Counter
    ss, item = tables["store_sales"], tables["item"]
    keep = (ss["ss_quantity"][0] == 1) & (ss["ss_sales_price"][0] < 10.0)
    p_item = ss["ss_item_sk"][0][keep]
    paid, paid_ok = (a[keep] for a in ss["ss_net_paid"])
    probe = [(int(i), int(c), float(v) if ok else None) for i, c, v, ok in
             zip(p_item, ss["ss_customer_sk"][0][keep], paid, paid_ok)]
    b_keep = item["i_current_price"] < 150.0
    price_of = dict(zip(item["i_item_sk"][b_keep].tolist(),
                        item["i_current_price"][b_keep].tolist()))
    hit = [r[0] in price_of for r in probe]
    if how == "existence":
        return Counter(r + (h,) for r, h in zip(probe, hit))
    if how in ("semi", "anti"):
        return Counter(r for r, h in zip(probe, hit) if h == (how == "semi"))
    rows = Counter(r + (price_of[r[0]],) for r, h in zip(probe, hit) if h)
    if how in ("left", "full"):
        rows += Counter(r + (None,) for r, h in zip(probe, hit) if not h)
    if how in ("right", "full"):
        sold = set(p_item.tolist())
        rows += Counter((None, None, None, p) for i, p in price_of.items()
                        if i not in sold)
    return rows


def phase_joins(dev, pipe: dict, seed: int, root: str,
                profile_sf10: bool) -> dict:
    """j. Hash joins and the broadcast exchange through the Session on
    the card: q05 co-partitioned and over a broadcast build side, and
    q09's anti and semi joins counted, over ``pipe``'s files and the
    dimension files written beside them, each timed and profiled as
    phase s times and profiles its queries; then every join type over
    co-partitioned sides at SF1 and the right and full joins over a
    broadcast build side, checked only."""
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq

    t_phase = time.perf_counter()
    check(pipe["dim_files"] is not None,
          "the join phase reads parquet: pyarrow imports")
    cols = pipe["cols"]
    rows = cols["ss_store_sk"][0].size
    t0 = time.perf_counter()
    oracles = join_oracles(cols, pipe["dims"])
    out = {"scale": pipe["scale"], "rows": rows,
           "oracle_s": time.perf_counter() - t0,
           "item_rows": int(pipe["dims"]["item"]["i_item_sk"].size),
           "q09_build_rows": oracles["q09_build_rows"]}
    tables = {"store_sales": pipe["files"], **pipe["dim_files"]}
    small, sf1_tables = sf1_data(seed, root)
    out["profile_scale"] = PIPE_SCALE if profile_sf10 else JOIN_CHECK_SCALE
    session = Session(device=dev)
    gagg.cuda_sum_count.launches = 0
    timed = {
        "q05": lambda: tq.q05_dataframe(session, tables),
        "q05_broadcast": lambda: tq.q05_dataframe(session, tables,
                                                  co_partitioned=False),
        "q09_anti": lambda: tq.cheap_sales_items_dataframe(session, tables,
                                                           "anti"),
        "q09_semi": lambda: tq.cheap_sales_items_dataframe(session, tables,
                                                           "semi"),
    }
    on_sf1 = {
        "q05": lambda: tq.q05_dataframe(session, sf1_tables),
        "q05_broadcast": lambda: tq.q05_dataframe(
            session, sf1_tables, co_partitioned=False),
        "q09_anti": lambda: tq.cheap_sales_items_dataframe(
            session, sf1_tables, "anti"),
        "q09_semi": lambda: tq.cheap_sales_items_dataframe(
            session, sf1_tables, "semi"),
    }
    for name, make_df in timed.items():
        oracle = oracles["q05" if name.startswith("q05") else name]
        out[name] = run_session_query(
            name, make_df, lambda t, _s, o=oracle, n=name:
            check_session_result(t, o, n), rows,
            make_df if profile_sf10 else on_sf1[name])
        join = out[name]["join"]
        builds = 4 if name.startswith("q05") else 1
        check(join is not None and sum(
            v for k, v in join.items() if k.startswith("dispatch_"))
            == builds, f"{name}: {builds} build sides, each counted: {join}")
        if name.startswith("q05"):
            check(join["output_rows"] == oracles["q05_joined_rows"],
                  f"{name}: {join['output_rows']} joined rows, the oracle "
                  f"has {oracles['q05_joined_rows']}")
            check(join.get("dispatch_ht_index") == builds,
                  f"{name}: every build side takes the hash-run index")
        check(("BroadcastExchangeOp" in out[name]["plan"])
              == (name != "q05"), f"{name}: the build side is broadcast "
              "exactly where the sides are not co-partitioned")
        del out[name]["table"]

    # every join type over co-partitioned sides at SF1, checked only
    out["checked"] = {}
    for how in ("inner", "left", "right", "full", "semi", "anti",
                "existence"):
        t0 = time.perf_counter()
        table = tq.outer_join_dataframe(session, sf1_tables, how).collect()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        want = outer_join_oracle(small, how)
        check(join_rows(table) == want,
              f"{how} join at SF1: the oracle's {sum(want.values())} rows "
              f"as a multiset, got {table.num_rows}")
        out["checked"][how] = {"rows": table.num_rows, "first_ms": ms}
    inner = out["checked"]["inner"]["rows"]
    check(all(out["checked"][h]["rows"] > inner
              for h in ("left", "right", "full", "existence")),
          "the outer and existence joins keep unmatched rows")
    for how in ("right", "full"):
        got = [tuple(r.values()) for r in tq.broadcast_outer_dataframe(
            session, how).collect().to_pylist()]
        check(got == tq.BROADCAST_OUTER_ROWS[how],
              f"{how} join over a broadcast build side: the reference's "
              f"rows in its order, got {got}")
        out["checked"][f"broadcast_{how}"] = {"rows": len(got)}
    log(f"joins checked: {json.dumps(out['checked'])}")

    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the join path")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"join phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# string columns: q03, q04 and q06-q09 through the Session
# ---------------------------------------------------------------------------

def _coded(values) -> tuple:
    """(sorted distinct values, each value's index among them)."""
    uniq = np.unique(np.asarray(values).astype(str))
    return uniq, np.searchsorted(uniq, np.asarray(values).astype(str))


def _by_code(codes, size: int, weights=None) -> np.ndarray:
    return np.bincount(codes, weights=weights, minlength=size)


def string_oracles(cols: dict, dims: dict) -> dict:
    """q03, q04, q06, q08 and q09 in numpy over the generated columns, in
    ``check_session_result``'s form (keys ascending), and q07's groups
    for ``check_q07``. Strings are grouped through integer codes (their
    rank among the distinct values); dimension keys are row numbers."""
    item, store, cust = dims["item"], dims["store"], dims["customer"]
    for name, table, sk in (("item", item, "i_item_sk"),
                            ("store", store, "s_store_sk"),
                            ("customer", cust, "c_customer_sk")):
        check(np.array_equal(table[sk], np.arange(table[sk].size)),
              f"{name}: its key is the row number")
    cats, cat = _coded(item["i_category"])
    states, s_state = _coded(store["s_state"])
    c_states, c_state = _coded(cust["c_state"])
    email = np.asarray(cust["c_email"], dtype=object)
    item_sk, store_sk = cols["ss_item_sk"][0], cols["ss_store_sk"][0]
    cust_sk, price = cols["ss_customer_sk"][0], cols["ss_sales_price"][0]
    profit = cols["ss_net_profit"][0]
    out = {}

    def present(keys, rows, **columns):
        hit = rows > 0
        return {k: v[hit] for k, v in columns.items()}, keys[hit]

    # q03: sales of items in Books, Music, Shoes, by category
    code = cat[item_sk]
    keep = np.isin(cats, ["Books", "Music", "Shoes"])[code]
    rows = _by_code(code[keep], cats.size)
    got, keys = present(cats, rows, n=rows,
                        total=_by_code(code[keep], cats.size, price[keep]),
                        scale=_by_code(code[keep], cats.size,
                                       np.abs(price[keep])))
    out["q03"] = ({"i_category": keys.astype(object),
                   "total": got["total"], "n": got["n"].astype(np.int64)},
                  {"total": got["scale"]})

    # q04: sales by the state of their store
    code = s_state[store_sk]
    rows = _by_code(code, states.size)
    got, keys = present(states, rows, n=rows,
                        profit=_by_code(code, states.size, profit),
                        scale=_by_code(code, states.size, np.abs(profit)))
    out["q04"] = ({"s_state": keys.astype(object),
                   "n": got["n"].astype(np.int64), "profit": got["profit"]},
                  {"profit": got["scale"]})

    # q06: per customer state, the least and greatest email of the
    # customers with sales, and the sales of customers with an email
    sold = np.bincount(cust_sk, minlength=c_state.size)
    has = np.array([e is not None for e in email])
    first, last, n, keys = [], [], [], []
    for i, state in enumerate(c_states):
        mine = c_state == i
        bought = email[mine & has & (sold > 0)]
        if not (mine & (sold > 0)).any():
            continue
        keys.append(state)
        first.append(min(bought))
        last.append(max(bought))
        n.append(int(sold[mine & has].sum()))
    out["q06"] = ({"c_state": np.array(keys, dtype=object),
                   "first_email": np.array(first, dtype=object),
                   "last_email": np.array(last, dtype=object),
                   "n": np.array(n, np.int64)}, {})

    # q07: paid per (category, state) over profitable sales
    paid, paid_ok = cols["ss_net_paid"]
    win = profit > 0
    pair = cat[item_sk[win]] * states.size + s_state[store_sk[win]]
    size = cats.size * states.size
    v = np.where(paid_ok[win], paid[win], 0.0)
    rows = _by_code(pair, size)
    valid = _by_code(pair, size, paid_ok[win].astype(np.float64))
    hit = rows > 0
    check(bool((valid[hit] > 0).all()), "q07: every group has a paid value")
    groups = np.flatnonzero(hit)
    out["q07"] = {"category": cats[groups // states.size].astype(object),
                  "state": states[groups % states.size].astype(object),
                  "paid": _by_code(pair, size, v)[hit],
                  "scale": _by_code(pair, size, np.abs(v))[hit]}

    # q08: states of the customers who bought an Electronics item
    electronics = np.flatnonzero(cats == "Electronics")[0]
    buyers = np.zeros(c_state.size, bool)
    buyers[cust_sk[cat[item_sk] == electronics]] = True
    rows = _by_code(c_state[buyers], c_states.size)
    got, keys = present(c_states, rows, n=rows)
    out["q08"] = ({"c_state": keys.astype(object),
                   "n": got["n"].astype(np.int64)}, {})

    # q09: categories of the items never sold under $1
    sold_cheap = np.zeros(cat.size, bool)
    sold_cheap[item_sk[price < 1.0]] = True
    rows = _by_code(cat[~sold_cheap], cats.size)
    got, keys = present(cats, rows, n=rows)
    out["q09"] = ({"i_category": keys.astype(object),
                   "n": got["n"].astype(np.int64)}, {})
    return out


def check_q07(table, oracle: dict, label: str = "q07") -> dict:
    """q07's top 50 (paid desc, category asc, state asc) against the
    oracle, with ``check_float_sort``'s rule for near-ties: the table's
    own order exact on its own values, every sum within 1e-12 of its
    group's sum of |v|, and a position where the table's group is not
    the oracle's allowed only between groups whose sums lie within the
    sum of their tolerances."""
    got_cat = np.asarray(table["i_category"].to_pylist(), dtype=object)
    got_state = np.asarray(table["s_state"].to_pylist(), dtype=object)
    paid = table["paid"].to_numpy()
    n = table.num_rows
    o_cat, o_state = oracle["category"], oracle["state"]
    o_paid, o_scale = oracle["paid"], oracle["scale"]
    order = sorted(range(o_paid.size),
                   key=lambda i: (-o_paid[i], o_cat[i], o_state[i]))
    check(n == min(50, o_paid.size), f"{label}: {n} rows")
    check(table["paid"].null_count == 0, f"{label}: no null sums")
    index = {(c, st): i for i, (c, st) in enumerate(zip(o_cat, o_state))}
    at = np.array([index.get((c, st), -1)
                   for c, st in zip(got_cat, got_state)])
    check(bool((at >= 0).all()), f"{label}: every group is the oracle's")
    err = np.abs(paid - o_paid[at])
    check(bool((err <= F64_SUM_TOL * o_scale[at]).all()),
          f"{label}: sums within {F64_SUM_TOL} of the group's sum of |v|")
    for i in range(n - 1):
        a = (-paid[i], got_cat[i], got_state[i])
        b = (-paid[i + 1], got_cat[i + 1], got_state[i + 1])
        check(a < b, f"{label}: rows in (paid desc, category, state) order")
    want = np.array(order[:n])
    moved = np.flatnonzero(at != want)
    near = np.abs(o_paid[at[moved]] - o_paid[want[moved]]) <= F64_SUM_TOL \
        * (o_scale[at[moved]] + o_scale[want[moved]])
    check(bool(near.all()), f"{label}: the oracle's order, up to near-ties "
          f"({moved.size} positions differ)")
    return {"rows": n, "near_tie_swaps": int(moved.size),
            "max_err_share": float((err / o_scale[at]).max())}


def agg_decisions(session, df) -> list:
    """Each AggOp of the query's physical plan: its mode, and the general
    path's decision (backend and reason), taken without counting."""
    from auron_tpu_torch.ops.agg import AggOp
    from auron_tpu_torch.ops.base import ExecContext
    out, todo = [], [session.plan_physical(df)]
    while todo:
        op = todo.pop()
        todo.extend(op.children)
        if isinstance(op, AggOp):
            d = op._hash_dispatch(ExecContext(config=session.config),
                                  record=False)
            out.append({"mode": op.mode, "backend": d.backend,
                        "reason": d.reason})
    return out


#: the general path each query's AggOps take, and why
STRING_PATHS = {"q03": ("sort", "float_sum_inexact"),
                "q04": ("sort", "float_sum_inexact"),
                "q06": ("sort", "acc_kind:smin"),
                "q07": ("sort", "float_sum_inexact"),
                "q08": ("hashtable", "eligible"),
                "q09": ("hashtable", "eligible")}


def phase_strings(dev, pipe: dict, seed: int, root: str,
                  profile_sf10: bool) -> dict:
    """t. q03, q04 and q06-q09 through the Session over ``pipe``'s
    store_sales files and the customer, item and store tables written
    beside them: each checked against numpy, timed by its checked run,
    its host syncs counted, and profiled once at SF1 (over ``pipe``'s
    files with ``profile_sf10``)."""
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq

    t_phase = time.perf_counter()
    check(pipe["dim_files"] is not None,
          "the string phase reads parquet: pyarrow imports")
    cols = pipe["cols"]
    rows = cols["ss_store_sk"][0].size
    t0 = time.perf_counter()
    oracles = string_oracles(cols, pipe["dims"])
    out = {"scale": pipe["scale"], "rows": rows,
           "oracle_s": time.perf_counter() - t0,
           "customer_rows": int(pipe["dims"]["customer"]["c_customer_sk"]
                                .size),
           "item_rows": int(pipe["dims"]["item"]["i_item_sk"].size),
           "store_rows": int(pipe["dims"]["store"]["s_store_sk"].size)}
    tables = {"store_sales": pipe["files"], **pipe["dim_files"]}
    prof_tables = tables if profile_sf10 else sf1_data(seed, root)[1]
    session = Session(device=dev)
    gagg.cuda_sum_count.launches = 0
    for name in STRING_QUERIES:
        make = getattr(tq, f"{name}_dataframe")
        if name == "q07":
            def verify(t, _s, o=oracles[name]):
                return check_q07(t, o)
        else:
            def verify(t, _s, o=oracles[name], n=name):
                return check_session_result(t, o, n)
        out[name] = run_session_query(
            name, lambda m=make: m(session, tables), verify, rows,
            lambda m=make: m(session, prof_tables), timed=False)
        out[name]["profile_scale"] = PIPE_SCALE if profile_sf10 \
            else JOIN_CHECK_SCALE
        decisions = agg_decisions(session, make(session, tables))
        out[name]["agg_decisions"] = decisions
        want = STRING_PATHS[name]
        check(bool(decisions) and all(
            (d["backend"], d["reason"]) == want for d in decisions),
            f"{name}: every AggOp takes {want}: {decisions}")
        del out[name]["table"]
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the string path")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"string phase: {out['phase_s']:.1f} s")
    return out


def q14_oracle(item: dict) -> tuple:
    """q14 in numpy over the generated item columns, in
    ``check_session_result``'s form: per title-cased category, the row
    count and the least ``category/brand`` path."""
    cats = np.asarray(item["i_category"]).astype(str)
    paths = np.char.add(np.char.add(cats, "/"),
                        np.asarray(item["i_brand"], dtype=object).astype(str))
    titles = np.array([c.title() for c in cats.tolist()])
    keys = np.unique(titles)
    n = np.array([(titles == k).sum() for k in keys], np.int64)
    first = np.array([min(paths[titles == k].tolist()) for k in keys],
                     dtype=object)
    return ({"cat_title": keys.astype(object), "n": n, "first_path": first},
            {})


def phase_expressions(dev, pipe: dict, seed: int, root: str,
                      profile_sf10: bool) -> dict:
    """e. q14 through the Session over phase p's item file, checked
    against numpy, timed by its checked run, its syncs counted, its
    AggOp path held and profiled once at SF1 (at SF10 with
    ``profile_sf10``); then the expression sweep over customer and item
    on the card against the same query through ``Session(device=
    "cpu")``, cell by cell."""
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq
    from auron_tpu_torch.it.comparator import compare_cells

    t_phase = time.perf_counter()
    check(pipe["dim_files"] is not None,
          "the expression phase reads parquet: pyarrow imports")
    tables = pipe["dim_files"]
    prof_tables = tables if profile_sf10 else sf1_data(seed, root)[1]
    item = pipe["dims"]["item"]
    items = int(item["i_item_sk"].size)
    customers = int(pipe["dims"]["customer"]["c_customer_sk"].size)
    session = Session(device=dev)
    gagg.cuda_sum_count.launches = 0
    oracle = q14_oracle(item)

    def verify(t, _s):
        worst = check_session_result(t, oracle, "q14")
        check(t["cat_title"].to_pylist() == sorted(oracle[0]["cat_title"]),
              "q14: rows in cat_title order")
        return worst

    out = {"scale": pipe["scale"], "q14": run_session_query(
        "q14", lambda: tq.q14_dataframe(session, tables), verify, items,
        lambda: tq.q14_dataframe(session, prof_tables), timed=False)}
    del out["q14"]["table"]
    decisions = agg_decisions(session, tq.q14_dataframe(session, tables))
    out["q14"]["agg_decisions"] = decisions
    check(bool(decisions) and all(
        (d["backend"], d["reason"]) == ("sort", "acc_kind:smin")
        for d in decisions), f"q14: its AggOp takes the sort path for its "
        f"string min: {decisions}")

    cpu = Session(device="cpu")
    for table, rows in (("customer", customers), ("item", items)):
        t0 = time.perf_counter()
        want = tq.expression_sweep_dataframe(cpu, tables, table).collect()
        cpu_s = time.perf_counter() - t0
        seen = {}

        def verify(t, _s, want=want, table=table, seen=seen):
            bad, ulps = compare_cells(want, t)
            check(not bad, f"sweep over {table}: the card's cells are the "
                  f"CPU's: {bad[:5]}")
            check(t.num_rows > 0, f"sweep over {table}: rows")
            seen.update(ulps)
            return max(ulps.values(), default=0)

        label = f"sweep_{table}"
        res = run_session_query(
            label, lambda tb=table: tq.expression_sweep_dataframe(
                session, tables, tb), verify, rows,
            lambda tb=table: tq.expression_sweep_dataframe(
                session, prof_tables, tb), timed=False)
        res.update(columns=res["table"].num_columns, cpu_s=cpu_s,
                   ulps=seen, profile_scale=PIPE_SCALE if profile_sf10
                   else JOIN_CHECK_SCALE)
        del res["table"]
        out[label] = res
    out["q14"]["profile_scale"] = PIPE_SCALE if profile_sf10 \
        else JOIN_CHECK_SCALE
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the expression path")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"expression phase: {out['phase_s']:.1f} s")
    return out


#: 128-bit values phase d holds ``decimal128`` on, card against CPU
DECIMAL_VALUES = 1 << 20

#: the scales the limb rescales are held at
DECIMAL_KS = (1, 9, 10, 18, 19, 38)

#: the general path each decimal query's AggOps take, and why
DECIMAL_PATHS = {"money": ("sort", "acc_kind:dsum"),
                 "price_key": ("hashtable", "eligible")}


def _decimal_limb_ops() -> dict:
    """name → fn(hi, lo, other_hi, other_lo) of every ``decimal128``
    function phase d holds, each returning a tuple of tensors."""
    from auron_tpu_torch.columnar import decimal128 as D
    ops = {"add128": D.add128, "sub128": D.sub128, "mul128": D.mul128,
           "cmp128": D.cmp128,
           "to_float64": lambda h, l, _bh, _bl: (D.to_float64(h, l),)}
    for k in DECIMAL_KS:
        ops[f"mul_pow10_{k}"] = lambda h, l, _bh, _bl, k=k: \
            D.mul_pow10(h, l, k)
        ops[f"div_pow10_half_up_{k}"] = lambda h, l, _bh, _bl, k=k: \
            D.div_pow10_half_up(h, l, k)
        ops[f"div_pow10_trunc_{k}"] = lambda h, l, _bh, _bl, k=k: \
            D.div_pow10_trunc(h, l, k)
        ops[f"fits_precision_{k}"] = lambda h, l, _bh, _bl, k=k: \
            (D.fits_precision(h, l, k),)
    return ops


def decimal128_checks(dev) -> dict:
    """``columnar/decimal128.py`` on the card against the same functions
    on the CPU, bit for bit, over ``DECIMAL_VALUES`` seeded 128-bit
    values (half of them below 10^38 in magnitude, the limb edges first)
    paired with a shuffle of themselves; then the launches and device
    time of one ``mul128`` and one ``div_pow10_half_up`` at k = 38 over
    them."""
    from auron_tpu_torch.columnar import decimal128 as D
    n = DECIMAL_VALUES
    rng = np.random.default_rng(SEED)
    i64 = np.iinfo(np.int64)
    hi = rng.integers(i64.min, i64.max, n, dtype=np.int64, endpoint=True)
    lo = rng.integers(i64.min, i64.max, n, dtype=np.int64, endpoint=True)
    # below 10^38: |hi| < 10^38 / 2^64 ~ 5.42e18
    hi[n // 2:] = rng.integers(-(5 * 10 ** 18), 5 * 10 ** 18, n - n // 2)
    edge = [0, 1, -1, 2 ** 63, -(2 ** 63), 2 ** 64 - 1, 2 ** 64,
            -(2 ** 64), 10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 18,
            5 * 10 ** 37, -5 * 10 ** 37 - 1]
    eh, el, _ = D.limbs_from_ints(edge, len(edge))
    hi[:len(edge)], lo[:len(edge)] = eh, el
    perm = rng.permutation(n)
    host = [torch.from_numpy(a) for a in (hi, lo, hi[perm], lo[perm])]
    card = [t.to(dev) for t in host]
    bad, t0 = [], time.perf_counter()
    ops = _decimal_limb_ops()
    for name, fn in ops.items():
        want, got = fn(*host), fn(*card)
        for w, g in zip(want, got):
            g = g.cpu()
            if w.dtype == torch.float64:
                w, g = w.view(torch.int64), g.view(torch.int64)
            if not torch.equal(w, g):
                bad.append(name)
    check(not bad, f"decimal128: the card's limbs are the CPU's: {bad}")
    check_s = time.perf_counter() - t0
    prof = {}
    for name in ("mul128", "div_pow10_half_up_38"):
        res = device_profile(lambda fn=ops[name]: fn(*card), iters=5, top=3,
                             host_ops=False)
        prof[name] = {k: res[k] for k in ("wall_ms", "device_ms",
                                          "busy_share", "launches_per_call")}
    out = {"values": n, "functions": len(ops), "check_s": check_s,
           "profile": prof}
    log("decimal128 on the card: " + json.dumps(out))
    return out


def decimal_oracles(cols: dict) -> dict:
    """The decimal queries' oracles (``it/queries.py``, Python's
    ``decimal`` over exact integer sums) on the generated columns, as
    lists of rows."""
    import pandas as pd
    import pyarrow as pa
    from auron_tpu_torch.it import queries as tq
    frame = pd.DataFrame({c: np.where(v, d, np.nan) if not v.all() else d
                          for c, (d, v) in cols.items()})
    small = {"store_sales": frame[frame.ss_item_sk < 50]}
    full = {"store_sales": frame}

    def rows(df):
        return pa.Table.from_pandas(df.reset_index(drop=True),
                                    preserve_index=False).to_pylist()

    return {"q15": rows(tq._q15_oracle(small)),
            "money": rows(tq._decimal_money_oracle(full)),
            "price_key": rows(tq._decimal_price_key_oracle(full))}


def phase_decimals(dev, pipe: dict, seed: int, root: str,
                   profile_sf10: bool) -> dict:
    """d. ``decimal128`` card against CPU; then q15, the decimal money
    aggregates and the wide decimal group key through the Session over
    phase p's files, each checked exactly against its Python
    ``decimal`` oracle (rows, order and result types), timed by its
    checked run, its syncs counted, its AggOps' paths held, and profiled
    once at SF1 (at SF10 with ``profile_sf10``)."""
    import pyarrow as pa
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq

    t_phase = time.perf_counter()
    check(pipe["files"] is not None,
          "the decimal phase reads parquet: pyarrow imports")
    out = {"scale": pipe["scale"], "decimal128": decimal128_checks(dev)}
    cols = pipe["cols"]
    rows = cols["ss_store_sk"][0].size
    t0 = time.perf_counter()
    oracles = decimal_oracles(cols)
    out["oracle_s"] = time.perf_counter() - t0
    tables = {"store_sales": pipe["files"]}
    prof_tables = tables if profile_sf10 else \
        {"store_sales": sf1_data(seed, root)[1]["store_sales"]}
    session = Session(device=dev)
    gagg.cuda_sum_count.launches = 0
    types = {"q15": {"rev_dec": (38, 2)},
             "money": tq.DECIMAL_MONEY_TYPES,
             "price_key": {"price_key": (20, 2)}}
    makers = {"q15": tq.q15_dataframe,
              "money": tq.decimal_money_dataframe,
              "price_key": tq.decimal_price_key_dataframe}
    for name, make in makers.items():
        def verify(t, _s, name=name):
            for col, (p, sc) in types[name].items():
                check(t.schema.field(col).type == pa.decimal128(p, sc),
                      f"decimals.{name}: {col} is decimal({p},{sc})")
            got = t.to_pylist()
            check(got == oracles[name],
                  f"decimals.{name}: the rows, in order, are the decimal "
                  f"oracle's ({len(got)} against {len(oracles[name])})")
            return len(got)

        out[name] = run_session_query(
            f"decimals.{name}", lambda m=make: m(session, tables), verify,
            rows, lambda m=make: m(session, prof_tables), timed=False)
        out[name]["profile_scale"] = PIPE_SCALE if profile_sf10 \
            else JOIN_CHECK_SCALE
        del out[name]["table"]
        if name in DECIMAL_PATHS:
            decisions = agg_decisions(session, make(session, tables))
            out[name]["agg_decisions"] = decisions
            want = DECIMAL_PATHS[name]
            check(bool(decisions) and all(
                (d["backend"], d["reason"]) == want for d in decisions),
                f"decimals.{name}: every AggOp takes {want}: {decisions}")
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the decimal path")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"decimal phase: {out['phase_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# window functions and grouping sets (phase w)
# ---------------------------------------------------------------------------

#: the oracle's candidates per window partition for a ranked check: the
#: groups of largest sum, and every group tied with the last of them
RANK_CANDIDATES = 12

def _top_candidates(part, tot, sc, keys_of) -> dict:
    """{partition: (keys, sums, scales)} of each partition's groups of
    largest sum, sorted by sum descending: the first RANK_CANDIDATES and
    every group within 1e-6 of the last of them."""
    order = np.lexsort((-tot, part))
    ps = part[order]
    values, starts = np.unique(ps, return_index=True)
    ends = np.append(starts[1:], ps.size)
    out = {}
    for v, a, b in zip(values.tolist(), starts, ends):
        idx = order[a:b]
        m = min(RANK_CANDIDATES, idx.size)
        m = int(np.count_nonzero(tot[idx] >= tot[idx[m - 1]] - 1e-6))
        idx = idx[:m]
        out[v] = (keys_of(idx), tot[idx], sc[idx])
    return out


def q16_window_oracle(cols: dict) -> dict:
    """q16 in numpy over the generated columns: per store, its candidate
    (item,) groups with their float64 sums of ``ss_sales_price`` and the
    sums of |v| (``_top_candidates``)."""
    store = cols["ss_store_sk"][0]
    item = cols["ss_item_sk"][0]
    price = cols["ss_sales_price"][0]
    n_items = int(item.max()) + 1
    uk, inv = np.unique(store * n_items + item, return_inverse=True)
    tot = np.bincount(inv, weights=price)
    sc = np.bincount(inv, weights=np.abs(price))
    return _top_candidates(uk // n_items, tot, sc,
                           lambda idx: [(int(i),) for i in uk[idx] % n_items])


def rollup_rank_window_oracle(cols: dict, item: dict) -> dict:
    """rollup_rank in numpy: per category (None for the grand total),
    every (brand, grouping id) group with its float64 sum of price ×
    quantity and its sum of |v|."""
    it = cols["ss_item_sk"][0]
    amt = cols["ss_sales_price"][0] * cols["ss_quantity"][0] \
        .astype(np.float64)
    cats, cat_of = np.unique(np.asarray(item["i_category"]).astype(str),
                             return_inverse=True)
    brands, brand_of = np.unique(np.asarray(item["i_brand"], dtype=object)
                                 .astype(str), return_inverse=True)
    nb = brands.size
    code = cat_of[it] * nb + brand_of[it]
    pair = np.bincount(code, weights=amt, minlength=cats.size * nb)
    pair_sc = np.bincount(code, weights=np.abs(amt),
                          minlength=cats.size * nb)
    seen = np.bincount(code, minlength=cats.size * nb) > 0
    out = {}
    for c, name in enumerate(cats.tolist()):
        at = np.flatnonzero(seen[c * nb:(c + 1) * nb])
        keys = [(brands[b], 0) for b in at] + [(None, 1)]
        tot = np.append(pair[c * nb + at], pair[c * nb:(c + 1) * nb].sum())
        sc = np.append(pair_sc[c * nb + at],
                       pair_sc[c * nb:(c + 1) * nb].sum())
        order = np.argsort(-tot, kind="stable")
        out[name] = ([keys[i] for i in order], tot[order], sc[order])
    out[None] = ([(None, 3)], np.array([amt.sum()]),
                 np.array([np.abs(amt).sum()]))
    return out


def check_ranked(table, part: str, keys: list, value: str, rank: str,
                 oracle: dict, top: int, label: str) -> dict:
    """A rank-filtered window result against its oracle's candidates.

    Every partition of the oracle is present; each row's group is among
    its partition's candidates, its float sum within 1e-12 of the
    group's sum of |v|, and its rank within what the oracle's sums allow:
    at least 1 + the groups whose sum is larger by more than the two
    groups' tolerances, at most 1 + the groups not smaller by more than
    them (a near-tie may go either way). Every row's rank is at most
    ``top``, no group comes twice, and a partition holds no more rows
    than its groups whose rank may be at most ``top``; every group whose
    rank cannot pass ``top`` is present. The rows are in (partition,
    rank, keys) order, exactly, nulls first."""
    rows = table.to_pylist()
    order = [tuple((r[c] is not None, r[c]) for c in [part, rank] + keys)
             for r in rows]
    check(order == sorted(order),
          f"{label}: rows in ({part}, {rank}, {', '.join(keys)}) order")
    by_part: dict = {}
    for r in rows:
        by_part.setdefault(r[part], []).append(r)
    check(set(by_part) == set(oracle),
          f"{label}: {len(by_part)} partitions, the oracle's "
          f"{len(oracle)}")
    worst, near = 0.0, 0
    for p, (ks, tot, sc) in oracle.items():
        index = {k: i for i, k in enumerate(ks)}
        tol = F64_SUM_TOL * (sc[:, None] + sc[None, :])
        diff = tot[None, :] - tot[:, None]          # [i, j] = T_j - T_i
        lo = 1 + (diff > tol).sum(1)
        hi = (diff >= -tol).sum(1)                  # self counted once
        may = int((lo <= top).sum())
        check(len(by_part[p]) <= may,
              f"{label}: {p}: {len(by_part[p])} rows, at most the {may} "
              f"groups whose rank may be <= {top}")
        seen = set()
        for r in by_part[p]:
            k = tuple(r[c] for c in keys)
            check(k in index, f"{label}: {p}/{k} among the oracle's "
                  f"{len(ks)} largest groups")
            check(r[rank] <= top, f"{label}: {p}/{k} rank {r[rank]} <= {top}")
            i = index[k]
            check(i not in seen, f"{label}: {p}/{k} once")
            err = abs(r[value] - tot[i])
            check(err <= F64_SUM_TOL * sc[i],
                  f"{label}: {p}/{k} sum within {F64_SUM_TOL} of its sum "
                  "of |v|")
            worst = max(worst, err / max(sc[i], 1e-300))
            check(lo[i] <= r[rank] <= hi[i],
                  f"{label}: {p}/{k} rank {r[rank]} in [{lo[i]}, {hi[i]}]")
            near += int(lo[i] != hi[i])
            seen.add(i)
        must = {i for i in range(len(ks)) if hi[i] <= top}
        check(must <= seen, f"{label}: {p}: every group of rank <= {top}")
    out = {"rows": len(rows), "partitions": len(by_part),
           "near_ties": near, "max_err_share": worst}
    log(f"{label}: {json.dumps(out)}")
    return out


def sweep_compare(want, got, name: str) -> dict:
    """One window sweep query on the card against the CPU, after both
    are sorted by the row's identity: every column cell by cell
    (``compare_cells``: exact), but the float sums and averages ``f_*``,
    which must be within 1e-12 of their ``a_*`` twin (Σ|v| over the same
    frame) and identical where not finite."""
    import pyarrow.compute as pc
    from auron_tpu_torch.it import queries as tq
    from auron_tpu_torch.it.comparator import compare_cells
    keys = list(tq.WINDOW_SWEEP_ROW) if name != "cube" else \
        ["i_category", "ss_quantity", "ss_store_sk", "spark_grouping_id"]

    def ordered(t):
        return t.take(pc.sort_indices(
            t, sort_keys=[(k, "ascending") for k in keys],
            null_placement="at_start"))

    want, got = ordered(want), ordered(got)
    fcols = [c for c in want.column_names if c.startswith("f_")]
    exact = [c for c in want.column_names if not c.startswith(("f_", "a_"))]
    bad, _ = compare_cells(want.select(exact), got.select(exact))
    check(not bad, f"sweep {name}: the card's cells are the CPU's: "
          f"{bad[:5]}")
    worst = 0.0
    for c in fcols:
        w = want[c].to_numpy(zero_copy_only=False)
        g = got[c].to_numpy(zero_copy_only=False)
        scale = want["a_" + c[2:]].to_numpy(zero_copy_only=False)
        wn = want[c].is_null().to_numpy(zero_copy_only=False)
        check(np.array_equal(wn, got[c].is_null().to_numpy(
            zero_copy_only=False)), f"sweep {name}: {c} nulls")
        w, g, scale = w[~wn].astype(float), g[~wn].astype(float), \
            scale[~wn].astype(float)
        fin = np.isfinite(w)
        check(np.array_equal(np.isnan(w), np.isnan(g))
              and np.array_equal(w[np.isinf(w)], g[np.isinf(w)]),
              f"sweep {name}: {c} identical where not finite")
        err = np.abs(g[fin] - w[fin])
        check(bool((err <= F64_SUM_TOL * scale[fin]).all()),
              f"sweep {name}: {c} within {F64_SUM_TOL} of Σ|v|")
        if fin.any():
            worst = max(worst, float((err / np.maximum(scale[fin], 1e-300))
                                     .max()))
    return {"rows": got.num_rows, "columns": got.num_columns,
            "float_columns": len(fcols), "max_err_share": worst}


class _WindowPeaks:
    """Wraps ``ops.window.window_batch`` while phase w runs: each call's
    input capacity, its device bytes at entry and its peak above them
    (``torch.cuda.max_memory_allocated`` after a reset at entry; the
    caching allocator counts at allocation, so no sync is needed)."""

    def __init__(self):
        from auron_tpu_torch.ops import window as twin
        self.module, self.inner, self.calls = twin, twin.window_batch, []

    def __enter__(self):
        def measured(batch, *args):
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = self.inner(batch, *args)
            self.calls.append({"capacity": batch.capacity,
                               "allocated_bytes": base,
                               "peak_extra_bytes":
                               torch.cuda.max_memory_allocated() - base})
            return out

        self.module.window_batch = measured
        return self

    def __exit__(self, *exc):
        self.module.window_batch = self.inner
        return False

    def take(self) -> list:
        calls, self.calls = self.calls, []
        return calls


def d2h_sources(fn) -> dict:
    """Where ``fn``'s device-to-host copies come from. One call runs under
    the profiler (host and device activity) with ``Tensor.cpu`` and
    ``Tensor.tolist`` of a CUDA tensor, the port's reads of the device
    (``ops.base.host_copy`` and ``host_readback``), each inside a
    ``record_function`` named by the first frame of the package outside
    ``ops/base.py`` that asked for it. Each device-to-host memcpy is
    charged to the annotation whose host interval holds the start of the
    host event it is linked to (not its own start: the card's clock may
    lead the host's by more than the gap between two reads), the rest to
    "unattributed". Returns {caller: {calls, bytes, ms}}, the largest ms
    first."""
    from torch.profiler import ProfilerActivity, profile, record_function

    pkg, base_py = str(ROOT / "auron_tpu_torch"), str(
        ROOT / "auron_tpu_torch" / "ops" / "base.py")
    asked: dict = {}
    saved = {m: torch.Tensor.__dict__.get(m) for m in ("cpu", "tolist")}

    def wrapped(method):
        inner = getattr(torch.Tensor, method)

        def call(t, *a, **k):
            if not t.is_cuda:
                return inner(t, *a, **k)
            f = sys._getframe(1)
            while f is not None and not (f.f_code.co_filename.startswith(pkg)
                                         and f.f_code.co_filename != base_py):
                f = f.f_back
            where = "outside the package" if f is None else (
                f"{Path(f.f_code.co_filename).relative_to(ROOT)}:"
                f"{f.f_lineno} {f.f_code.co_name}")
            rec = asked.setdefault(where, {"calls": 0, "bytes": 0, "ms": 0.0})
            rec["calls"] += 1
            rec["bytes"] += t.numel() * t.element_size()
            with record_function("d2h " + where):
                return inner(t, *a, **k)
        return call

    torch.cuda.synchronize()
    try:
        for m in saved:
            setattr(torch.Tensor, m, wrapped(m))
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
    finally:
        for m, v in saved.items():
            if v is None:
                delattr(torch.Tensor, m)
            else:
                setattr(torch.Tensor, m, v)
    spans, copies, host_start = [], [], {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            if not e.name().startswith("cuda"):   # runtime calls: CUPTI ids
                host_start[e.correlation_id()] = e.start_ns()
            if e.name().startswith("d2h "):
                spans.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                              e.name()[4:]))
        elif e.device_type() == torch.autograd.DeviceType.CUDA \
                and e.name().startswith("Memcpy DtoH"):
            copies.append((e.linked_correlation_id(), e.duration_ns() / 1e6))
    spans.sort()
    starts = [a for a, _, _ in spans]
    for link, ms in copies:
        start = host_start.get(link, -1)
        i = int(np.searchsorted(starts, start, side="right")) - 1
        where = spans[i][2] if i >= 0 and start <= spans[i][1] \
            else "unattributed"
        rec = asked.setdefault(where, {"calls": 0, "bytes": 0, "ms": 0.0})
        rec["ms"] += ms
    out = dict(sorted(asked.items(), key=lambda kv: -kv[1]["ms"]))
    log("device-to-host copies by caller: " + json.dumps(out))
    return out


def phase_windows(dev, pipe: dict, seed: int, root: str,
                  profile_sf10: bool) -> dict:
    """w. q16 and rollup_rank through the Session over ``pipe``'s
    files, each checked against
    its numpy oracle, timed by its checked run, its syncs counted (per
    input batch, and the window operator's own per window batch), its
    window batches' peak device bytes recorded, and profiled once at SF1
    (at SF10 with ``profile_sf10``); then the window sweep over SF1's
    tables on the card against the same queries on the CPU."""
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq

    t_phase = time.perf_counter()
    check(pipe["files"] is not None and pipe["dim_files"] is not None,
          "the window phase reads parquet: pyarrow imports")
    cols = pipe["cols"]
    rows = cols["ss_store_sk"][0].size
    tables = {"store_sales": pipe["files"], **pipe["dim_files"]}
    _, sf1_files = sf1_data(seed, root)
    prof_tables = tables if profile_sf10 else sf1_files
    session = Session(device=dev)
    gagg.cuda_sum_count.launches = 0
    t0 = time.perf_counter()
    oracles = {"q16": q16_window_oracle(cols),
               "rollup_rank": rollup_rank_window_oracle(
                   cols, pipe["dims"]["item"])}
    out = {"scale": pipe["scale"], "rows": rows,
           "oracle_s": time.perf_counter() - t0}
    queries = {
        "q16": (lambda t: tq.q16_dataframe(session, t),
                ("ss_store_sk", ["ss_item_sk"], "rev", "rnk", 3)),
        "rollup_rank": (lambda t: tq.rollup_rank_dataframe(session, t),
                        ("i_category", ["i_brand", "spark_grouping_id"],
                         "total", "rk", tq.ROLLUP_RANK_TOP)),
    }
    with _WindowPeaks() as peaks:
        for name, (make, shape) in queries.items():
            def verify(t, _s, name=name, shape=shape):
                part, keys, value, rank, top = shape
                return check_ranked(t, part, keys, value, rank,
                                    oracles[name], top, f"windows.{name}")

            peaks.take()
            base = torch.cuda.memory_allocated()
            res = run_session_query(
                f"windows.{name}", lambda m=make: m(tables),
                verify, rows, lambda m=make: m(prof_tables),
                timed=False)
            # the checked run's window batches come first, the profiled
            # run's after them
            w = res["window"]
            res["window_batches"] = peaks.take()[:w["output_batches"]]
            res["window_peak_extra_bytes"] = max(
                c["peak_extra_bytes"] for c in res["window_batches"])
            res["allocated_before_bytes"] = base
            res["host_syncs_per_window_batch"] = \
                w["host_syncs"] / w["output_batches"]
            del res["table"]
            res["profile_scale"] = PIPE_SCALE if profile_sf10 \
                else JOIN_CHECK_SCALE
            out[name] = res
    # the SF1 profile's largest device item is a device-to-host copy:
    # name the code that asks for it
    out["q16"]["d2h_sources"] = d2h_sources(
        lambda: tq.q16_dataframe(session, sf1_files).collect())
    out["sweep"] = window_sweep(session, sf1_files)
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    check(out["cuda_sum_count_launches"] == 0,
          "no cuda_dense_sum_count launch on the window path")
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"window phase: {out['phase_s']:.1f} s")
    return out


def window_sweep(session, files: dict) -> dict:
    """The window sweep (``it/queries.window_sweep_dataframes``) over
    SF1's tables on the card, each query timed by its wall, against the
    same queries through ``Session(device="cpu")``."""
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import queries as tq
    cpu = Session(device="cpu")
    t0 = time.perf_counter()
    want = {n: df.collect() for n, df in
            tq.window_sweep_dataframes(cpu, files).items()}
    out = {"cpu_s": time.perf_counter() - t0}
    total_ms, scanned = 0.0, 0
    s0 = host_readback.syncs
    for name, df in tq.window_sweep_dataframes(session, files).items():
        metrics = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = df.collect(metrics=metrics)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        res = sweep_compare(want[name], got, name)
        w = metrics["window"].snapshot()
        res.update(ms=ms, window_host_syncs=w["host_syncs"],
                   window_batches=w["output_batches"])
        out[name] = res
        total_ms += ms
        scanned += metrics["parquet_scan"].snapshot()["output_rows"]
    out["ms"] = total_ms
    out["scanned_rows"] = scanned
    out["rows_per_s"] = scanned / (total_ms / 1e3)
    out["host_syncs"] = host_readback.syncs - s0
    log("window sweep: " + json.dumps(out))
    return out


def phase_suites(dev, root: str) -> dict:
    """q. The TPC-DS suite at scale SUITE_TPCDS_SCALE and the TPC-H suite
    at SUITE_TPCH_SCALE, generated under ``root``; their oracles first,
    in worker processes; then every query in a fresh ``Session`` on the
    card through ``it.runner``, held against its oracle with the
    reference's comparator. The DISTINCT queries must raise naming
    ROADMAP item 16f-c. Then q14 and the slowest query are profiled
    once."""
    import pyarrow.parquet as pq
    from auron_tpu_torch.frontend.session import Session
    from auron_tpu_torch.it import runner, tpcds, tpch
    from auron_tpu_torch.it.comparator import QueryResultComparator
    from auron_tpu_torch.it.tpcds_queries import QUERIES as DS_QUERIES
    from auron_tpu_torch.it.tpch_queries import QUERIES as H_QUERIES

    t_phase = time.perf_counter()
    suites = {"tpch": (tpch, H_QUERIES, SUITE_TPCH_SCALE,
                       runner.TPCH_TOLERANCE),
              "tpcds": (tpcds, DS_QUERIES, SUITE_TPCDS_SCALE,
                        runner.TPCDS_TOLERANCE)}
    out, files = {}, {}
    for suite, (gen, queries, scale, _tol) in suites.items():
        t0 = time.perf_counter()
        files[suite] = gen.generate(str(Path(root) / suite), scale=scale)
        out[suite] = {"scale": scale, "generate_s": time.perf_counter() - t0,
                      "table_rows": {n: sum(pq.read_metadata(f).num_rows
                                            for f in fs)
                                     for n, fs in files[suite].items()},
                      "queries": {}, "refused": []}
        log(f"{suite} at scale {scale}: {out[suite]['table_rows']}")
    jobs = [(suite, files[suite], q.name)
            for suite, (_g, queries, _s, _t) in suites.items()
            for q in queries if q.name not in SUITE_DISTINCT]
    t0 = time.perf_counter()
    expected = runner.suite_oracles(jobs)
    out["oracles"] = {"host_cores": os.cpu_count(),
                      "s": time.perf_counter() - t0}
    log(f"{len(jobs)} oracles in {out['oracles']['s']:.1f} s")

    gagg.cuda_sum_count.launches = 0
    runs = {}
    for suite, (_gen, queries, _scale, tolerance) in suites.items():
        res, tables = out[suite], files[suite]
        comparator = QueryResultComparator(**tolerance)
        for q in queries:
            if q.name in SUITE_DISTINCT:
                with Session(device=dev) as session:
                    try:
                        q.run(session, tables)
                    except NotImplementedError as e:
                        check("DISTINCT" in str(e) and "16f-c" in str(e),
                              f"suites.{q.name} names 16f-c: {e}")
                    else:
                        raise RuntimeError(
                            f"check failed: suites.{q.name} ran, but its "
                            "DISTINCT aggregate is not ported")
                res["refused"].append(q.name)
                continue
            launches0 = gagg.cuda_sum_count.launches
            (r,) = runner._run_suite(
                [q], tables, {q.name: expected[(suite, q.name)]},
                comparator, device=dev, verbose=False)
            check(r.ok, f"suites.{suite}.{q.name}: {r.report()}")
            check(r.rows > 0, f"suites.{suite}.{q.name} returns rows")
            res["queries"][q.name] = {
                "ms": r.elapsed_s * 1e3, "oracle_ms": r.oracle_s * 1e3,
                "rows": r.rows, "host_syncs": r.syncs,
                "subqueries": r.subqueries, "subquery_ms": r.subquery_ms,
                "cuda_sum_count_launches":
                    gagg.cuda_sum_count.launches - launches0}
            runs[(suite, q.name)] = (q, tables)
            log(f"{suite}.{q.name}: " + json.dumps(res["queries"][q.name]))
        qs = res["queries"].values()
        res.update(passed=len(res["queries"]),
                   ms=sum(r["ms"] for r in qs),
                   oracle_ms=sum(r["oracle_ms"] for r in qs),
                   host_syncs=sum(r["host_syncs"] for r in qs),
                   subquery_ms=sum(r["subquery_ms"] for r in qs),
                   launching_queries=[n for n, r in res["queries"].items()
                                      if r["cuda_sum_count_launches"]])
        log(f"{suite}: {res['passed']} queries passed in "
            f"{res['ms'] / 1e3:.1f} s")
    check(sorted(out["tpcds"]["refused"]) == sorted(SUITE_DISTINCT)
          and not out["tpch"]["refused"],
          "the DISTINCT queries alone are refused")
    check(out["tpcds"]["passed"] == len(DS_QUERIES) - len(SUITE_DISTINCT)
          and out["tpch"]["passed"] == len(H_QUERIES),
          "every runnable suite query ran")
    out["cuda_sum_count_launches"] = gagg.cuda_sum_count.launches
    slowest = max(runs, key=lambda sn: out[sn[0]]["queries"][sn[1]]["ms"])
    out["profiles"] = {}
    for suite, name in (("tpcds", "q14"), slowest):
        q, tables = runs[(suite, name)]

        def once(q=q, tables=tables):
            with Session(device=dev) as session:
                q.run(session, tables)
        p = device_profile(once, iters=1, top=3, host_ops=False, warm=True)
        out["profiles"][f"{suite}.{name}"] = p
        log(f"profile {suite}.{name}: " + json.dumps(p))
    out["phase_s"] = time.perf_counter() - t_phase
    log(f"suite phase: {out['phase_s']:.1f} s")
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=42,
                        help="seed of the pipeline phase's data")
    parser.add_argument("--profile-at-sf10", action="store_true",
                        help="run phases p to w at SF10 instead of SF1 and "
                        "profile their Session queries there (runs past "
                        "1200 s)")
    args = parser.parse_args()
    card = phase_env()
    dev = torch.device("cuda")
    build_s, sass = phase_build()
    max_err = phase_kernel_checks(dev)
    launches, stage = phase_stage(dev)
    hash_twin = phase_hash_twin(dev, stage)
    stream = phase_hash_stream(dev)
    table = phase_hash_table(dev)
    name = torch.cuda.get_device_name(0)
    rate = mem_bytes_per_s(name)
    root = tempfile.mkdtemp(prefix=".chip_smoke_parquet_", dir=ROOT)
    try:
        # the depth cut: SF1 beside phase q, unless --profile-at-sf10
        pipeline, pipe = phase_pipeline(
            dev, args.seed, rate, root,
            PIPE_SCALE if args.profile_at_sf10 else JOIN_CHECK_SCALE)
        session = phase_session(dev, pipe, args.seed, root,
                                args.profile_at_sf10)
        joins = phase_joins(dev, pipe, args.seed, root,
                            args.profile_at_sf10)
        strings = phase_strings(dev, pipe, args.seed, root,
                                args.profile_at_sf10)
        expressions = phase_expressions(dev, pipe, args.seed, root,
                                        args.profile_at_sf10)
        decimals = phase_decimals(dev, pipe, args.seed, root,
                                  args.profile_at_sf10)
        windows = phase_windows(dev, pipe, args.seed, root,
                                args.profile_at_sf10)
        del pipe
        suites = phase_suites(dev, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    per_size, other = phase_times(dev, stage, rate)
    prof = phase_profile(dev, stage)
    for row in per_size:
        row["device_ms"] = prof[row["rows"]]["kernel"]["dense_sum_count_ms"]
    cmp = phase_compare(dev, stage)
    default = VARIANTS[0]
    warm = mean_of(cmp["flagship"][SIZES[0]]["warm"])

    head = per_size[0]
    kernel = {
        "name": "cuda_dense_sum_count", "route": "cuda",
        "source": "auron_tpu_torch/kernels/csrc/grouped_agg.cu",
        "replaces": "auron_tpu/kernels/grouped_agg.py:98",
        "replaces_kernel": "_vmem_agg_kernel",
        "launches": launches, "launches_per_stage": 1,
        "launches_pipeline": pipeline["dense"]["cuda_sum_count_launches"],
        "launches_by_path": {
            "stage": launches,
            "pipeline_sort": pipeline["sort"]["cuda_sum_count_launches"],
            "pipeline_dense": pipeline["dense"][
                "cuda_sum_count_launches"],
            "session": session["cuda_sum_count_launches"],
            "joins": joins["cuda_sum_count_launches"],
            "strings": strings["cuda_sum_count_launches"],
            "expressions": expressions["cuda_sum_count_launches"],
            "decimals": decimals["cuda_sum_count_launches"],
            "windows": windows["cuda_sum_count_launches"],
            "suites": suites["cuda_sum_count_launches"]},
        "pipeline_shape": pipeline["kernel_shape"],
        "max_abs_err": max_err, "max_err": max_err,
        "ms": head["ms"], "kernel_ms": head["ms"],
        "device_ms": head["device_ms"],
        "plain_ms": head["plain_ms"], "library_ms": head["library_ms"],
        "library_call": "2x Tensor.index_add_",
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "rows": head["rows"], "key_domain": _DOMAIN,
        "mem_bytes_per_s": rate, "by_rows": per_size,
        "single_group": other["single_group"],
        "variant_device_ms": warm[default],
        "pr1_kernel_ms": warm["pr1"],
        "cold_ms": mean_of(cmp["flagship"][SIZES[0]]["cold"])[default],
        "single_group_ms": mean_of(
            cmp["shapes"]["single_group"])[default],
    }
    report = {"build_s": build_s, "stages": other["stages"],
              "pipeline": pipeline, "session": session, "joins": joins,
              "strings": strings, "expressions": expressions,
              "decimals": decimals, "windows": windows, "suites": suites,
              "hash": {"twin": hash_twin, "stream": stream, "table": table},
              "profile": {str(n): p for n, p in prof.items()},
              "compare": cmp, "profiler_misses": EVENT_TIMED,
              "sass": sass, "card": card}
    print(json.dumps(report))
    print(json.dumps({"kernels": [kernel]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
