"""Entry points of the port: the flagship q01 query stage, and the q01
operator pipeline.

``entry(device=None)`` returns ``(fn, (batch,))``: the fused
filter → group → aggregate step over one columnar batch, and an example
batch. It runs on the card unless the caller passes another device.

The stage (the port of ``__graft_entry__._q01_kernel``):

1. a ``DeviceBatch`` of (k int64, v float64, f int32);
2. the predicate ``f > 10 AND v IS NOT NULL`` (exprs/eval.py);
3. keys clipped into the bounded domain [0, 2^16): out-of-range keys
   land in the boundary groups, a guard rather than a semantics;
4. a dense grouped (sum, count) over the 2^16 keys
   (kernels/grouped_agg.sum_count), the backend chosen by
   kernels/dispatch.py;
5. avg = sum / count.

It returns dense group state over the domain: (group_keys, key_valid,
sums, counts, avg). ``_q01_kernel_sort`` computes the same query on the
unbounded general path (xxhash64 → stable sort → segment sum) and is
the differential reference for the dense stage. ``_q01_kernel_hash``
computes it on the device hash table (hashtable/): claim-owner probe
rounds build the group table and the sum/count accumulators scatter into
their slots, with no sort.

``q01_pipeline_plan`` gives the physical plan of
``it.queries.q01_dataframe`` (scan → filter → partial AggOp → 4-way hash
exchange → final AggOp), and ``q01_pipeline`` runs it through
``runtime.executor.collect_numpy``:

    AggOp[final: 1 keys; sum,count,avg]
      ShuffleExchangeOp[HashPartitioning 4->4]
        AggOp[partial: 1 keys; sum,count,avg]
          FilterOp[1 predicates]
            ParquetScanOp[4 files]  (or DeviceBatchScanOp)

Over parquet files the plan comes from the front end
(``frontend.Session.read_parquet`` and ``Session.plan_physical``). Over
device batches, which no plan node can name, the same tree is built by
hand; there ``key_domain=None`` is the planner's plan, whose AggOps take
the sort path, and an integer bound on the store key is the dense plan,
whose partial AggOp reaches ``kernels/grouped_agg.cuda_sum_count`` twice
per batch on a CUDA device (the float sum and the avg).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import (DeviceBatch, PrimitiveColumn,
                                            batch_from_numpy)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import evaluate
from auron_tpu_torch.hashtable import grouped_agg_once
from auron_tpu_torch.io.parquet import DeviceBatchScanOp
from auron_tpu_torch.it.tpcds_data import fact_file_bounds
from auron_tpu_torch.kernels import dispatch, registry
from auron_tpu_torch.kernels import grouped_agg as gagg
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.agg import AggOp
from auron_tpu_torch.ops.project import FilterOp
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp
from auron_tpu_torch.parallel.partitioning import HashPartitioning
from auron_tpu_torch.runtime.executor import collect_numpy
from auron_tpu_torch.utils.shapes import bucket_rows

_SCHEMA = Schema((
    Field("k", DataType.INT64),       # group key (customer id class)
    Field("v", DataType.FLOAT64),     # measure (return amount class)
    Field("f", DataType.INT32),       # filter column (store id class)
))

# q01 shape: WHERE f > threshold AND v IS NOT NULL GROUP BY k
#            SELECT k, sum(v), count(v), avg(v)
_PREDICATE = ir.BinaryExpr(
    "and",
    ir.BinaryExpr(">", ir.ColumnRef(2), ir.Literal(10, DataType.INT32)),
    ir.IsNotNull(ir.ColumnRef(1)),
)

#: bounded group-key domain of the flagship stage: 2^16 keys
_DOMAIN = 1 << 16

_INT64_MAX = torch.iinfo(torch.int64).max


def _keep(batch: DeviceBatch) -> torch.Tensor:
    """Live rows that pass the predicate (a null predicate drops)."""
    pred = evaluate(_PREDICATE, batch, _SCHEMA)
    return batch.row_mask() & pred.validity & pred.data.bool()


def _q01_kernel(batch: DeviceBatch):
    """The flagship stage on ``batch``'s device, its grouped-agg backend
    resolved through the dispatch policy at this call."""
    return flagship_kernel(batch.device)(batch)


def _q01_kernel_impl(batch: DeviceBatch, backend: str, interpret: bool):
    keep = _keep(batch)
    kcol = batch.column(0)
    vcol = batch.column(1)
    vv = vcol.validity & keep
    k = kcol.data.clamp(0, _DOMAIN - 1).to(torch.int32)
    v = torch.where(vv, vcol.data, 0.0).to(torch.float32)
    c = vv.to(torch.float32)

    sums_g, cnt_g = gagg.sum_count(k, v, c, _DOMAIN, backend=backend,
                                   interpret=interpret)

    sums = sums_g.to(torch.float64)
    counts = cnt_g.to(torch.int64)  # exact below 2^24
    group_keys = torch.arange(_DOMAIN, dtype=torch.int64,
                              device=batch.device)
    key_valid = counts > 0
    avg = torch.where(key_valid, sums / counts.clamp(min=1), 0.0)
    return group_keys, key_valid, sums, counts, avg


@functools.lru_cache(maxsize=8)
def _flagship_fn(backend: str, interpret: bool):
    def kernel(batch):
        return _q01_kernel_impl(batch, backend, interpret)
    kernel.__name__ = f"_q01_kernel_{backend}" + \
        ("_interpret" if interpret else "")
    return kernel


def flagship_kernel(device=None):
    """Resolve the grouped-agg backend for ``device`` (default: the card)
    through the dispatch policy and return the flagship stage bound to
    it — one function object per (backend, interpret)."""
    dev = resolve_device(device)
    # record=False: the flagship is dense by contract, so it overrides a
    # declined policy; the counters below name the backend that runs
    decision = dispatch.select_grouped_agg(
        key_domain=_DOMAIN, key_dtypes=(DataType.INT64,),
        agg_fns=("sum", "count", "avg"),
        value_dtypes=(DataType.FLOAT64,), platform=dev.type, record=False)
    if decision.is_dense:
        backend, interpret = decision.kernel, decision.interpret
    else:
        backend, interpret = "dense_matmul", False
    registry.stats(backend).add("selected")
    if interpret:
        registry.stats(backend).add("interpret")
    return _flagship_fn(backend, interpret)


def _q01_kernel_sort(batch: DeviceBatch):
    """Unbounded-domain variant: xxhash64 → stable sort → segment sum.
    Group order is the reference's: by signed int64 hash, then by first
    appearance; dead rows sort last under the int64-max sentinel."""
    cap = batch.capacity
    dev = batch.device
    keep = _keep(batch)
    kcol = batch.column(0)
    vcol = batch.column(1)

    h = hashing.xxhash64_columns([kcol], cap)
    sort_key = torch.where(keep, h, _INT64_MAX)
    perm = torch.argsort(sort_key, stable=True)
    h_s = sort_key[perm]
    k_s = kcol.data[perm]
    v_s = torch.where(vcol.validity, vcol.data, 0.0)[perm]
    vv_s = (vcol.validity & keep)[perm]
    keep_s = keep[perm]

    # segment boundaries: first row of each (hash, key) run
    new_run = (h_s[1:] != h_s[:-1]) | (k_s[1:] != k_s[:-1])
    is_first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                          new_run]) & keep_s
    seg = torch.cumsum(is_first, 0) - 1
    seg = torch.where(keep_s, seg, cap - 1)

    sums = torch.zeros(cap, dtype=torch.float64, device=dev).index_add_(
        0, seg, torch.where(vv_s, v_s, 0.0))
    counts = torch.zeros(cap, dtype=torch.int64, device=dev).index_add_(
        0, seg, vv_s.to(torch.int64))
    # each slot takes the key of the last row of its segment (dead rows
    # share slot cap - 1), as the reference's scatter leaves it; seg is
    # non-decreasing, so that row is where seg steps up or the array ends;
    # every other row writes to a spare slot past the end
    is_last = torch.cat([seg[1:] != seg[:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    group_keys = torch.zeros(cap + 1, dtype=kcol.data.dtype, device=dev)
    group_keys = group_keys.scatter_(
        0, torch.where(is_last, seg, cap), k_s)[:cap]
    n_groups = is_first.sum()
    key_valid = torch.arange(cap, device=dev) < n_groups

    avg = torch.where(counts > 0, sums / counts.to(torch.float64), 0.0)
    return group_keys, key_valid, sums, counts, avg


#: slot capacity of the single-shot hash twin: 8x bench.py's 2^16
#: distinct keys (load factor 0.125), so the bulk of rows resolve in the
#: single full-width claim round and collision chains stay in the
#: compacted tail. Inputs with more distinct keys than this would drop
#: rows in the single-shot form; the streaming HashAggState grows instead.
_HASH_AGG_CAPACITY = 1 << 19


def _q01_kernel_hash(batch: DeviceBatch):
    """General-path variant on the device hash table, on ``batch``'s
    device: keys xxhash64 → claim rounds → sum/count scatters into slots.
    Output is dense group state in slot order: (keys, group_valid, sums,
    counts, avg) over ``_HASH_AGG_CAPACITY`` slots."""
    keep = _keep(batch)
    kcol = batch.column(0)
    vcol = batch.column(1)
    vv = vcol.validity & keep
    sums_in = torch.where(vv, vcol.data, 0.0)
    # int32 count lanes: batch counts stay far below 2^31
    cnt_in = vv.to(torch.int32)
    key = PrimitiveColumn(kcol.data, torch.ones_like(kcol.validity))
    cols, (sums, counts32), _ng, group_valid = grouped_agg_once(
        (key,), (sums_in, cnt_in), ("sum", "sum"), keep,
        _HASH_AGG_CAPACITY)
    counts = counts32.to(torch.int64)
    avg = torch.where(counts > 0, sums / counts.clamp(min=1), 0.0)
    return cols[0].data, group_valid, sums, counts, avg


def _example_batch(capacity: int = 8192, seed: int = 0,
                   device=None) -> DeviceBatch:
    """The reference's example batch, from the same seed: keys in
    [0, capacity/4), v normal with 5% nulls, f in [0, 40), and the last
    eighth of the capacity left as padding."""
    rng = np.random.default_rng(seed)
    n = capacity - capacity // 8
    k = rng.integers(0, capacity // 4, size=capacity).astype(np.int64)
    v = rng.normal(size=capacity)
    f = rng.integers(0, 40, size=capacity).astype(np.int32)
    v_valid = rng.random(capacity) > 0.05
    ones = np.ones(capacity, np.bool_)
    return batch_from_numpy([(k, ones), (v, v_valid), (f, ones)], n,
                            resolve_device(device))


def entry(device=None):
    """Returns (fn, example_args): the flagship step and its inputs, on
    the card unless ``device`` names another."""
    return _q01_kernel, (_example_batch(device=resolve_device(device)),)


# ---------------------------------------------------------------------------
# the q01 operator pipeline
# ---------------------------------------------------------------------------

#: the store_sales schema of the reference's parquet files
STORE_SALES_SCHEMA = Schema(tuple(
    Field(name, DataType.FLOAT64 if name in (
        "ss_sales_price", "ss_net_profit", "ss_net_paid")
        else DataType.INT64)
    for name in ("ss_sold_date_sk", "ss_customer_sk", "ss_item_sk",
                 "ss_store_sk", "ss_quantity", "ss_sales_price",
                 "ss_net_profit", "ss_net_paid")))

#: q01 as the reference planner plans it (it/queries.q01_dataframe):
#: WHERE ss_quantity > 5 GROUP BY ss_store_sk
#: SELECT sum(ss_sales_price) total, count(ss_net_paid) paid_cnt,
#:        avg(ss_net_profit) avg_profit
Q01_PREDICATES = (ir.BinaryExpr(
    ">", ir.ColumnRef(4, "ss_quantity"), ir.Literal(5, DataType.INT64)),)
Q01_GROUP = (ir.ColumnRef(3, "ss_store_sk"),)
Q01_AGGS = (ir.AggFunction("sum", ir.ColumnRef(5, "ss_sales_price")),
            ir.AggFunction("count", ir.ColumnRef(7, "ss_net_paid")),
            ir.AggFunction("avg", ir.ColumnRef(6, "ss_net_profit")))
Q01_GROUP_NAMES = ("ss_store_sk",)
Q01_AGG_NAMES = ("total", "paid_cnt", "avg_profit")


def store_sales_batches(cols: dict, device, partitions: int = 4,
                        batch_rows: int | None = None,
                        conf=None) -> list[list[DeviceBatch]]:
    """The fact columns (``it.tpcds_data.store_sales_columns``) as device
    batches, one list per partition: cut at the row ranges of the
    reference's parquet files, file i read by partition i % partitions,
    each file cut into batches of ``batch_rows`` (default: the file-scan
    size for ``device``) at the capacity a parquet scan of the same
    partition would give them."""
    dev = resolve_device(device)
    conf = conf or cfg.get_config()
    rows = batch_rows or cfg.file_scan_batch_rows(conf, dev)
    names = STORE_SALES_SCHEMA.names
    n = cols[names[0]][0].shape[0]
    bounds = fact_file_bounds(n)
    out: list[list[DeviceBatch]] = [[] for _ in range(partitions)]
    for p in range(partitions):
        files = [b for i, b in enumerate(bounds) if i % partitions == p]
        total = sum(hi - lo for lo, hi in files)
        cap = min(rows, bucket_rows(total)) if total else rows
        for lo, hi in files:
            for s in range(lo, hi, rows):
                e = min(s + rows, hi)
                pad = cap - (e - s)
                out[p].append(batch_from_numpy(
                    [(np.pad(cols[c][0][s:e], (0, pad)),
                      np.pad(cols[c][1][s:e], (0, pad))) for c in names],
                    e - s, dev))
    return out


def q01_pipeline_plan(source, partitions: int = 4,
                      key_domain: int | None = None, device=None,
                      conf=None):
    """The physical plan of q01 over ``source``: a list of parquet files
    (planned by a ``Session`` on ``device``) or a list of per-partition
    lists of ``DeviceBatch``es (→ ``DeviceBatchScanOp`` on their device,
    the planner's tree built by hand). ``key_domain`` set gives the
    partial AggOp over device batches the dense hint; the planner
    derives none over parquet files."""
    conf = conf or cfg.get_config()
    if source and isinstance(source[0], str):
        if key_domain is not None:
            raise ValueError("a key_domain hint needs device batches: "
                             "the planner derives none over parquet")
        from auron_tpu_torch.frontend.session import Session
        from auron_tpu_torch.it.queries import q01_dataframe
        session = Session(config=conf, device=device)
        df = q01_dataframe(session, {"store_sales": list(source)},
                           partitions)
        return session.plan_physical(df)
    empty = not any(part for part in source)
    scan = DeviceBatchScanOp(
        source, STORE_SALES_SCHEMA,
        device=resolve_device(device) if empty else None)
    cap = conf.get(cfg.AGG_INITIAL_CAPACITY)
    partial = AggOp(FilterOp(scan, list(Q01_PREDICATES)), list(Q01_GROUP),
                    list(Q01_AGGS), mode="partial",
                    group_names=list(Q01_GROUP_NAMES),
                    agg_names=list(Q01_AGG_NAMES), initial_capacity=cap,
                    key_domain=key_domain)
    exchange = ShuffleExchangeOp(
        partial, HashPartitioning((ir.ColumnRef(0),), partitions),
        input_partitions=partitions)
    final_aggs = [ir.AggFunction(a.fn) for a in Q01_AGGS]
    return AggOp(exchange, [ir.ColumnRef(0)], final_aggs, mode="final",
                 group_names=list(Q01_GROUP_NAMES),
                 agg_names=list(Q01_AGG_NAMES), initial_capacity=cap)


def q01_pipeline(source, partitions: int = 4,
                 key_domain: int | None = None, device=None, conf=None,
                 metrics: dict | None = None):
    """Plan and run q01 over ``source`` (see ``q01_pipeline_plan``):
    ``{column: (values, validity)}`` in the order the plan emits rows,
    partition 0 first. Runs on the card unless ``device`` or the
    source's batches say otherwise."""
    plan = q01_pipeline_plan(source, partitions, key_domain, device, conf)
    return collect_numpy(plan, partitions, conf, metrics)
