"""Window operator: ranks, offsets and aggregates over a window.

The port of ``auron_tpu.ops.window``. The operator buffers its
partition's batches, concatenates them into one batch and computes
every window function over it in one pass of torch ops:

  sort by (partition keys, order keys)            — ``ops.sort``'s words
  → segment and peer-group boundaries              — neighbour equality
  → each function a gather or a segmented scan over positions
    (row_number = pos - seg_start + 1, rank from a cummax of peer-group
    starts, running aggregates from segmented prefix scans, lead/lag
    from shifted gathers)

Aggregates take Spark's default frame (with ORDER BY, RANGE UNBOUNDED
PRECEDING..CURRENT ROW, peers sharing the value at their group's end;
without it, the whole partition) or a ROWS frame ``(lo, hi)`` for sum,
count and avg, computed as prefix differences within the segment.

The reference's segmented scans are ``lax.associative_scan``; here they
are ``segmented_scan``, a log-step (Hillis-Steele) scan over the same
(flag, value) operator: ``ceil(log2 capacity)`` doubling steps of a few
torch ops each, exact for integer sums, min, max and the limb adds and
compares. An integer sum takes one global ``cumsum`` minus the prefix at
its segment's start instead, which wraps and unwraps exactly; a float
sum never does (its error would grow with the whole batch's prefix).

Where the port departs from the reference: a float ``min`` or ``max``
starts from ``+inf`` or ``-inf``, not the largest finite float, so an
infinity after a null is kept (ROADMAP Queue 3 item 26). NaN still
spreads, as ``torch.minimum`` and ``torch.maximum`` propagate it.

No host value is read: the operator's one output batch keeps its row
count on the device.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.columnar.batch import (Decimal128Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn,
                                            compact, gather_batch,
                                            gather_column)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (EvalContext, TypedValue, evaluate,
                                        infer_dtype)
from auron_tpu_torch.ops.agg import _DEC_NEUTRAL, decimal_avg_result
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback, timer)
from auron_tpu_torch.ops.hashing import adjacent_eq
from auron_tpu_torch.ops.sort import _concat_all, sort_permutation

RANK_LIKE = ("row_number", "rank", "dense_rank", "percent_rank",
             "cume_dist", "ntile")
OFFSET_FNS = ("lead", "lag", "nth_value", "first_value", "last_value")
AGG_FNS = ("sum", "count", "count_star", "avg", "min", "max")


@dataclass(frozen=True)
class WindowFunctionSpec:
    kind: str                      # rank_like | offset | agg
    fn: str
    arg: Optional[ir.Expr] = None
    offset: int = 1                # lead/lag distance, nth n, ntile buckets
    default: object = None         # lead/lag default value
    #: ROWS BETWEEN (lo, hi) relative offsets for 'agg' functions
    #: (lo=-1, hi=1 is 1 PRECEDING..1 FOLLOWING); None = Spark's default
    #: frame. Supported for sum/count/count_star/avg (prefix-sum
    #: invertible); min/max over sliding frames fail fast.
    frame: Optional[tuple] = None

    def __post_init__(self):
        if self.kind == "rank_like":
            assert self.fn in RANK_LIKE, self.fn
        elif self.kind == "offset":
            assert self.fn in OFFSET_FNS, self.fn
        elif self.kind == "agg":
            assert self.fn in AGG_FNS, self.fn
        else:
            raise ValueError(self.kind)
        if self.frame is not None:
            if self.kind != "agg" or self.fn in ("min", "max"):
                raise NotImplementedError(
                    "ROWS frames are supported for sum/count/avg window "
                    "aggregates only (min/max need non-invertible sliding "
                    "state)")
            lo, hi = self.frame
            assert lo <= hi, self.frame


# ---------------------------------------------------------------------------
# segment machinery
# ---------------------------------------------------------------------------

def _col_neq_prev(col) -> torch.Tensor:
    """bool[cap]: row i differs from row i-1 (null-aware, NaN == NaN;
    row 0 => True)."""
    first = torch.ones(1, dtype=torch.bool, device=col.validity.device)
    return torch.cat([first, ~adjacent_eq(col)])


def _segmented_cummax_pos(flags: torch.Tensor) -> torch.Tensor:
    """For each row, the last position <= i where flags was True."""
    pos = torch.arange(flags.shape[0], device=flags.device)
    return torch.cummax(torch.where(flags, pos, -1), 0).values


def segmented_scan(seg_new: torch.Tensor, combine, *values):
    """Inclusive segmented prefix scan of the tuple ``values`` that
    restarts at every ``seg_new`` row: the reference's associative scan
    of ``(fa, va), (fb, vb) -> (fa | fb, vb if fb else combine(va,
    vb))`` as log-step doubling. ``combine(*a, *b)`` takes and returns
    tuples of tensors and must be associative. Returns a tuple."""
    vals = tuple(values)
    flags = seg_new
    n = flags.shape[0]
    d = 1
    while d < n:
        later = flags[d:]
        merged = combine(*(v[:-d] for v in vals), *(v[d:] for v in vals))
        vals = tuple(torch.cat([v[:d], torch.where(later, v[d:], m)])
                     for v, m in zip(vals, merged))
        flags = torch.cat([flags[:d], later | flags[:-d]])
        d *= 2
    return vals


def _segmented_sum_int(values: torch.Tensor,
                       seg_start: torch.Tensor) -> torch.Tensor:
    """Segmented inclusive int64 sum: a global cumsum minus the prefix
    before each row's segment start. int64 sums wrap and unwrap exactly,
    so this equals the log-step scan."""
    c = torch.cumsum(values, 0)
    return c - (c[seg_start] - values[seg_start])


def _add(a, b):
    return (a + b,)


def _segmented_float_sum(values, seg_new):
    return segmented_scan(seg_new, _add, values)[0]


# ---------------------------------------------------------------------------
# types
# ---------------------------------------------------------------------------

def _result_field(spec: WindowFunctionSpec, name: str,
                  in_schema: Schema) -> Field:
    if spec.kind == "rank_like":
        if spec.fn in ("percent_rank", "cume_dist"):
            return Field(name, DataType.FLOAT64, False)
        return Field(name, DataType.INT64, False)
    if spec.kind == "offset":
        dt, p, s = infer_dtype(spec.arg, in_schema)
        return Field(name, dt, True, p, s)
    # agg
    if spec.fn in ("count", "count_star"):
        return Field(name, DataType.INT64, False)
    dt, p, s = infer_dtype(spec.arg, in_schema)
    if spec.fn == "avg":
        if dt == DataType.DECIMAL:
            if p + 4 > 18:
                # as AggOp: an avg past 18 digits moves to the limbs with
                # Spark's bounded(p + 4, s + 4) type
                p, s = decimal_avg_result(p, s)
            else:
                p, s = _decimal_avg_type(p, s)
        elif dt != DataType.FLOAT64:
            dt = DataType.FLOAT64
    if spec.fn == "sum" and dt == DataType.DECIMAL:
        # Spark's sum headroom: decimal(p + 10, s) capped at 38; a narrow
        # input with p + 10 > 18 sums on the limbs (as AggOp)
        p = min(p + 10, 38)
    if spec.fn == "sum" and dt.is_integer:
        dt = DataType.INT64   # Spark: sum of an integer is a long
    return Field(name, dt, True, p, s)


def _decimal_half_up_div(total, count, shift: int):
    """Scaled-int decimal average: (total * shift) / count rounded
    HALF_UP away from zero (Spark's Decimal.divide), in quotient and
    remainder form. Shared by the default-frame and ROWS-frame avg."""
    num = total * shift
    safe = torch.clamp(count, min=1)
    a = torch.abs(num)
    q0 = a // safe
    rem = a - q0 * safe
    q = q0 + (2 * rem >= safe).to(torch.int64)
    return torch.where(num < 0, -q, q)


def _decimal_avg_type(p: int, s: int) -> tuple[int, int]:
    """Spark: avg(decimal(p,s)) -> decimal(p+4, s+4), capped at 18 on
    the int64 path, the scale clamped to the capped precision."""
    p = p or 18
    s = s or 0
    np_ = min(p + 4, 18)
    return np_, min(s + 4, np_)


# ---------------------------------------------------------------------------
# the window over one batch
# ---------------------------------------------------------------------------

class _Segments:
    """The sorted batch's positions, segment and peer-group bounds."""

    def __init__(self, sbatch: DeviceBatch, spcols, socols):
        cap = sbatch.capacity
        dev = sbatch.device
        self.cap = cap
        self.live = sbatch.row_mask()
        self.pos = torch.arange(cap, device=dev)
        seg_new = torch.zeros(cap, dtype=torch.bool, device=dev)
        for c in spcols:
            seg_new = seg_new | _col_neq_prev(c)
        seg_new[0] = True
        tie_new = seg_new
        for c in socols:
            tie_new = tie_new | _col_neq_prev(c)
        self.seg_new, self.tie_new = seg_new, tie_new
        self.seg_start = _segmented_cummax_pos(seg_new)
        self.seg_end_row = self._group_end(seg_new)
        self.tie_end_row = self._group_end(tie_new)
        self.npart = self.seg_end_row - self.seg_start + 1

    def _group_end(self, starts: torch.Tensor) -> torch.Tensor:
        """Each row's last live position in its group (the reference's
        ``segment_max`` of live positions by group id)."""
        gid = torch.cumsum(starts.to(torch.int64), 0) - 1
        gid = gid.clamp(0, self.cap - 1)
        end = torch.full((self.cap,), -1, dtype=torch.int64,
                         device=self.pos.device)
        end = end.scatter_reduce(0, gid, torch.where(self.live, self.pos, -1),
                                 "amax")
        return end[gid]

    def clip(self, idx: torch.Tensor) -> torch.Tensor:
        return idx.clamp(0, self.cap - 1)

    def seg_sum_int(self, values: torch.Tensor) -> torch.Tensor:
        return _segmented_sum_int(values, self.seg_start)


def _rank_like(spec, sg: _Segments, rank, row_number) -> torch.Tensor:
    if spec.fn == "row_number":
        return row_number
    if spec.fn == "rank":
        return rank
    if spec.fn == "dense_rank":
        return sg.seg_sum_int(sg.tie_new.to(torch.int64))
    npart = sg.npart
    if spec.fn == "percent_rank":
        return torch.where(npart > 1, (rank - 1).to(torch.float64)
                           / torch.clamp(npart - 1, min=1), 0.0)
    if spec.fn == "cume_dist":
        return (sg.tie_end_row - sg.seg_start + 1).to(torch.float64) \
            / torch.clamp(npart, min=1)
    # ntile
    k = spec.offset
    q, r = npart // k, npart % k
    rn0 = row_number - 1
    cutoff = (q + 1) * r
    return torch.where(rn0 < cutoff,
                       rn0 // torch.clamp(q + 1, min=1) + 1,
                       r + (rn0 - cutoff) // torch.clamp(q, min=1) + 1)


def _offset(spec, col, sg: _Segments, has_order: bool):
    live, pos = sg.live, sg.pos
    if spec.fn in ("lead", "lag"):
        delta = spec.offset if spec.fn == "lead" else -spec.offset
        src = pos + delta
        in_seg = (src >= sg.seg_start) & (src <= sg.seg_end_row)
        src_c = sg.clip(src)
    elif spec.fn == "first_value":
        src_c, in_seg = sg.seg_start, live
    elif spec.fn == "last_value":
        # the default frame: up to the current peer group's end
        src_c = sg.tie_end_row if has_order else sg.seg_end_row
        src_c, in_seg = sg.clip(src_c), live
    else:  # nth_value, clipped by the frame like last_value
        src = sg.seg_start + (spec.offset - 1)
        bound = sg.tie_end_row if has_order else sg.seg_end_row
        in_seg = (src <= bound) & live
        src_c = sg.clip(src)
    default = spec.default if spec.fn in ("lead", "lag") else None
    if isinstance(col, Decimal128Column):
        if spec.default is not None:
            raise NotImplementedError("lead/lag default over decimal(p>18)")
        return Decimal128Column(col.hi[src_c], col.lo[src_c],
                                col.validity[src_c] & in_seg & live)
    if isinstance(col, StringColumn):
        chars = col.chars[src_c]
        lens = torch.where(in_seg, col.lens[src_c], 0)
        valid = col.validity[src_c] & in_seg & live
        if default is not None:
            db = str(default).encode()[:col.width]
            drow = torch.zeros(col.width, dtype=torch.uint8,
                               device=chars.device)
            drow[:len(db)] = torch.tensor(list(db), dtype=torch.uint8)
            chars = torch.where(in_seg[:, None], chars, drow[None, :])
            lens = torch.where(in_seg, lens, len(db))
            valid = torch.where(in_seg, valid, live)
        return StringColumn(chars, lens, valid)
    data = col.data[src_c]
    valid = col.validity[src_c] & in_seg & live
    if default is not None:
        fill = torch.tensor(default).to(data.dtype).to(data.device)
        data = torch.where(in_seg, data, fill)
        valid = torch.where(in_seg, valid, live)
    return PrimitiveColumn(data, valid)


def _frame_agg(spec, v, in_schema: Schema, sg: _Segments):
    """A ROWS BETWEEN lo..hi aggregate: sum[i] = P[b] - P[a-1] with a and
    b clamped into the row's segment. Sums whose declared type passes 18
    digits run the prefix on the limbs; a framed avg over such a type
    raises, as in the reference."""
    live, pos, seg_new = sg.live, sg.pos, sg.seg_new
    if v is not None and spec.fn == "avg":
        dt0, p0, _s0 = infer_dtype(spec.arg, in_schema)
        if isinstance(v.col, Decimal128Column) or (
                dt0 == DataType.DECIMAL and p0 + 4 > 18):
            raise NotImplementedError(
                "ROWS frames over avg(decimal(p>14)): the framed HALF_UP "
                "division runs on the int64 path only")
    lo_off, hi_off = spec.frame
    a = pos + lo_off
    b = pos + hi_off
    f_empty = (a > sg.seg_end_row) | (b < sg.seg_start)
    a_c = torch.minimum(torch.maximum(a, sg.seg_start), sg.seg_end_row)
    b_c = torch.minimum(torch.maximum(b, sg.seg_start), sg.seg_end_row)
    f_bi = sg.clip(b_c)
    f_ai = sg.clip(a_c - 1)
    f_has_lo = a_c > sg.seg_start

    def frame_window(prefix):
        lo_v = torch.where(f_has_lo, prefix[f_ai], 0)
        return torch.where(f_empty, 0, prefix[f_bi] - lo_v)

    if spec.fn == "count_star":
        return PrimitiveColumn(
            frame_window(sg.seg_sum_int(live.to(torch.int64))), live)
    vv = v.validity & live
    wcnt = frame_window(sg.seg_sum_int(vv.to(torch.int64)))
    if spec.fn == "count":
        return PrimitiveColumn(wcnt, live)
    dt_in, p_in, s_in = infer_dtype(spec.arg, in_schema)
    if spec.fn == "sum" and dt_in == DataType.DECIMAL and (
            p_in + 10 > 18 or isinstance(v.col, Decimal128Column)):
        # a wide-typed frame sum: an exact 128-bit prefix and limb-pair
        # differences, nulled past the declared precision
        if isinstance(v.col, Decimal128Column):
            s_hi, s_lo = v.col.hi, v.col.lo
        else:
            s_hi, s_lo = D.from_int64(v.col.data.to(torch.int64))
        ph, pl = segmented_scan(seg_new, D.add128, torch.where(vv, s_hi, 0),
                                torch.where(vv, s_lo, 0))
        lh = torch.where(f_has_lo, ph[f_ai], 0)
        ll = torch.where(f_has_lo, pl[f_ai], 0)
        rh, rl = D.sub128(ph[f_bi], pl[f_bi], lh, ll)
        ok = ((wcnt > 0) & live & ~f_empty
              & D.fits_precision(rh, rl, min(p_in + 10, 38)))
        return Decimal128Column(rh, rl, ok)
    _require_numeric(v, spec)
    vals = torch.where(vv, v.col.data, 0)
    if vals.dtype.is_floating_point:
        p_sum = _segmented_float_sum(vals, seg_new)
    else:
        p_sum = sg.seg_sum_int(vals.to(torch.int64))
    wsum = frame_window(p_sum)
    if spec.fn == "avg":
        if dt_in == DataType.DECIMAL:
            _rp, rs = _decimal_avg_type(p_in, s_in)
            wsum = _decimal_half_up_div(wsum, wcnt, 10 ** (rs - (s_in or 0)))
        else:
            wsum = wsum.to(torch.float64) / torch.clamp(wcnt, min=1)
    return PrimitiveColumn(wsum, (wcnt > 0) & live)


def _require_numeric(v: TypedValue, spec) -> None:
    if not isinstance(v.col, PrimitiveColumn):
        raise NotImplementedError(
            f"window {spec.fn} over a {type(v.col).__name__}: the port "
            "aggregates numbers and decimals over a window")


def _wide_agg(spec, v, in_schema: Schema, sg: _Segments, has_order: bool):
    """sum, avg, min and max over two-limb values: the same segmented
    scans in 128-bit limb arithmetic."""
    live, seg_new = sg.live, sg.seg_new
    vv = v.validity & live
    hi, lo = v.col.hi, v.col.lo
    has = sg.seg_sum_int(vv.to(torch.int64))
    if spec.fn in ("sum", "avg"):
        rh, rl = segmented_scan(seg_new, D.add128, torch.where(vv, hi, 0),
                                torch.where(vv, lo, 0))
    else:   # min / max
        nh, nl = _DEC_NEUTRAL[f"d{spec.fn}"]
        take_max = spec.fn == "max"

        def pick(ah, al, bh, bl):
            lt, _ = D.cmp128(ah, al, bh, bl)
            take_a = ~lt if take_max else lt
            return torch.where(take_a, ah, bh), torch.where(take_a, al, bl)

        rh, rl = segmented_scan(seg_new, pick, torch.where(vv, hi, nh),
                                torch.where(vv, lo, nl))
    end = sg.clip(sg.tie_end_row if has_order else sg.seg_end_row)
    rh, rl, has_e = rh[end], rl[end], has[end]
    ok = has_e > 0
    _dt, p_in, s_in = infer_dtype(spec.arg, in_schema)
    if spec.fn == "sum":
        # running sums past the declared precision null, as AggOp's wide
        # sum (Spark's non-ANSI overflow)
        ok = ok & D.fits_precision(rh, rl, min(p_in + 10, 38))
    if spec.fn == "avg":
        _rp, rs = decimal_avg_result(p_in, s_in)
        rh, rl, fits = D.avg_pow10_div_half_up(
            rh, rl, torch.clamp(has_e, min=1), rs - s_in)
        ok = ok & fits
    return Decimal128Column(rh, rl, ok & live)


def _neutral(fn: str, dtype: torch.dtype):
    """min's and max's start value: ±inf for floats (ROADMAP Queue 3
    item 26: the reference's ±finfo.max loses an infinity after a null),
    the integer bounds otherwise."""
    if dtype.is_floating_point:
        return float("inf") if fn == "min" else float("-inf")
    info = torch.iinfo(dtype)
    return info.max if fn == "min" else info.min


def _agg(spec, v, in_schema: Schema, sg: _Segments, has_order: bool):
    live, seg_new = sg.live, sg.seg_new
    if v is not None and spec.fn in ("avg", "sum") \
            and not isinstance(v.col, Decimal128Column):
        dt, p, s = infer_dtype(spec.arg, in_schema)
        headroom = 4 if spec.fn == "avg" else 10
        if dt == DataType.DECIMAL and p + headroom > 18:
            # AggOp's wide promotion: window avg of decimal(15..18, s)
            # gives decimal(p+4, s+4), sum of decimal(9..18, s)
            # decimal(p+10, s)
            h, lo = D.from_int64(v.col.data.to(torch.int64))
            v = TypedValue(Decimal128Column(h, lo, v.validity),
                           DataType.DECIMAL, p, s)
    if v is not None and isinstance(v.col, Decimal128Column) \
            and spec.fn != "count":
        return _wide_agg(spec, v, in_schema, sg, has_order)
    if spec.fn == "count_star":
        run = sg.seg_sum_int(live.to(torch.int64))
        valid = live
    elif spec.fn == "count":
        run = sg.seg_sum_int((v.validity & live).to(torch.int64))
        valid = live
    else:
        _require_numeric(v, spec)
        ok = v.validity & live
        has = sg.seg_sum_int(ok.to(torch.int64))
        valid = has > 0
        data = v.col.data
        if spec.fn in ("sum", "avg"):
            vals = torch.where(ok, data, 0)
            if vals.dtype.is_floating_point:
                run = _segmented_float_sum(vals, seg_new)
            else:
                run = sg.seg_sum_int(vals.to(torch.int64))
            if spec.fn == "avg":
                dt_in, p_in, s_in = infer_dtype(spec.arg, in_schema)
                if dt_in == DataType.DECIMAL:
                    # the scaled-int divide at the clamped s + 4 scale
                    _rp, rs = _decimal_avg_type(p_in, s_in)
                    run = _decimal_half_up_div(run, has,
                                               10 ** (rs - (s_in or 0)))
                else:
                    run = run.to(torch.float64) / torch.clamp(has, min=1)
        else:  # min / max
            vals = torch.where(ok, data, _neutral(spec.fn, data.dtype))
            pick = torch.minimum if spec.fn == "min" else torch.maximum
            run = segmented_scan(seg_new, lambda a, b: (pick(a, b),),
                                 vals)[0]
    # peers share the value at their peer group's end; without ORDER BY
    # every row takes its segment's
    end = sg.clip(sg.tie_end_row if has_order else sg.seg_end_row)
    return PrimitiveColumn(run[end], valid[end] & live)


def window_batch(batch: DeviceBatch, partition_exprs: tuple, order_by: tuple,
                 fn_specs: tuple, in_schema: Schema,
                 group_limit: Optional[int]) -> DeviceBatch:
    """Every window function over one batch: the batch sorted by
    (partition keys, order keys), then one column per function, compacted
    to the rows of rank <= ``group_limit`` when one is given."""
    ectx = EvalContext(memo={})
    pcols = [evaluate(e, batch, in_schema, ectx).col
             for e in partition_exprs]
    ocols = [evaluate(o.expr, batch, in_schema, ectx).col for o in order_by]
    key_cols = pcols + ocols
    orders = ([(True, True)] * len(pcols)
              + [(o.ascending, o.nulls_first) for o in order_by])
    if key_cols:
        perm = sort_permutation(batch, key_cols, orders)
    else:
        perm = torch.arange(batch.capacity, device=batch.device)
    sbatch = gather_batch(batch, perm, batch.num_rows)
    live = sbatch.row_mask()
    sg = _Segments(sbatch, [gather_column(c, perm, live) for c in pcols],
                   [gather_column(c, perm, live) for c in ocols])
    has_order = bool(order_by)
    row_number = sg.pos - sg.seg_start + 1
    rank = _segmented_cummax_pos(sg.tie_new) - sg.seg_start + 1

    out_cols = []
    for spec in fn_specs:
        if spec.kind == "rank_like":
            out_cols.append(PrimitiveColumn(
                _rank_like(spec, sg, rank, row_number), sg.live))
            continue
        v = evaluate(spec.arg, sbatch, in_schema, ectx) \
            if spec.arg is not None else None
        if spec.kind == "offset":
            out_cols.append(_offset(spec, v.col, sg, has_order))
        elif spec.frame is not None:
            out_cols.append(_frame_agg(spec, v, in_schema, sg))
        else:
            out_cols.append(_agg(spec, v, in_schema, sg, has_order))

    result = DeviceBatch(tuple(sbatch.columns) + tuple(out_cols),
                         sbatch.num_rows)
    if group_limit is not None:
        result = compact(result, (rank <= group_limit) & sg.live)
    return result


# ---------------------------------------------------------------------------
# operator
# ---------------------------------------------------------------------------

class WindowOp(PhysicalOp):
    name = "window"

    def __init__(self, child: PhysicalOp, partition_by: list[ir.Expr],
                 order_by: list[ir.SortOrder],
                 functions: list[WindowFunctionSpec],
                 output_names: Optional[list[str]] = None,
                 group_limit: Optional[int] = None):
        self.child = child
        self.partition_by = tuple(partition_by)
        self.order_by = tuple(order_by)
        self.functions = tuple(functions)
        self.group_limit = group_limit
        names = output_names or [f"w{i}" for i in range(len(functions))]
        self.output_names = list(names)
        in_schema = child.schema()
        extra = [_result_field(spec, n, in_schema)
                 for spec, n in zip(self.functions, names)]
        self._schema = Schema(tuple(in_schema.fields) + tuple(extra))

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")
        syncs = metrics.counter("host_syncs")
        in_schema = self.child.schema()

        def stream():
            batches = []
            for b in self.child.execute(partition, ctx):
                ctx.check_cancelled()
                batches.append(b)
            if not batches:
                return
            s0 = host_readback.syncs
            with timer(elapsed, sync=ctx.device_sync) as t:
                merged = _concat_all(batches) if len(batches) > 1 \
                    else batches[0]
                del batches
                out = t.track(window_batch(
                    merged, self.partition_by, self.order_by,
                    self.functions, in_schema, self.group_limit))
            syncs.add(host_readback.syncs - s0)
            yield out

        return count_output(stream(), metrics)

    def __repr__(self):
        fns = ",".join(s.fn for s in self.functions)
        return (f"WindowOp[{fns} partition_by={len(self.partition_by)} "
                f"order_by={len(self.order_by)}]")
