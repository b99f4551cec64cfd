"""Grouped aggregation: ``AggOp`` in partial, final and complete modes.

The port of ``auron_tpu.ops.agg`` for primitive, string and decimal keys,
and the aggregates sum, count, count_star, avg, min, max and first (min,
max, first and count over strings too). Three paths, chosen per
execution as the reference chooses them:

- **sort** (the general path): per batch, xxhash64 of the keys → stable
  argsort → segment reduce into a hash-sorted group table; the table
  folds into a small "hot" state by ``torch.searchsorted`` merge
  positions and one scatter, and the hot state into "main" once it has
  grown ``_HOT_FACTOR`` times the batch capacity. Groups come out in
  hash order (uint64 ascending), as in the reference.
- **dense** (a ``key_domain`` hint on a partial or complete agg): each
  batch accumulates straight into [key_domain] arrays. Float sums and
  averages go through ``kernels/grouped_agg.sum_count`` — on a CUDA
  device the hand-written kernel ``cuda_sum_count`` — and integer sums,
  counts and min/max through exact scatters. The hint is verified: a key
  outside it fails the task with a ValueError.
- **hash** (``kernels/dispatch.select_hash_agg`` says so): the batch
  folds into the device hash table (``hashtable.HashAggState``).

Hashes are kept as int64 in uint64 order (``h ^ int64.min``), so sorts
and binary searches run on int64; dead rows and empty slots carry the
order's largest value and sort last.

A string accumulator (``_STR_KINDS``: min, max, first and
first_ignores_null over a string) is a triple (chars, lens, valid) with
its validity inside, and one state field. ``smin``/``smax`` reduce by
rank, not by a scatter of values: one stable argsort per order word
(``ops.sort.order_words``, then the length, valid rows first) ranks
every row, and an integer ``amin`` of the ranks picks each group's
winner, so the order of a device's atomics cannot change the answer.
The reference's dispatch sends them to the sort path (``acc_kind:smin``).

Decimals take Spark's result types: ``sum(decimal(p, s))`` is
``decimal(min(p + 10, 38), s)``, ``avg`` is ``decimal(min(p + 4, 38),
min(s + 4, 38))``. A result or an argument past 18 digits accumulates
on two int64 limbs (``_DEC_KINDS``: ``dsum``, ``dmin``, ``dmax``,
``dfirst``; the accumulator is a pair (hi, lo)): ``dsum`` adds the low
limb's 32-bit halves and the high limb as separate int64 sums and
recombines the carries, ``dmin``/``dmax`` take the high limb's extreme,
then the low limb's among the rows tied on it. A wide sum that passes
its precision is null; an average shifts to its scale inside the HALF_UP
division (``decimal128.avg_pow10_div_half_up``). These kinds are not
the hash table's: the dispatch keeps them on the sort path
(``acc_kind:dsum``).

Host syncs: each step that needs a group count on the host — the batch
reduce, a merge, the dense emit, a hash-table update — reads all its
control scalars in one ``ops.base.host_readback``. The spill tier, the
host-side aggregates (bloom filter, UDAF), collect_list/set and
DISTINCT are not ported: they raise ``NotImplementedError`` naming the
feature (DISTINCT and collect over decimals: ROADMAP item 16f; the
spill of decimal state: 18).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, Optional

import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch.columnar import decimal128 as D
from auron_tpu_torch.columnar.batch import (Decimal128Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn,
                                            gather_column,
                                            unify_column_widths)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (EvalContext, evaluate, infer_dtype,
                                        infer_field)
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback, timer)
from auron_tpu_torch.ops.sort import order_words
from auron_tpu_torch.utils.float_order import min_max, scatter_min_max
from auron_tpu_torch.utils.shapes import bucket_rows

# ---------------------------------------------------------------------------
# accumulator specs
# ---------------------------------------------------------------------------

_SUM_DTYPE = {
    DataType.INT8: DataType.INT64, DataType.INT16: DataType.INT64,
    DataType.INT32: DataType.INT64, DataType.INT64: DataType.INT64,
    DataType.FLOAT32: DataType.FLOAT64, DataType.FLOAT64: DataType.FLOAT64,
    DataType.DECIMAL: DataType.DECIMAL,
}

#: value types the ported accumulators take
_PRIMITIVE = frozenset(_SUM_DTYPE) | {DataType.BOOL, DataType.DATE32,
                                      DataType.TIMESTAMP_US}

#: reduce kinds over string values; their accumulator is a triple
#: (chars[cap, W] uint8, lens[cap] int32, valid[cap] bool)
_STR_KINDS = ("smin", "smax", "sfirst", "sfirst_ign")

#: reduce kinds over two-limb decimal(p > 18) values; their accumulator
#: is a pair (hi[cap], lo[cap]) of int64 limbs
_DEC_KINDS = ("dsum", "dmin", "dmax", "dfirst")

#: the limb-pair neutrals: dmin's is 2^127 - 1 (hi = INT64_MAX, lo all
#: ones), dmax's -2^127; decimals stay below 10^38 < 2^127, so neither
#: collides with a value
_DEC_NEUTRAL = {"dmin": (0x7FFFFFFFFFFFFFFF, -1),
                "dmax": (-0x8000000000000000, 0)}


@dataclass(frozen=True)
class AccSpec:
    """How one aggregate maps to flat state columns.

    state_fields: (name, dtype, reduce_kind) per state column; reduce
    kinds: sum | min | max | or | first (the value at the first-ordered
    live row of the group), the string kinds and the decimal kinds.
    ``state_ps``: per state field, the (precision, scale) of a decimal
    state column whose type is not the result's (avg's sum accumulates
    at the input scale; the count field carries the result's (p, s), so
    a final agg rebuilt from the partial schema recovers the type);
    None means the result's."""
    fn: str
    state_fields: tuple
    result: tuple  # (dtype, precision, scale)
    state_ps: Optional[tuple] = None


def decimal_avg_result(p: int, s: int) -> tuple[int, int]:
    """Spark's avg(decimal(p, s)): ``DecimalType.bounded(p + 4, s + 4)``,
    each bound clamped at 38 on its own (avg(decimal(38, 18)) is
    decimal(38, 22)), not the scale reduction binary arithmetic uses."""
    return min(p + 4, 38), min(s + 4, 38)


def _unsupported(what: str):
    return NotImplementedError(
        f"{what}: not ported; the port's AggOp takes sum, count, "
        "count_star, avg, min, max and first over primitive columns, and "
        "count, min, max and first over strings")


def _arg_dtype(agg: ir.AggFunction, in_schema: Schema) -> DataType:
    dt = infer_dtype(agg.arg, in_schema)[0]
    if dt not in _PRIMITIVE and not (
            dt == DataType.STRING
            and agg.fn in ("min", "max", "first", "first_ignores_null")):
        raise _unsupported(f"{agg.fn} over {dt.value}")
    return dt


def _string_spec(fn: str) -> "AccSpec":
    """min, max, first or first_ignores_null over a string: one state
    field, its validity inside the accumulator."""
    kind = {"min": "smin", "max": "smax", "first": "sfirst",
            "first_ignores_null": "sfirst_ign"}[fn]
    return AccSpec(fn, (("val", DataType.STRING, kind),),
                   (DataType.STRING, 0, 0))


def _refuse_wide_decimal(agg: ir.AggFunction, in_schema: Schema) -> None:
    """The reference's plan-time refusals of a decimal(p > 18) argument,
    word for word: DISTINCT count/sum/avg, bloom filters and UDAFs read
    single-word columns."""
    fn = agg.fn
    if agg.distinct and fn in ("count", "sum", "avg"):
        dt, p, _s = infer_dtype(agg.arg, in_schema)
        if dt == DataType.DECIMAL and p > 18:
            raise NotImplementedError(
                f"{fn} DISTINCT over decimal(p={p}>18): the set "
                "accumulator is single-word; cast the arg first")
    if (fn == "bloom_filter" or fn.startswith("udaf:")) \
            and agg.arg is not None:
        _dt, _p, _s = infer_dtype(agg.arg, in_schema)
        if _dt == DataType.DECIMAL and _p > 18:
            raise NotImplementedError(
                f"{fn} over decimal(p={_p}>18): cast the arg to "
                "decimal(<=18) or double first")


def _decimal_spec(fn: str, p: int, s: int) -> AccSpec:
    """sum, avg, min, max or first over a decimal(p, s)."""
    wide = p > 18
    if fn == "sum":
        if p + 10 > 18:
            # a narrow input with p in 9..18 moves to the limbs with
            # Spark's type; a wide sum past 2^127 wraps before the 10^38
            # check can see it, as a narrow int64 sum would
            return AccSpec(fn, (("sum", DataType.DECIMAL, "dsum"),
                                ("has", DataType.BOOL, "or")),
                           (DataType.DECIMAL, min(p + 10, 38), s))
        return AccSpec(fn, (("sum", DataType.DECIMAL, "sum"),
                            ("has", DataType.BOOL, "or")),
                       (DataType.DECIMAL, min(p + 10, 18), s))
    if fn == "avg":
        # the sum accumulates at the INPUT scale; the finalizer shifts to
        # the result scale inside the division
        if wide or p + 4 > 18:
            # past 18 digits: avg(decimal(16, 2)) is decimal(20, 6)
            rp, rs = decimal_avg_result(p, s)
            sp, kind = min(p + 10, 38), "dsum"
        else:
            rp = p + 4
            rs = min(s + 4, rp)
            sp, kind = min(p + 10, 18), "sum"
        return AccSpec(fn, (("sum", DataType.DECIMAL, kind),
                            ("count", DataType.INT64, "sum")),
                       (DataType.DECIMAL, rp, rs),
                       state_ps=((sp, s), (rp, rs)))
    if fn in ("min", "max"):
        kind = f"d{fn}" if wide else fn
    else:   # first and first_ignores_null share one kind
        kind = "dfirst" if wide else "first"
    return AccSpec(fn, (("val", DataType.DECIMAL, kind),
                        ("has", DataType.BOOL, "or")),
                   (DataType.DECIMAL, p, s))


def make_acc_spec(agg: ir.AggFunction, in_schema: Schema,
                  mode: str) -> AccSpec:
    fn = agg.fn
    _refuse_wide_decimal(agg, in_schema)
    if agg.distinct:
        raise _unsupported(f"{fn} DISTINCT")
    if fn in ("count", "count_star"):
        return AccSpec(fn, (("count", DataType.INT64, "sum"),),
                       (DataType.INT64, 0, 0))
    if fn not in ("sum", "avg", "min", "max", "first",
                  "first_ignores_null"):
        raise _unsupported(f"aggregate function {fn}")
    dt = _arg_dtype(agg, in_schema)
    if dt == DataType.STRING:
        return _string_spec(fn)
    if dt == DataType.DECIMAL:
        _dt, p, s = infer_dtype(agg.arg, in_schema)
        return _decimal_spec(fn, p, s)
    if fn == "sum":
        sdt = _SUM_DTYPE.get(dt)
        if sdt is None:
            raise _unsupported(f"sum over {dt.value}")
        return AccSpec(fn, (("sum", sdt, "sum"), ("has", DataType.BOOL, "or")),
                       (sdt, 0, 0))
    if fn == "avg":
        sdt = _SUM_DTYPE.get(dt)
        if sdt is None:
            raise _unsupported(f"avg over {dt.value}")
        return AccSpec(fn, (("sum", sdt, "sum"),
                            ("count", DataType.INT64, "sum")),
                       (DataType.FLOAT64, 0, 0))
    if fn in ("min", "max"):
        return AccSpec(fn, (("val", dt, fn), ("has", DataType.BOOL, "or")),
                       (dt, 0, 0))
    # first and first_ignores_null share one kind, as in the reference
    return AccSpec(fn, (("val", dt, "first"), ("has", DataType.BOOL, "or")),
                   (dt, 0, 0))


def make_acc_spec_from_partial(agg: ir.AggFunction, in_schema: Schema,
                               start_idx: int) -> AccSpec:
    """Spec for the final side: state dtypes read from the partial
    schema."""
    fn = agg.fn
    if agg.distinct:
        raise _unsupported(f"{fn} DISTINCT")
    if fn in ("count", "count_star"):
        return AccSpec(fn, (("count", DataType.INT64, "sum"),),
                       (DataType.INT64, 0, 0))
    f0 = in_schema[start_idx]
    if f0.dtype == DataType.STRING and fn in (
            "min", "max", "first", "first_ignores_null"):
        return _string_spec(fn)
    if f0.dtype not in _PRIMITIVE:
        raise _unsupported(f"{fn} state of {f0.dtype.value}")
    wide = f0.dtype == DataType.DECIMAL and f0.precision > 18
    if fn == "sum":
        return AccSpec(fn, (("sum", f0.dtype, "dsum" if wide else "sum"),
                            ("has", DataType.BOOL, "or")),
                       (f0.dtype, f0.precision, f0.scale))
    if fn == "avg":
        if f0.dtype == DataType.DECIMAL:
            # the partial side put the result's (p, s) in the count
            # field's precision and scale
            f1 = in_schema[start_idx + 1]
            rp, rs = f1.precision, f1.scale
            return AccSpec(fn, (("sum", f0.dtype, "dsum" if wide else "sum"),
                                ("count", DataType.INT64, "sum")),
                           (DataType.DECIMAL, rp, rs),
                           state_ps=((f0.precision, f0.scale), (rp, rs)))
        return AccSpec(fn, (("sum", f0.dtype, "sum"),
                            ("count", DataType.INT64, "sum")),
                       (DataType.FLOAT64, 0, 0))
    if fn in ("min", "max"):
        return AccSpec(fn, (("val", f0.dtype, f"d{fn}" if wide else fn),
                            ("has", DataType.BOOL, "or")),
                       (f0.dtype, f0.precision, f0.scale))
    if fn in ("first", "first_ignores_null"):
        return AccSpec(fn, (("val", f0.dtype, "dfirst" if wide else "first"),
                            ("has", DataType.BOOL, "or")),
                       (f0.dtype, f0.precision, f0.scale))
    raise _unsupported(f"aggregate function {fn}")


def _neutral(kind: str, dtype: torch.dtype):
    """The python neutral element of a reduce kind."""
    if kind == "sum":
        return 0
    if kind in ("min", "max"):
        if dtype.is_floating_point:
            return float("inf") if kind == "min" else float("-inf")
        if dtype == torch.bool:
            return kind == "min"
        info = torch.iinfo(dtype)
        return info.max if kind == "min" else info.min
    if kind == "or":
        return False
    raise ValueError(kind)


# ---------------------------------------------------------------------------
# the sort path's reduce and merge steps
# ---------------------------------------------------------------------------

#: flips the sign bit: int64 order of ``h ^ _SIGN`` is uint64 order of h
_SIGN = torch.iinfo(torch.int64).min
#: dead rows and empty slots: the uint64 maximum, in the flipped order
_HASH_SENTINEL = torch.iinfo(torch.int64).max
#: slots past a segment reduction's output that take the neutral
#: contributions of dead rows, spread by row id rather than piled on one
#: address (same-address atomics serialize on a CUDA device)
_SPARE_SLOTS = 1024


def _keys_equal_prev(sorted_keys, live: torch.Tensor) -> torch.Tensor:
    """eq[i] = keys[i] == keys[i-1] (null == null, NaN == NaN;
    eq[0] = False)."""
    eq = torch.ones_like(live)
    first = torch.zeros(1, dtype=torch.bool, device=live.device)
    for col in sorted_keys:
        eq = eq & torch.cat([first, hashing.adjacent_eq(col)])
    return eq


def _dest(gid: torch.Tensor, live: torch.Tensor, out_cap: int
          ) -> tuple[torch.Tensor, int]:
    """Scatter targets of a segment reduction into ``out_cap`` groups:
    live rows go to their group; dead rows, and groups past ``out_cap``
    (which the reference's segment ops drop), go to spare slots spread
    by row id. Returns (dest, spare)."""
    n = gid.shape[0]
    spare = max(1, min(n, _SPARE_SLOTS))
    rid = torch.arange(n, dtype=torch.int64, device=gid.device)
    ok = live & (gid < out_cap)
    return torch.where(ok, gid.to(torch.int64), out_cap + rid % spare), spare


def _segment(kind: str, vals: torch.Tensor, dest: torch.Tensor,
             out_cap: int, spare: int) -> torch.Tensor:
    """Segment reduction of ``vals`` into ``out_cap`` groups; empty
    groups hold the reduction's identity, as jax.ops.segment_* leave
    them."""
    if kind == "sum":
        return torch.zeros(out_cap + spare, dtype=vals.dtype,
                           device=vals.device).index_add_(
            0, dest, vals)[:out_cap]
    if kind == "or":
        hits = torch.zeros(out_cap + spare, dtype=torch.int32,
                           device=vals.device).index_add_(
            0, dest, vals.to(torch.int32))[:out_cap]
        return hits > 0
    if kind in ("min", "max"):
        if vals.dtype == torch.bool:
            return _segment(kind, vals.to(torch.int8), dest, out_cap,
                            spare).bool()
        ident = _neutral(kind, vals.dtype)
        return scatter_min_max(
            torch.full((out_cap + spare,), ident, dtype=vals.dtype,
                       device=vals.device), dest, vals, kind)[:out_cap]
    raise ValueError(kind)


def _reduce_sorted(keys_s, accs_s, live_s, h_s, kinds, out_cap: int):
    """Group + reduce rows that are ALREADY sorted by (dead last, hash
    ascending). Returns (keys, accs, hashes, num_groups); the output
    stays hash-sorted, the invariant the searchsorted merge relies on."""
    cap = live_s.shape[0]
    dev = live_s.device
    first = torch.zeros(1, dtype=torch.bool, device=dev)
    same_hash = torch.cat([first, h_s[1:] == h_s[:-1]])
    same_keys = _keys_equal_prev(keys_s, live_s)
    boundary = live_s & ~(same_hash & same_keys)
    gid = (torch.cumsum(boundary, 0, dtype=torch.int32) - 1).clamp(min=0)
    num_groups = boundary.sum(dtype=torch.int32)
    dest, spare = _dest(gid, live_s, out_cap)

    # first sorted row of each group: the representative for keys
    iota = torch.arange(cap, dtype=torch.int32, device=dev)
    rep = _segment("min", torch.where(live_s, iota, cap), dest, out_cap,
                   spare).clamp(0, cap - 1).to(torch.int64)
    out_valid = torch.arange(out_cap, dtype=torch.int32,
                             device=dev) < num_groups
    new_keys = tuple(gather_column(c, rep, out_valid) for c in keys_s)
    h_out = torch.where(out_valid, h_s[rep], _HASH_SENTINEL)

    new_accs = []
    for kind, acc in zip(kinds, accs_s):
        if kind in _STR_KINDS:
            new_accs.append(_reduce_string(kind, acc, live_s, dest, out_cap,
                                           spare, out_valid))
            continue
        if kind in _DEC_KINDS:
            new_accs.append(_reduce_decimal(kind, acc, live_s, gid, dest,
                                            rep, out_cap, spare))
            continue
        if kind == "first":
            # the value at the first sorted live row of the group
            new_accs.append(acc[rep])
            continue
        masked = torch.where(live_s, acc, _neutral(kind, acc.dtype))
        new_accs.append(_segment(kind, masked, dest, out_cap, spare))
    return new_keys, tuple(new_accs), h_out, num_groups


def _reduce_decimal(kind: str, acc, live_s: torch.Tensor, gid: torch.Tensor,
                    dest: torch.Tensor, rep: torch.Tensor, out_cap: int,
                    spare: int):
    """One limb-pair accumulator of rows sorted by group → its per-group
    (hi, lo). dsum: exact mod 2^128 (the low limb's two 32-bit halves and
    the high limb summed as int64, a half-sum of < 2^31 rows staying
    below 2^63, then the carries); dmin/dmax: the high limb's extreme,
    then the unsigned extreme of the low limbs tied on it; dfirst: the
    group's first live row."""
    h_acc, l_acc = acc
    if kind == "dfirst":
        return h_acc[rep], l_acc[rep]
    if kind == "dsum":
        lo_lo = torch.where(live_s, l_acc & D._M32, 0)
        lo_hi = torch.where(live_s, D._lsr32(l_acc), 0)
        s_ll = _segment("sum", lo_lo, dest, out_cap, spare)
        s_lh = _segment("sum", lo_hi, dest, out_cap, spare)
        s_h = _segment("sum", torch.where(live_s, h_acc, 0), dest, out_cap,
                       spare)
        mid = (s_ll >> 32) + s_lh          # both non-negative
        return s_h + (mid >> 32), (s_ll & D._M32) | (mid << 32)
    red = "min" if kind == "dmin" else "max"
    nh, _nl = _DEC_NEUTRAL[kind]
    mh = _segment(red, torch.where(live_s, h_acc, nh), dest, out_cap, spare)
    tied = live_s & (h_acc == mh[gid.clamp(max=out_cap - 1).to(torch.int64)])
    lx = torch.where(tied, l_acc ^ D._SIGN,
                     0x7FFFFFFFFFFFFFFF if kind == "dmin" else D._SIGN)
    return mh, _segment(red, lx, dest, out_cap, spare) ^ D._SIGN


def _reduce_string(kind: str, acc, live_s: torch.Tensor, dest: torch.Tensor,
                   out_cap: int, spare: int, out_valid: torch.Tensor):
    """One string accumulator of rows sorted by group → its per-group
    (chars, lens, valid). sfirst: the group's first live row;
    sfirst_ign: its first valid row (null when it has none); smin/smax:
    the valid row ranked first by value (null when none is valid)."""
    chars_s, lens_s, v = acc
    v_s = v & live_s
    cap = live_s.shape[0]
    idx = torch.arange(cap, dtype=torch.int32, device=live_s.device)
    if kind in ("sfirst", "sfirst_ign"):
        cand = torch.where(v_s if kind == "sfirst_ign" else live_s, idx, cap)
        raw = _segment("min", cand, dest, out_cap, spare)
        fi = raw.clamp(0, cap - 1).to(torch.int64)
        # raw == cap: no qualifying row; the clipped index then points
        # at an unrelated row whose validity must not leak through
        return chars_s[fi], lens_s[fi], v_s[fi] & (raw < cap) & out_valid
    words = order_words(StringColumn(chars_s, lens_s, v_s),
                        ascending=(kind == "smin"), nulls_first=False)
    lw = lens_s.to(torch.int64) ^ _SIGN     # embedded NULs tie-break
    words.append(lw if kind == "smin" else ~lw)
    lead = (~v_s).to(torch.int8)
    vperm = torch.arange(cap, device=live_s.device)
    for w in reversed([lead] + words):
        vperm = vperm[torch.argsort(w[vperm], stable=True)]
    rank = torch.empty(cap, dtype=torch.int32,
                       device=live_s.device).scatter_(0, vperm, idx)
    winner = _segment("min", torch.where(v_s, rank, cap), dest, out_cap,
                      spare)
    win = vperm[winner.clamp(0, cap - 1).to(torch.int64)]
    has = _segment("or", v_s, dest, out_cap, spare)
    return chars_s[win], lens_s[win], has & out_valid


def _gather_acc(a, perm: torch.Tensor):
    """An accumulator (a tensor or a string triple) at rows ``perm``."""
    return tuple(x[perm] for x in a) if isinstance(a, tuple) else a[perm]


def _slice_acc(a, n: int):
    return tuple(x[:n] for x in a) if isinstance(a, tuple) else a[:n]


def _unify_acc_pair(a, b) -> tuple:
    """Pad the char matrices of two string accumulators to one width (a
    decimal's limb pair has none)."""
    if not isinstance(a, tuple) or a[0].dim() == 1:
        return a, b
    w = max(a[0].shape[1], b[0].shape[1])

    def pad(t):
        return (torch.nn.functional.pad(t[0], (0, w - t[0].shape[1])),) \
            + tuple(t[1:])
    return pad(a), pad(b)


def _acc_column(a, valid: torch.Tensor):
    """An accumulator as a state or result column: a string triple keeps
    its validity, masked by ``valid``; a limb pair takes ``valid``."""
    if isinstance(a, tuple) and len(a) == 2:
        return Decimal128Column(a[0], a[1], valid)
    if isinstance(a, tuple):
        return StringColumn(a[0], a[1], a[2] & valid)
    return PrimitiveColumn(a, valid)


def _slice_column(c, n: int):
    if isinstance(c, StringColumn):
        return StringColumn(c.chars[:n], c.lens[:n], c.validity[:n])
    if isinstance(c, Decimal128Column):
        return Decimal128Column(c.hi[:n], c.lo[:n], c.validity[:n])
    return PrimitiveColumn(c.data[:n], c.validity[:n])


def _batch_reduce(keys, accs, live, kinds, cap: int):
    """(keys, accs, live) of one batch → its own group table,
    hash-sorted: one stable sort of the BATCH only."""
    h = hashing.xxhash64_columns(list(keys), cap,
                                 device=live.device) ^ _SIGN
    h = torch.where(live, h, _HASH_SENTINEL)   # dead rows to the end
    perm = torch.argsort(h, stable=True)
    ones = torch.ones(cap, dtype=torch.bool, device=live.device)
    keys_s = tuple(gather_column(c, perm, ones) for c in keys)
    accs_s = tuple(_gather_acc(a, perm) for a in accs)
    return _reduce_sorted(keys_s, accs_s, live[perm], h[perm], kinds, cap)


def _state_merge(kinds, out_cap: int, keys_s, accs_s, h_s, n_s, keys_b,
                 accs_b, h_b, n_b):
    """Fold a hash-sorted batch table into the hash-sorted state without
    re-sorting the state: merge positions from two searchsorted calls,
    one permutation that interleaves both sides, and the shared reduce
    folds duplicate groups. State rows go first on hash ties, so
    ``first`` prefers earlier batches."""
    cap_s, cap_b = h_s.shape[0], h_b.shape[0]
    dev = h_s.device
    live_s = torch.arange(cap_s, dtype=torch.int32, device=dev) < n_s
    live_b = torch.arange(cap_b, dtype=torch.int32, device=dev) < n_b
    pos_s = torch.arange(cap_s, device=dev) + torch.searchsorted(h_b, h_s)
    pos_b = torch.arange(cap_b, device=dev) + torch.searchsorted(
        h_s, h_b, right=True)
    m = cap_s + cap_b
    # the merged order as ONE gather permutation of cat(state, batch)
    perm = torch.empty(m, dtype=torch.int64, device=dev).scatter_(
        0, torch.cat([pos_s, pos_b]), torch.arange(m, device=dev))

    def merged(a, b):
        if isinstance(a, tuple):
            a, b = _unify_acc_pair(a, b)
            return tuple(merged(x, y) for x, y in zip(a, b))
        return torch.cat([a, b])[perm]

    def merged_col(a, b):
        if isinstance(a, StringColumn):
            return StringColumn(*merged((a.chars, a.lens, a.validity),
                                        (b.chars, b.lens, b.validity)))
        if isinstance(a, Decimal128Column):
            return Decimal128Column(*merged((a.hi, a.lo, a.validity),
                                            (b.hi, b.lo, b.validity)))
        return PrimitiveColumn(merged(a.data, b.data),
                               merged(a.validity, b.validity))

    keys_m = tuple(merged_col(a, b) for a, b in zip(keys_s, keys_b))
    accs_m = tuple(merged(a, b) for a, b in zip(accs_s, accs_b))
    return _reduce_sorted(keys_m, accs_m, merged(live_s, live_b),
                          merged(h_s, h_b), kinds, out_cap)


# ---------------------------------------------------------------------------
# row → state contributions
# ---------------------------------------------------------------------------

def _state_accs(specs, batch: DeviceBatch, start: int) -> list:
    """The accumulator columns of a batch in partial-state layout, from
    column ``start`` on: as they are, a 'has' flag masked by its
    validity. A limb pair's invalid rows already hold the reduction's
    neutral (the partial emit and the passthrough put it there)."""
    accs = []
    idx = start
    for spec in specs:
        for fname, _fdt, kind in spec.state_fields:
            col = batch.columns[idx]
            if kind in _STR_KINDS:
                accs.append((col.chars, col.lens, col.validity))
            elif kind in _DEC_KINDS:
                accs.append((col.hi, col.lo))
            else:
                accs.append(col.data.bool() & col.validity if fname == "has"
                            else col.data)
            idx += 1
    return accs


def _contribution_columns(group_exprs, mode: str, aggs, specs,
                          batch: DeviceBatch, in_schema: Schema,
                          ectx: EvalContext):
    """Group keys and per-row initial accumulator columns of a batch."""
    keys = tuple(evaluate(e, batch, in_schema, ectx).col
                 for e in group_exprs)
    live = batch.row_mask()
    if mode == "final":
        return keys, _state_accs(specs, batch, len(group_exprs)), live
    accs = []

    for agg, spec in zip(aggs, specs):
        if agg.fn in ("count", "count_star"):
            if agg.arg is None:
                accs.append(live.to(torch.int64))
            else:
                v = evaluate(agg.arg, batch, in_schema, ectx)
                accs.append((v.validity & live).to(torch.int64))
            continue
        v = evaluate(agg.arg, batch, in_schema, ectx)
        valid = v.validity & live
        if isinstance(v.col, StringColumn):
            accs.append((v.col.chars, v.col.lens, valid))
            continue
        if isinstance(v.col, Decimal128Column) or any(
                k in _DEC_KINDS for _f, _d, k in spec.state_fields):
            accs.extend(_decimal_contributions(spec, v, valid))
            continue
        for fname, fdt, kind in spec.state_fields:
            if fname == "has":
                accs.append(valid)
            elif fname == "count":
                accs.append(valid.to(torch.int64))
            elif kind == "sum":
                accs.append(torch.where(valid, v.data, 0).to(
                    fdt.to_torch()))
            elif kind in ("min", "max"):
                accs.append(torch.where(valid, v.data,
                                        _neutral(kind, v.data.dtype)))
            elif kind == "first":
                accs.append(v.data)
            else:
                raise ValueError(kind)
    return keys, accs, live


def _decimal_contributions(spec: AccSpec, v, valid: torch.Tensor) -> list:
    """Per-row accumulators of a decimal argument on the limbs (a narrow
    argument sign-extended, for a sum or avg whose result passes 18
    digits); invalid rows hold each kind's neutral."""
    hi, lo = (v.col.hi, v.col.lo) if isinstance(v.col, Decimal128Column) \
        else D.from_int64(v.data.to(torch.int64))
    out = []
    for fname, _fdt, kind in spec.state_fields:
        if fname == "has":
            out.append(valid)
        elif fname == "count":
            out.append(valid.to(torch.int64))
        elif kind == "dsum":
            out.append((torch.where(valid, hi, 0), torch.where(valid, lo, 0)))
        elif kind in ("dmin", "dmax"):
            nh, nl = _DEC_NEUTRAL[kind]
            out.append((torch.where(valid, hi, nh),
                        torch.where(valid, lo, nl)))
        elif kind == "dfirst":
            out.append((hi, lo))
        else:
            raise ValueError(kind)
    return out


def _state_ps(spec: AccSpec, fi: int, fdt: DataType) -> tuple[int, int]:
    """(precision, scale) of state field ``fi`` in the partial schema."""
    if spec.state_ps is not None:
        return spec.state_ps[fi]
    if fdt == DataType.DECIMAL:
        return spec.result[1], spec.result[2]
    return 0, 0


def _passthrough_state_batch(keys, accs, live, num_rows) -> DeviceBatch:
    """One input batch in partial-state layout without merging: each
    row is its own group (partial-agg skipping)."""
    cols = list(keys) + [Decimal128Column(a[0], a[1], live)
                         if isinstance(a, tuple) and len(a) == 2
                         else StringColumn(*a) if isinstance(a, tuple)
                         else PrimitiveColumn(a, live) for a in accs]
    return DeviceBatch(tuple(cols), num_rows)


def _finish_avg(spec: AccSpec, s, cnt: torch.Tensor, valid: torch.Tensor):
    """An average from its (sum, count) state: float64 for a number; for
    a decimal the sum (at the input scale) shifts to the result scale
    inside a HALF_UP division, q * 10^k + round(r * 10^k / count), and
    an average that cannot fit its precision is null."""
    safe = cnt.clamp(min=1)
    if isinstance(s, tuple):
        k = spec.result[2] - spec.state_ps[0][1]
        qh, ql, fits = D.avg_pow10_div_half_up(s[0], s[1], safe, k)
        return Decimal128Column(qh, ql, valid & (cnt > 0) & fits)
    if spec.result[0] == DataType.DECIMAL:
        k = spec.result[2] - spec.state_ps[0][1]
        shift = 10 ** k
        a = torch.abs(s)
        q0 = a // safe
        rem = a - q0 * safe
        fits = q0 < 10 ** (18 - k)
        q = q0 * shift + (2 * rem * shift + safe) // (2 * safe)
        return PrimitiveColumn(torch.where(s < 0, -q, q),
                               valid & (cnt > 0) & fits)
    return PrimitiveColumn(s.to(torch.float64) / safe, valid & (cnt > 0))


class _HashPathCtl:
    """Per-execution hash-path control: the dispatch decision's knobs
    plus the mid-stream fallback latch."""

    __slots__ = ("load_factor", "max_probe_rounds", "metrics", "disabled")

    def __init__(self, decision, metrics):
        self.load_factor = decision.load_factor
        self.max_probe_rounds = decision.max_probe_rounds
        self.metrics = metrics
        self.disabled = False


# ---------------------------------------------------------------------------
# the operator
# ---------------------------------------------------------------------------

class AggOp(PhysicalOp):
    """mode: 'partial' emits (keys..., state...); 'final' consumes state
    columns; 'complete' does the whole aggregation in one operator."""

    name = "agg"

    #: hot table folds into main once it has grown this many times the
    #: batch capacity
    _HOT_FACTOR = 8

    def __init__(self, child: PhysicalOp, group_exprs: list[ir.Expr],
                 aggs: list[ir.AggFunction], mode: str = "complete",
                 group_names: Optional[list[str]] = None,
                 agg_names: Optional[list[str]] = None,
                 initial_capacity: int = 4096,
                 key_domain: Optional[int] = None):
        if mode not in ("partial", "final", "complete"):
            raise ValueError(f"AggOp mode {mode!r}")
        self.child = child
        self.group_exprs = tuple(group_exprs)
        self.aggs = tuple(aggs)
        self.mode = mode
        self.initial_capacity = initial_capacity
        #: exclusive bound on the (non-negative, non-null) group key, a
        #: plan-time promise verified at run time
        self.key_domain = key_domain
        in_schema = child.schema()
        if mode == "final":
            self.specs = []
            idx = len(group_exprs)
            for a in aggs:
                spec = make_acc_spec_from_partial(a, in_schema, idx)
                self.specs.append(spec)
                idx += len(spec.state_fields)
        else:
            self.specs = [make_acc_spec(a, in_schema, mode) for a in aggs]

        self.group_names = list(group_names or
                                [f"k{i}" for i in range(len(group_exprs))])
        self.agg_names = list(agg_names or
                              [f"a{i}" for i in range(len(aggs))])
        key_fields = [infer_field(e, in_schema, n)
                      for e, n in zip(self.group_exprs, self.group_names)]
        if mode == "partial":
            state_fields = [Field(f"{an}#{fname}", fdt, True,
                                  *_state_ps(spec, fi, fdt))
                            for spec, an in zip(self.specs, self.agg_names)
                            for fi, (fname, fdt, _kind)
                            in enumerate(spec.state_fields)]
            self._schema = Schema(tuple(key_fields + state_fields))
        else:
            out_fields = [Field(n, spec.result[0], True, spec.result[1],
                                spec.result[2])
                          for spec, n in zip(self.specs, self.agg_names)]
            self._schema = Schema(tuple(key_fields + out_fields))

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def _device_kinds(self) -> list[str]:
        return [kind for spec in self.specs
                for (_f, _d, kind) in spec.state_fields]

    def combine_fold_reason(self) -> Optional[str]:
        """None when the reference folds this agg into its shuffle-split
        program as a map-side combine, else why not. The port keeps no
        host or collect state, so those reasons of the reference's never
        arise."""
        if self.mode != "partial":
            return "not_partial"
        if not self.group_exprs:
            return "no_group_keys"
        if self.key_domain is not None:
            return "dense_domain"
        exact = {"sum", "min", "max", "or", "first", *_STR_KINDS,
                 *_DEC_KINDS}
        if any(k not in exact for k in self._device_kinds()):
            return "unsupported_kind"
        if any(kind == "sum" and fdt in (DataType.FLOAT32, DataType.FLOAT64)
               for spec in self.specs
               for (_f, fdt, kind) in spec.state_fields):
            return "float_sum_inexact"
        return None

    # -- sort path: table steps ---------------------------------------------

    def _grow_check(self, ng: int, out_cap: int) -> tuple[bool, int]:
        """(ok, next capacity): the table fits when the groups do."""
        ok = ng <= out_cap
        return ok, (bucket_rows(ng) if ng > out_cap else out_cap)

    def _shrink_table(self, tbl, ng: int):
        """Slice a group table down to its occupancy bucket (live groups
        are a hash-sorted prefix)."""
        keys, accs, n, cap, h = tbl
        new_cap = max(bucket_rows(max(ng, 1)), self.initial_capacity)
        if new_cap >= cap:
            return tbl
        keys2 = tuple(_slice_column(c, new_cap) for c in keys)
        accs2 = tuple(_slice_acc(a, new_cap) for a in accs)
        return (keys2, accs2, n, new_cap, h[:new_cap])

    def _reduce_batch(self, keys, accs, live, elapsed):
        """One batch → its hash-sorted group table: one readback of the
        group count, then a slice to its bucket. A batch has no more
        groups than rows, so its own capacity always fits (the reference
        retries only for collect kinds, which the port does not take)."""
        cap_b = live.shape[0]
        with timer(elapsed):
            bk, ba, bh, bn = _batch_reduce(tuple(keys), tuple(accs), live,
                                           self._device_kinds(), cap_b)
            (ng,) = host_readback([bn])
        return self._shrink_table((bk, ba, bn, cap_b, bh), ng)

    def _merge_tables(self, s, b, elapsed):
        """Fold group table ``b`` into group table ``s`` (both
        hash-sorted), growing the capacity until the groups fit."""
        kinds = self._device_kinds()
        s_keys, s_accs, s_n, s_cap, s_h = s
        bk, ba, bn, _cap_b, bh = b
        unified = [unify_column_widths([a, c]) for a, c in zip(s_keys, bk)]
        s_keys = tuple(p[0] for p in unified)
        bk = tuple(p[1] for p in unified)
        pairs = [_unify_acc_pair(a, c) for a, c in zip(s_accs, ba)]
        s_accs = tuple(p[0] for p in pairs)
        ba = tuple(p[1] for p in pairs)
        out_cap = max(s_cap, self.initial_capacity)
        while True:
            with timer(elapsed):
                new_keys, new_accs, h_out, num_groups = _state_merge(
                    kinds, out_cap, s_keys, s_accs, s_h, s_n, bk, ba, bh,
                    bn)
                (ng,) = host_readback([num_groups])
            ok, out_cap = self._grow_check(ng, out_cap)
            if ok:
                return self._shrink_table(
                    (new_keys, new_accs, num_groups, out_cap, h_out), ng)

    def _merge_sorted(self, state, keys, accs, live, elapsed):
        """state: None | (main, hot). Every batch merges into the small
        hot table; the hot table folds into main only once it has grown
        ``_HOT_FACTOR`` times the batch capacity."""
        batch_tbl = self._reduce_batch(keys, accs, live, elapsed)
        cap_b = live.shape[0]
        main, hot = state if state is not None else (None, None)
        if hot is None:
            hot = batch_tbl
        else:
            hot = self._merge_tables(hot, batch_tbl, elapsed)
        if hot[3] >= self._HOT_FACTOR * max(cap_b, self.initial_capacity):
            main = hot if main is None else self._merge_tables(main, hot,
                                                               elapsed)
            hot = None
        return (main, hot)

    # -- hash path ------------------------------------------------------------

    def _hash_dispatch(self, ctx: ExecContext, record: bool = True):
        """The general-path grouping policy: hashtable vs sort
        (``record=False``: decided without counting)."""
        from auron_tpu_torch.kernels import dispatch as kdispatch
        in_schema = self.child.schema()
        key_dts = tuple(infer_field(e, in_schema, "k").dtype
                        for e in self.group_exprs)
        has_float_sum = any(
            kind == "sum" and fdt in (DataType.FLOAT32, DataType.FLOAT64)
            for spec in self.specs
            for (_f, fdt, kind) in spec.state_fields)
        return kdispatch.select_hash_agg(
            key_dtypes=key_dts, acc_kinds=tuple(self._device_kinds()),
            has_float_sum=has_float_sum, conf=ctx.conf,
            metrics=ctx.metrics_for("kernels"), record=record)

    def _state_batch(self, tbl) -> DeviceBatch:
        """A sorted group table in partial-state layout."""
        keys, accs, num_groups, cap, _h = tbl
        valid = torch.arange(cap, dtype=torch.int32,
                             device=num_groups.device) < num_groups
        cols = list(keys) + [_acc_column(a, valid) for a in accs]
        return DeviceBatch(tuple(cols), num_groups)

    def _state_contributions(self, batch: DeviceBatch):
        n_keys = len(self.group_exprs)
        return (tuple(batch.columns[:n_keys]),
                _state_accs(self.specs, batch, n_keys), batch.row_mask())

    def _merge_hash(self, state, keys, accs, live, elapsed, ht):
        """Fold the batch into the device hash table. A sorted (tbl, None)
        state — the partial-skip decision's compaction — re-enters the
        table as group-partial contributions. Pathological probe overflow
        latches the sort path for the rest of the stream."""
        from auron_tpu_torch.hashtable import HashAggState, HashTableOverflow
        if state is not None and isinstance(state[0], HashAggState):
            hs = state[0]
            pending = [(keys, accs, live)]
        else:
            hs = HashAggState(
                self._device_kinds(),
                initial_capacity=self.initial_capacity,
                load_factor=ht.load_factor,
                max_probe_rounds=ht.max_probe_rounds)
            pending = [self._state_contributions(self._state_batch(lvl))
                       for lvl in (state or ()) if lvl is not None]
            pending.append((keys, accs, live))
        for i, (k2, a2, l2) in enumerate(pending):
            try:
                with timer(elapsed):   # update syncs in its readback
                    hs.update(k2, a2, l2)
            except HashTableOverflow:
                ht.disabled = True
                ht.metrics.counter("hashtable_overflow_fallback").add(1)
                tbl = hs.to_sorted_table()
                sorted_state = None if tbl is None else \
                    (self._shrink_table(self._flip(tbl), hs.count), None)
                for (k3, a3, l3) in pending[i:]:
                    sorted_state = self._merge_sorted(
                        sorted_state, k3, a3, l3, elapsed)
                return sorted_state
        return (hs,)

    @staticmethod
    def _flip(tbl):
        """The hash table's export (raw hashes, EMPTY last) in this
        module's order (hashes ^ int64.min, the sentinel last)."""
        keys, accs, ng, cap, h = tbl
        return keys, accs, ng, cap, h ^ _SIGN

    def _merge(self, state, keys, accs, live, elapsed, ht=None):
        if ht is not None and not ht.disabled:
            return self._merge_hash(state, keys, accs, live, elapsed, ht)
        return self._merge_sorted(state, keys, accs, live, elapsed)

    def _compact(self, state, elapsed):
        """Collapse the state into one table for emit or the skip
        decision; a hash table exports in hash order."""
        if state is None:
            return None
        from auron_tpu_torch.hashtable import HashAggState
        if isinstance(state[0], HashAggState):
            hs = state[0]
            with timer(elapsed):
                tbl = hs.to_sorted_table()
            return None if tbl is None else \
                self._shrink_table(self._flip(tbl), hs.count)
        main, hot = state
        if main is None:
            return hot
        if hot is None:
            return main
        return self._merge_tables(main, hot, elapsed)

    # -- finalize → output batch ---------------------------------------------

    def _emit(self, tbl) -> DeviceBatch:
        keys, accs, num_groups, cap, _h = tbl
        valid = torch.arange(cap, dtype=torch.int32,
                             device=num_groups.device) < num_groups
        out_cols = list(keys)
        if self.mode == "partial":
            out_cols += [_acc_column(a, valid) for a in accs]
            return DeviceBatch(tuple(out_cols), num_groups)
        i = 0
        for spec in self.specs:
            n_state = len(spec.state_fields)
            state_vals = accs[i: i + n_state]
            i += n_state
            fn = spec.fn
            if fn in ("count", "count_star"):
                out_cols.append(PrimitiveColumn(state_vals[0], valid))
            elif spec.result[0] == DataType.STRING:  # validity inside
                out_cols.append(_acc_column(state_vals[0], valid))
            elif fn == "avg":
                out_cols.append(_finish_avg(spec, *state_vals, valid))
            else:   # sum, min, max, first: the second field is 'has'
                v, has = state_vals
                if isinstance(v, tuple) and fn == "sum":
                    # Spark non-ANSI: a sum past its precision is null
                    fits = D.fits_precision(v[0], v[1], spec.result[1])
                    out_cols.append(Decimal128Column(v[0], v[1],
                                                     valid & has & fits))
                elif isinstance(v, tuple):
                    out_cols.append(Decimal128Column(v[0], v[1],
                                                     valid & has))
                else:
                    out_cols.append(PrimitiveColumn(v, valid & has))
        return DeviceBatch(tuple(out_cols), num_groups)

    def _empty_global(self, device) -> DeviceBatch:
        """A global aggregate over empty input: one row, counts 0 and
        every other result null."""
        cols = []
        for spec in self.specs:
            if spec.result[0] == DataType.STRING:
                cols.append(StringColumn(
                    torch.zeros((1, 1), dtype=torch.uint8, device=device),
                    torch.zeros(1, dtype=torch.int32, device=device),
                    torch.zeros(1, dtype=torch.bool, device=device)))
                continue
            if spec.result[0] == DataType.DECIMAL and spec.result[1] > 18:
                cols.append(Decimal128Column(
                    torch.zeros(1, dtype=torch.int64, device=device),
                    torch.zeros(1, dtype=torch.int64, device=device),
                    torch.zeros(1, dtype=torch.bool, device=device)))
                continue
            dt = spec.result[0].to_torch()
            is_count = spec.fn in ("count", "count_star")
            cols.append(PrimitiveColumn(
                torch.zeros(1, dtype=dt, device=device),
                torch.full((1,), is_count, dtype=torch.bool, device=device)))
        return DeviceBatch(tuple(cols), torch.ones((), dtype=torch.int32,
                                                   device=device))

    # -- dense-domain path ----------------------------------------------------

    def _dense_dispatch(self, ctx: ExecContext, device: torch.device):
        """The kernel-selection policy for a ``key_domain`` hint: a dense
        KernelDecision, or None for the general path."""
        if self.key_domain is None or self.mode not in ("partial",
                                                        "complete"):
            return None
        from auron_tpu_torch.kernels import dispatch as kdispatch
        in_schema = self.child.schema()
        key_dts = tuple(infer_dtype(e, in_schema)[0]
                        for e in self.group_exprs)
        value_dts = tuple(infer_dtype(a.arg, in_schema)[0]
                          for a in self.aggs if a.arg is not None)
        decision = kdispatch.select_grouped_agg(
            key_domain=self.key_domain, key_dtypes=key_dts,
            agg_fns=tuple(s.fn for s in self.specs),
            value_dtypes=value_dts, conf=ctx.conf, platform=device.type,
            metrics=ctx.metrics_for("kernels"))
        return decision if decision.is_dense else None

    def _dense_batch_acc(self, agg, spec, batch, k, live, ectx, in_schema,
                         decision, domain, memo):
        """One batch's dense [domain] accumulator tuple for one spec;
        ``memo`` shares one evaluation and one count scatter between
        aggregates over the same argument."""
        from auron_tpu_torch.kernels import grouped_agg as gagg

        def counts_for(valid, ckey):
            cnt = memo.get(ckey)
            if cnt is None:
                cnt = gagg.scatter_reduce("count", k, None, valid, domain,
                                          torch.int64)
                memo[ckey] = cnt
            return cnt

        fn = spec.fn
        if agg.arg is None:   # count_star: live rows per key
            return (counts_for(live, "rows"),)
        akey = repr(agg.arg)
        ev = memo.get(("eval", akey))
        if ev is None:
            v = evaluate(agg.arg, batch, in_schema, ectx)
            ev = (v.col.data, v.validity & live)
            memo[("eval", akey)] = ev
        data, valid = ev
        if fn in ("count", "count_star"):
            return (counts_for(valid, ("cnt", akey)),)
        if fn in ("sum", "avg"):
            sdt = spec.state_fields[0][1].to_torch()
            if sdt.is_floating_point:
                # float sums ride the dispatched dense kernel: one launch
                # yields the (sum, count) pair; per-batch counts are
                # 0/1-exact in f32, cross-batch accumulation is f64/int64.
                # The wrapper, not the plan, picks kernel or plain
                # version, from the device the keys are on.
                v32 = torch.where(valid, data, 0).to(torch.float32)
                c32 = valid.to(torch.float32)
                s, c = gagg.sum_count(k, v32, c32, domain,
                                      backend=decision.kernel)
                return (s.to(torch.float64), c.to(torch.int64))
            s = gagg.scatter_reduce("sum", k, data, valid, domain, sdt)
            return (s, counts_for(valid, ("cnt", akey)))
        if fn in ("min", "max"):
            vdt = spec.state_fields[0][1].to_torch()
            val = gagg.scatter_reduce(fn, k, data, valid, domain, vdt)
            return (val, counts_for(valid, ("cnt", akey)))
        raise NotImplementedError(fn)   # unreachable: dispatch gated

    @staticmethod
    def _dense_merge(spec, a, b):
        if spec.fn in ("min", "max"):
            return (min_max(a[0], b[0], spec.fn), a[1] + b[1])
        return tuple(x + y for x, y in zip(a, b))

    def _dense_domain_stream(self, partition: int, ctx: ExecContext,
                             decision, metrics, batches):
        from auron_tpu_torch.kernels import dispatch as kdispatch
        from auron_tpu_torch.kernels import grouped_agg as gagg
        domain = self.key_domain
        in_schema = self.child.schema()
        ectx = EvalContext(partition_id=partition)
        elapsed = metrics.counter("elapsed_compute")
        kmetrics = ctx.metrics_for("kernels")
        key_dt = infer_dtype(self.group_exprs[0], in_schema)[0].to_torch()

        state = None    # per-spec dense accumulator tuples
        rows = None     # int64[domain] live rows per key (group existence)
        max_k = min_k = saw_null = None   # bound-check scalars (device)
        total_rows = None   # device scalar: read back at emit

        for batch in batches:
            ctx.check_cancelled()
            with timer(elapsed, ctx.device_sync) as t:
                live = batch.row_mask()
                kv = evaluate(self.group_exprs[0], batch, in_schema, ectx)
                kdata = kv.col.data.to(torch.int64)
                key_live = live & kv.validity
                b_null = (live & ~kv.validity).any()
                b_max = torch.where(key_live, kdata, -1).max()
                b_min = torch.where(key_live, kdata, 0).min()
                k = kdata.clamp(0, domain - 1).to(torch.int32)
                memo = {"rows": gagg.scatter_reduce(
                    "count", k, None, live, domain, torch.int64)}
                batch_accs = [
                    self._dense_batch_acc(agg, spec, batch, k, live, ectx,
                                          in_schema, decision, domain, memo)
                    for agg, spec in zip(self.aggs, self.specs)]
                n_b = batch.num_rows.to(torch.int64)
                if state is None:
                    state, rows = batch_accs, memo["rows"]
                    max_k, min_k, saw_null = b_max, b_min, b_null
                    total_rows = n_b
                else:
                    state = [self._dense_merge(spec, s, b)
                             for spec, s, b in zip(self.specs, state,
                                                   batch_accs)]
                    rows = rows + memo["rows"]
                    max_k = torch.maximum(max_k, b_max)
                    min_k = torch.minimum(min_k, b_min)
                    saw_null = saw_null | b_null
                    total_rows = total_rows + n_b
                t.track(rows)
        if state is None:
            return

        touched = rows > 0
        ng_dev = touched.sum(dtype=torch.int32)
        order = torch.argsort(~touched, stable=True)   # touched keys first
        # ONE readback for every control scalar
        ng, mx, mn, nulls, nrows = host_readback(
            [ng_dev, max_k, min_k, saw_null, total_rows])
        kdispatch.record_rows(decision, nrows, kmetrics)
        # the key_domain hint is a plan-time promise: a violation fails
        # the task rather than mis-aggregating
        if nulls:
            raise ValueError(
                "dense grouped-agg: NULL group keys under key_domain="
                f"{domain}; the planner's bound is invalid for this data")
        if mx >= domain or mn < 0:
            raise ValueError(
                f"dense grouped-agg: observed key range [{mn}, {mx}] "
                f"violates the planner's key_domain={domain}")
        cap = max(bucket_rows(max(ng, 1)), 16)
        take = order
        if cap > domain:
            take = torch.cat([order, order.new_zeros(cap - domain)])
        take = take[:cap]
        dev = rows.device
        out_valid = torch.arange(cap, dtype=torch.int32, device=dev) < ng_dev
        keys = (PrimitiveColumn(
            torch.arange(domain, dtype=key_dt, device=dev)[take],
            out_valid),)
        accs = []
        for spec, acc in zip(self.specs, state):
            fn = spec.fn
            if fn in ("count", "count_star"):
                accs.append(acc[0][take])
            elif fn == "avg":
                accs.append(acc[0][take].to(
                    spec.state_fields[0][1].to_torch()))
                accs.append(acc[1][take])
            else:   # sum / min / max: the second state field is 'has'
                accs.append(acc[0][take].to(
                    spec.state_fields[0][1].to_torch()))
                accs.append(acc[1][take] > 0)
        tbl = (keys, tuple(accs), ng_dev, cap,
               torch.zeros(cap, dtype=torch.int64, device=dev))
        yield self._emit(tbl)

    # -- execute --------------------------------------------------------------

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        from auron_tpu_torch.kernels import dispatch as kdispatch
        if ctx.mem_manager is not None:
            raise NotImplementedError(
                "AggOp with a memory manager: the spill tier is not "
                "ported")
        metrics = ctx.metrics_for(self)
        in_schema = self.child.schema()
        conf = ctx.conf
        skip_enabled = (self.mode == "partial" and bool(self.group_exprs)
                        and conf.get(cfg.AGG_PARTIAL_SKIP_ENABLED))
        skip_ratio = conf.get(cfg.AGG_PARTIAL_SKIP_RATIO)
        skip_min_rows = conf.get(cfg.AGG_PARTIAL_SKIP_MIN_ROWS)

        device = self._plan_device()
        decision = self._dense_dispatch(ctx, device)
        if decision is not None:
            # the chosen backend lands in THIS operator's metrics
            kdispatch.record_operator_choice(metrics, decision.kernel)
            return count_output(self._dense_domain_stream(
                partition, ctx, decision, metrics,
                self.child.execute(partition, ctx)), metrics)
        ht_decision = self._hash_dispatch(ctx)
        ht_ctl = _HashPathCtl(ht_decision, metrics) \
            if ht_decision.is_hash else None
        kdispatch.record_operator_choice(
            metrics, "hashtable" if ht_ctl is not None else "sort")
        return count_output(self._general_stream(
            self.child.execute(partition, ctx), ctx, metrics, in_schema,
            ht_ctl, partition, skip_enabled, skip_ratio, skip_min_rows,
            device), metrics)

    def _plan_device(self) -> torch.device:
        """The device the plan runs on: its leftmost scan's."""
        op = self
        while op.children:
            op = op.children[0]
        return torch.device(getattr(op, "device", "cpu"))

    def _general_stream(self, batches, ctx, metrics, in_schema, ht_ctl,
                        partition, skip_enabled, skip_ratio, skip_min_rows,
                        device):
        elapsed = metrics.counter("elapsed_compute")
        ectx = EvalContext(partition_id=partition)
        state = None
        skipping = False
        rows_seen = 0
        skip_pending = skip_enabled
        skipped_rows = metrics.counter("partial_agg_skipped_rows")
        for batch in batches:
            ctx.check_cancelled()
            keys, accs, live = _contribution_columns(
                self.group_exprs, self.mode, self.aggs, self.specs, batch,
                in_schema, ectx)
            if skipping:
                skipped_rows.add(batch.num_rows)
                yield _passthrough_state_batch(keys, accs, live,
                                               batch.num_rows)
                continue
            state = self._merge(state, keys, accs, live, elapsed, ht_ctl)
            if not skip_pending:
                continue
            # decide ONCE when min_rows is crossed, then latch either way
            (n,) = host_readback([batch.num_rows])
            rows_seen += n
            if rows_seen < skip_min_rows:
                continue
            skip_pending = False
            # an exact distinct count needs the levels folded
            tbl = self._compact(state, elapsed)
            state = None if tbl is None else (tbl, None)
            ng = 0 if tbl is None else host_readback([tbl[2]])[0]
            if tbl is not None and ng >= skip_ratio * rows_seen:
                yield self._emit(tbl)
                state = None
                skipping = True
        if skipping:
            return
        final_tbl = self._compact(state, elapsed)
        if final_tbl is None:
            if not self.group_exprs and self.mode in ("final", "complete"):
                # global agg over empty input: one row of neutral results
                yield self._empty_global(device)
            return
        yield self._emit(final_tbl)

    def __repr__(self):
        fns = ",".join(a.fn for a in self.aggs)
        return f"AggOp[{self.mode}: {len(self.group_exprs)} keys; {fns}]"


