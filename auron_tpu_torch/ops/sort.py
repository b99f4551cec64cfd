"""Sort operator: a full sort, or the first ``fetch`` rows (top-k).

The port of ``auron_tpu.ops.sort`` for primitive, string, decimal and
struct keys; any column, nested ones included, rides along. A stage
breaker: the operator buffers its partition's batches, concatenates
them once, normalizes every sort key into order-preserving 64-bit words
and runs one stable argsort per word, least significant first, then one
by a leading liveness word that sends padding rows to the end. Nulls
first or last and ascending or descending live in the words themselves:

  signed integer → its value, sign-flipped
  float          → canonicalized (-0.0 → 0.0, one NaN, the largest),
                   then all bits flipped if negative, else the sign bit
  string         → its zero-padded bytes as big-endian 64-bit words,
                   ceil(width / 8) of them (a prefix sorts first)
  decimal(p>18)  → two words: the high limb sign-flipped, then the low
                   limb as unsigned (a narrower decimal is its int64)
  struct         → per field, its own null-rank word (a null field
                   first) and its ascending words, nulls zeroed
  descending     → bitwise NOT of the word
  null rank      → one leading word per key: 0/1 by nulls_first

The reference's words are uint64. PyTorch's uint64 is a limited-support
dtype (no argsort, comparison or searchsorted on CUDA), so each word is
held as the int64 ``u ^ (1 << 63)``: signed order is then unsigned
order, and ``~`` commutes with the XOR, so a descending word stays
``~w``. ``words_to_uint64`` maps them back.

There is no spill: the port has no memory manager yet, so SortOp always
takes the reference's in-memory branch, and a context that carries a
memory manager raises ``NotImplementedError``, as AggOp's and the
exchange's do. List and map keys raise, as in the reference. The one
host sync is the top-k's read of the sorted
row count, through ``host_readback``.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import (Decimal128Column, DeviceBatch,
                                            PrimitiveColumn, StringColumn,
                                            StructColumn, compact,
                                            concat_many, gather_batch,
                                            resize)
from auron_tpu_torch.columnar.schema import DataType, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import EvalContext, evaluate, infer_dtype
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      host_readback, timer)
from auron_tpu_torch.ops.hashing import canonicalize_float
from auron_tpu_torch.ops.strings import string_be_words
from auron_tpu_torch.utils.shapes import bucket_rows

#: flips the sign bit: int64 order of ``u ^ _SIGN`` is uint64 order of u
_SIGN = torch.iinfo(torch.int64).min
_LOW32 = 0xFFFFFFFF

#: sort key types the port has words for
_SORTABLE = frozenset({DataType.BOOL, DataType.INT8, DataType.INT16,
                       DataType.INT32, DataType.INT64, DataType.FLOAT32,
                       DataType.FLOAT64, DataType.DATE32,
                       DataType.TIMESTAMP_US, DataType.STRING,
                       DataType.DECIMAL, DataType.STRUCT})


def _uword(u: int) -> int:
    """The int64 word of the uint64 value ``u``."""
    return u - (1 << 63)


def words_to_uint64(w) -> np.ndarray:
    """The reference's uint64 words of int64 words on the host."""
    return np.ascontiguousarray(w, np.int64).view(np.uint64) \
        ^ np.uint64(1 << 63)


def order_words(col, ascending: bool,
                nulls_first: bool) -> list[torch.Tensor]:
    """One sort key column as order-preserving int64 words, most
    significant first (the null-rank word is the caller's)."""
    if isinstance(col, StructColumn):
        # fieldwise: each field's null-rank word (a null field first, as
        # Spark's InterpretedOrdering), then its words, nulls zeroed
        words = []
        for ch in col.children:
            cv = ch.validity & col.validity
            words.append(torch.where(cv, _uword(1), _uword(0)))
            words.extend(torch.where(cv, w, _uword(0))
                         for w in order_words(ch, True, True))
        return words if ascending else [~w for w in words]
    if isinstance(col, StringColumn):
        be = string_be_words(col.chars)
        words = [be[:, i] for i in range(be.shape[1])]
        return words if ascending else [~w for w in words]
    if isinstance(col, Decimal128Column):
        # signed 128-bit order: the reference's uint64 words hi ^ 2^63
        # and lo, whose int64 words are hi and lo ^ 2^63
        words = [col.hi, col.lo ^ _SIGN]
        return words if ascending else [~w for w in words]
    if not isinstance(col, PrimitiveColumn):
        raise NotImplementedError(
            f"sort keys of {type(col).__name__} are not supported")
    d = col.data
    if d.dtype == torch.bool:
        w = d.to(torch.int64) ^ _SIGN
    elif d.dtype in (torch.int8, torch.int16, torch.int32, torch.int64):
        # the uint64 u = v ^ 2^63, whose int64 word is v itself
        w = d.to(torch.int64)
    elif d.dtype == torch.float32:
        # Spark ordering: -0.0 == 0.0 and every NaN the same (greatest)
        # value, so keys equal under Spark get identical words
        b = canonicalize_float(d).view(torch.int32).to(torch.int64) & _LOW32
        u = torch.where((b >> 31) == 1, (~b) & _LOW32, b | 0x80000000)
        w = u ^ _SIGN
    elif d.dtype == torch.float64:
        b = canonicalize_float(d).view(torch.int64)
        # u = ~b for negatives, b | 2^63 otherwise; as int64 words
        w = torch.where(b < 0, ~b ^ _SIGN, b)
    else:
        raise NotImplementedError(f"sort words for {d.dtype}")
    return [w if ascending else ~w]


def sort_key_words(key_cols, orders) -> list[torch.Tensor]:
    """Every order word of a composite key, most significant first: per
    key one null-rank word, then its value words (0 on null rows, so
    nulls compare equal)."""
    out: list[torch.Tensor] = []
    for col, (asc, nf) in zip(key_cols, orders):
        valid = col.validity
        out.append(torch.where(valid, _uword(1 if nf else 0),
                               _uword(0 if nf else 1)))
        out.extend(torch.where(valid, w, _uword(0))
                   for w in order_words(col, asc, nf))
    return out


def sort_permutation(batch: DeviceBatch, key_cols,
                     orders) -> torch.Tensor:
    """Stable multi-key sort permutation (int64[capacity]); ``orders``
    is ``[(ascending, nulls_first)]`` aligned with ``key_cols``. Padding
    rows sort to the end. One stable argsort per word, least significant
    first, as the reference chains them, so ties keep input order."""
    live = batch.row_mask()
    perm = torch.arange(batch.capacity, device=live.device)
    for w in reversed(sort_key_words(key_cols, orders)):
        perm = perm[torch.argsort(w[perm], stable=True)]
    lead = (~live).to(torch.int8)
    return perm[torch.argsort(lead[perm], stable=True)]


def sort_batch(batch: DeviceBatch, sort_exprs, schema: Schema
               ) -> DeviceBatch:
    """``batch`` in sort order: the live rows first, then padding."""
    ctx = EvalContext()
    key_cols = [evaluate(s.expr, batch, schema, ctx).col
                for s in sort_exprs]
    orders = [(s.ascending, s.nulls_first) for s in sort_exprs]
    perm = sort_permutation(batch, key_cols, orders)
    return gather_batch(batch, perm, batch.num_rows)


def _concat_all(batches: list[DeviceBatch]) -> DeviceBatch:
    """Concatenate buffered batches into one batch of capacity
    ``bucket_rows(sum of capacities)``, live rows first in input order.
    The reference concatenates pairwise; here each column is
    concatenated once and compacted once, with the same result."""
    stacked_cap = sum(b.capacity for b in batches)
    total_cap = bucket_rows(stacked_cap)
    cols = [concat_many([b.columns[i] for b in batches])
            for i in range(len(batches[0].columns))]
    live = torch.cat([b.row_mask() for b in batches])
    dev = batches[0].device
    stacked = DeviceBatch(tuple(cols), torch.full(
        (), stacked_cap, dtype=torch.int32, device=dev))
    compacted = compact(stacked, live)
    return resize(compacted, total_cap) if total_cap >= stacked_cap \
        else compacted


class SortOp(PhysicalOp):
    name = "sort"

    def __init__(self, child: PhysicalOp, sort_exprs: list[ir.SortOrder],
                 fetch: Optional[int] = None):
        self.child = child
        self.sort_exprs = tuple(sort_exprs)
        self.fetch = fetch
        in_schema = child.schema()
        for s in self.sort_exprs:
            dt = infer_dtype(s.expr, in_schema)[0]
            if dt not in _SORTABLE:
                raise NotImplementedError(
                    f"sort key of type {dt.value}: list and map keys are "
                    "not supported")

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self.child.schema()

    def _limit(self, stream):
        remaining = self.fetch
        for out in stream:
            if remaining is None:
                yield out
                continue
            if remaining <= 0:
                return
            (n,) = host_readback([out.num_rows])
            if n > remaining:
                out = DeviceBatch(out.columns, torch.full(
                    (), remaining, dtype=torch.int32, device=out.device))
            remaining -= n
            yield out
            if remaining <= 0:
                return

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        if ctx.mem_manager is not None:
            raise NotImplementedError(
                "SortOp with a memory manager: the sort's spill is not "
                "ported")
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")
        in_schema = self.child.schema()

        def in_mem_stream(batches):
            if not batches:
                return
            with timer(elapsed, sync=ctx.device_sync) as t:
                merged = _concat_all(batches) if len(batches) > 1 \
                    else batches[0]
                out = t.track(sort_batch(merged, self.sort_exprs,
                                         in_schema))
            yield out

        def stream():
            collected = []
            for b in self.child.execute(partition, ctx):
                ctx.check_cancelled()
                collected.append(b)
            yield from self._limit(in_mem_stream(collected))

        return count_output(stream(), metrics)

    def __repr__(self):
        return f"SortOp[{len(self.sort_exprs)} keys, fetch={self.fetch}]"
