"""Output partitioners.

The port of ``auron_tpu.parallel.partitioning``: Spark-exact
row → partition assignment. Hash partitioning is murmur3 with seed 42
and pmod, bit-identical to the reference; round-robin numbers rows from
``start``; single sends every row to partition 0; range counts the
sampled bounds a row's sort words reach. The partition-id column is
computed on the batch's device; what happens with it is the exchange's
business. Range bounds are computed on the host, from sampled rows.

A string key's words depend on its width (``ceil(width / 8)`` words),
and a stream's width can grow after the bounds were sampled: the
sampled batches are padded to their widest, ``key_words`` records each
key's word count in the bounds, and a row or a bound with fewer words
than the other is padded with the words of zero bytes, which is what a
wider zero-padded string holds there.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import DeviceBatch, unify_column_widths
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.exprs.eval import EvalContext, evaluate
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.base import host_copy
from auron_tpu_torch.ops.sort import (_SIGN, order_words, sort_key_words,
                                      words_to_uint64)


@dataclass(frozen=True)
class HashPartitioning:
    exprs: tuple
    num_partitions: int

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        ctx = EvalContext()
        cols = [evaluate(e, batch, schema, ctx).col for e in self.exprs]
        h = hashing.murmur3_columns(cols, batch.capacity,
                                    hashing.SPARK_SHUFFLE_SEED,
                                    device=batch.device)
        n = self.num_partitions
        # pmod: torch's % on integers takes the divisor's sign, as
        # Python's and jnp's do, so this is Spark's sign-safe modulo
        return ((h % n) + n) % n


@dataclass(frozen=True)
class RoundRobinPartitioning:
    num_partitions: int
    start: int = 0

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        idx = torch.arange(batch.capacity, dtype=torch.int32,
                           device=batch.device) + self.start
        return idx % self.num_partitions


@dataclass(frozen=True)
class SinglePartitioning:
    num_partitions: int = 1

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        return torch.zeros(batch.capacity, dtype=torch.int32,
                           device=batch.device)


def _key_columns(batch: DeviceBatch, schema: Schema, sort_orders) -> list:
    ctx = EvalContext()
    return [evaluate(so.expr, batch, schema, ctx).col for so in sort_orders]


def _value_words(col) -> int:
    """Order words of one key's value (its null-rank word excluded)."""
    return len(order_words(col, True, True))


def key_word_counts(sample_batches, sort_orders, schema: Schema) -> tuple:
    """Each key's value-word count in bounds sampled from these batches
    (a string key's at the widest sampled width)."""
    cols = [_key_columns(b, schema, sort_orders) for b in sample_batches]
    if not cols:
        return ()
    return tuple(_value_words(unify_column_widths(list(per_key))[0])
                 for per_key in zip(*cols))


@dataclass(frozen=True)
class RangePartitioning:
    """Range partitioning over sampled bounds. ``bounds`` is a host-side
    tuple of word tuples, one per boundary, in the reference's uint64
    words (python ints); the exchange samples them from its input when
    the plan leaves them empty. ``key_words`` is each key's value-word
    count in the bounds; empty means the rows' own."""

    sort_orders: tuple     # tuple[ir.SortOrder]
    num_partitions: int
    bounds: tuple          # tuple of word tuples, len <= num_partitions - 1
    key_words: tuple = field(default=(), repr=False)

    def _aligned(self, cols) -> tuple[list, list]:
        """(row words, per-key word slices of a bound, each with the
        uint64 word that pads it) at a common count per key."""
        row, slices, off = [], [], 0
        for i, (col, so) in enumerate(zip(cols, self.sort_orders)):
            words = sort_key_words([col], [(so.ascending, so.nulls_first)])
            n_row = len(words) - 1
            n_bound = self.key_words[i] if self.key_words else n_row
            n = max(n_row, n_bound)
            if n > n_row:
                # a valid row's missing words are zero bytes; a null's 0
                fill = _SIGN if so.ascending else ~_SIGN
                pad = torch.where(col.validity, fill, _SIGN)
                words = words + [pad] * (n - n_row)
            row.extend(words)
            zero_word = 0 if so.ascending else (1 << 64) - 1
            null_rank = 0 if so.nulls_first else 1
            slices.append((off, n_bound, n, null_rank, zero_word))
            off += 1 + n_bound
        return row, slices

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        """The number of bounds each row's word tuple is >= to,
        lexicographically."""
        cap = batch.capacity
        pid = torch.zeros(cap, dtype=torch.int32, device=batch.device)
        if not self.bounds:
            return pid
        row_words, slices = self._aligned(
            _key_columns(batch, schema, self.sort_orders))
        for bound in self.bounds:
            words = []
            for off, n_bound, n, null_rank, zero_word in slices:
                rank = bound[off]
                value = list(bound[off + 1: off + 1 + n_bound])
                value += [0 if rank == null_rank else zero_word] * (
                    n - n_bound)
                words += [rank] + value
            ge = torch.zeros(cap, dtype=torch.bool, device=batch.device)
            eq = torch.ones(cap, dtype=torch.bool, device=batch.device)
            for w, bw in zip(row_words, words):
                b = int(bw) - (1 << 63)     # the uint64 word as int64
                ge = ge | (eq & (w > b))
                eq = eq & (w == b)
            pid = pid + (ge | eq).to(torch.int32)
        return pid.clamp(max=self.num_partitions - 1)


def compute_range_bounds(sample_batches, sort_orders, schema: Schema,
                         num_partitions: int) -> tuple:
    """Bounds from sampled batches, on the host: the live rows' words
    (one device → host copy), sorted lexicographically with
    ``np.lexsort``, evenly spaced boundaries, equal neighbours dropped.
    The word tuples are the reference's uint64 values; string keys are
    padded to their widest sampled width first."""
    orders = [(so.ascending, so.nulls_first) for so in sort_orders]
    cols = [_key_columns(b, schema, sort_orders) for b in sample_batches]
    cols = list(zip(*[unify_column_widths(list(per_key))
                      for per_key in zip(*cols)])) if cols else []
    mats = []
    for batch, key_cols in zip(sample_batches, cols):
        words = sort_key_words(list(key_cols), orders)
        mats.append(torch.stack(
            words + [batch.row_mask().to(torch.int64)], dim=1))
    if not mats:
        return ()
    host = host_copy(torch.cat(mats)).numpy()
    rows = words_to_uint64(host[host[:, -1] == 1, :-1])
    n = rows.shape[0]
    if n == 0:
        return ()
    order = np.lexsort(tuple(rows[:, i]
                             for i in range(rows.shape[1] - 1, -1, -1)))
    rows = rows[order]
    out = []
    for k in range(1, num_partitions):
        b = tuple(int(x) for x in rows[min(n - 1, (k * n) // num_partitions)])
        # equal bounds (degenerate distributions) collapse
        if not out or b != out[-1]:
            out.append(b)
    return tuple(out)
