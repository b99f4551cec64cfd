"""Output partitioners.

The port of ``auron_tpu.parallel.partitioning``: Spark-exact
row → partition assignment. Hash partitioning is murmur3 with seed 42
and pmod, bit-identical to the reference; round-robin numbers rows from
``start``; single sends every row to partition 0; range counts the
sampled bounds a row's sort words reach. The partition-id column is
computed on the batch's device; what happens with it is the exchange's
business. Range bounds are computed on the host, from sampled rows.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.exprs.eval import EvalContext, evaluate
from auron_tpu_torch.ops import hashing
from auron_tpu_torch.ops.base import host_copy
from auron_tpu_torch.ops.sort import sort_key_words, words_to_uint64


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


def _range_words(batch: DeviceBatch, schema: Schema,
                 sort_orders) -> list[torch.Tensor]:
    """Each row's sort words (``ops.sort.sort_key_words``: int64 words
    in uint64 order) for the range's sort orders."""
    ctx = EvalContext()
    cols = [evaluate(so.expr, batch, schema, ctx).col for so in sort_orders]
    return sort_key_words(cols, [(so.ascending, so.nulls_first)
                                 for so in sort_orders])


@dataclass(frozen=True)
class RangePartitioning:
    """Range partitioning over sampled bounds. ``bounds`` is a host-side
    tuple of word tuples, one per boundary, in the reference's uint64
    words (python ints); the exchange samples them from its input when
    the plan leaves them empty."""

    sort_orders: tuple     # tuple[ir.SortOrder]
    num_partitions: int
    bounds: tuple          # tuple of word tuples, len <= num_partitions - 1

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        """The number of bounds each row's word tuple is >= to,
        lexicographically."""
        cap = batch.capacity
        pid = torch.zeros(cap, dtype=torch.int32, device=batch.device)
        if not self.bounds:
            return pid
        row_words = _range_words(batch, schema, self.sort_orders)
        for bound in self.bounds:
            ge = torch.zeros(cap, dtype=torch.bool, device=batch.device)
            eq = torch.ones(cap, dtype=torch.bool, device=batch.device)
            for w, bw in zip(row_words, bound):
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
    The word tuples are the reference's uint64 values."""
    mats = []
    for batch in sample_batches:
        words = _range_words(batch, schema, list(sort_orders))
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
