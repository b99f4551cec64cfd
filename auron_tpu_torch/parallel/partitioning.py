"""Output partitioners.

The port of ``auron_tpu.parallel.partitioning``: Spark-exact
row → partition assignment. Hash partitioning is murmur3 with seed 42
and pmod, bit-identical to the reference; round-robin numbers rows from
``start``; single sends every row to partition 0. The partition-id
column is computed on the batch's device; what happens with it is the
exchange's business. Range partitioning comes with the sort slice.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from auron_tpu_torch.columnar.batch import DeviceBatch
from auron_tpu_torch.columnar.schema import Schema
from auron_tpu_torch.exprs.eval import EvalContext, evaluate
from auron_tpu_torch.ops import hashing


@dataclass(frozen=True)
class HashPartitioning:
    exprs: tuple
    num_partitions: int

    def partition_ids(self, batch: DeviceBatch,
                      schema: Schema) -> torch.Tensor:
        ctx = EvalContext()
        cols = [evaluate(e, batch, schema, ctx).col for e in self.exprs]
        h = hashing.murmur3_columns(cols, batch.capacity,
                                    hashing.SPARK_SHUFFLE_SEED)
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
