"""Device-resident columnar batches, primitive columns only.

The port of ``auron_tpu.columnar.batch``: every column is padded to a
static ``capacity``; the true row count is a 0-d int32 tensor on the
batch's device (``num_rows``), so ``row_mask()`` is computed on the device
and nothing on the hot path waits for the host. Validity is a dense bool
mask. String, list, map, struct and decimal128 columns come with the
slices that need them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch


@dataclass(frozen=True)
class PrimitiveColumn:
    """Fixed-width column: data[capacity] + validity[capacity]."""

    data: torch.Tensor
    validity: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.data.shape[0]


@dataclass(frozen=True)
class DeviceBatch:
    """A bundle of equal-capacity columns plus the dynamic row count."""

    columns: tuple[PrimitiveColumn, ...]
    num_rows: torch.Tensor  # int32 0-d, <= capacity

    @property
    def capacity(self) -> int:
        if not self.columns:
            return 0
        return self.columns[0].capacity

    @property
    def device(self) -> torch.device:
        return self.num_rows.device

    def row_mask(self) -> torch.Tensor:
        """bool[capacity]: True for live rows."""
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.num_rows

    def column(self, i: int) -> PrimitiveColumn:
        return self.columns[i]


def batch_nbytes(batch: DeviceBatch) -> int:
    """Device bytes held by the batch (at capacity, incl. padding)."""
    return sum(c.data.nbytes + c.validity.nbytes for c in batch.columns)


def gather_column(col: PrimitiveColumn, indices: torch.Tensor,
                  valid: torch.Tensor) -> PrimitiveColumn:
    """Take rows ``indices`` from ``col``; rows where ``valid`` is False
    become null."""
    return PrimitiveColumn(col.data[indices], col.validity[indices] & valid)


def gather_batch(batch: DeviceBatch, indices: torch.Tensor,
                 num_rows: torch.Tensor) -> DeviceBatch:
    """Take ``indices`` (shape [new_capacity]) from every column; entries
    with position >= num_rows are padding."""
    new_cap = indices.shape[0]
    valid = torch.arange(new_cap, dtype=torch.int32,
                         device=indices.device) < num_rows
    return DeviceBatch(
        tuple(gather_column(c, indices, valid) for c in batch.columns),
        num_rows.to(torch.int32))


def compact(batch: DeviceBatch, keep: torch.Tensor) -> DeviceBatch:
    """Stable-compact live rows where ``keep`` is True to the front.

    The output has the same capacity with num_rows = sum(keep & live)."""
    keep = keep & batch.row_mask()
    cap = batch.capacity
    n_keep = keep.sum(dtype=torch.int32)
    # stable partition: kept rows by position, then dropped ones by position
    order_keys = torch.where(keep, 0, cap) + torch.arange(
        cap, dtype=torch.int32, device=keep.device)
    indices = torch.argsort(order_keys, stable=True)
    return gather_batch(batch, indices, n_keep)


def batch_from_numpy(columns: Sequence[tuple[np.ndarray, np.ndarray]],
                     num_rows: int, device) -> DeviceBatch:
    """A batch from ``(data, validity)`` numpy pairs — the same arrays a
    test hands to the JAX package's ``DeviceBatch``."""
    dev = torch.device(device)
    cols = tuple(
        PrimitiveColumn(torch.from_numpy(np.ascontiguousarray(d)).to(dev),
                        torch.from_numpy(np.ascontiguousarray(
                            v, dtype=np.bool_)).to(dev))
        for d, v in columns)
    return DeviceBatch(cols, torch.tensor(num_rows, dtype=torch.int32,
                                          device=dev))


def batch_to_numpy(batch: DeviceBatch
                   ) -> tuple[list[tuple[np.ndarray, np.ndarray]], int]:
    """``([(data, validity), ...], num_rows)`` on the host."""
    cols = [(c.data.cpu().numpy(), c.validity.cpu().numpy())
            for c in batch.columns]
    return cols, int(batch.num_rows)
