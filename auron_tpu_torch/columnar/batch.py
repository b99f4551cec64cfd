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

    def with_validity(self, validity: torch.Tensor) -> "PrimitiveColumn":
        return PrimitiveColumn(self.data, validity)


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

    def with_columns(self, columns) -> "DeviceBatch":
        return DeviceBatch(tuple(columns), self.num_rows)


def _require_primitive(col) -> None:
    if not isinstance(col, PrimitiveColumn):
        raise NotImplementedError(
            f"{type(col).__name__}: the port holds primitive columns only")


def column_nbytes(col: PrimitiveColumn) -> int:
    """Device bytes held by one column (at capacity, incl. padding)."""
    _require_primitive(col)
    return col.data.nbytes + col.validity.nbytes


def batch_nbytes(batch: DeviceBatch) -> int:
    """Device bytes held by the batch (at capacity, incl. padding)."""
    return sum(column_nbytes(c) for c in batch.columns)


def mask_validity(batch: DeviceBatch) -> DeviceBatch:
    """Force validity False on padding rows (defensive normalization)."""
    mask = batch.row_mask()
    return batch.with_columns(
        c.with_validity(c.validity & mask) for c in batch.columns)


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

    The output has the same capacity with num_rows = sum(keep & live).
    The reference argsorts ``where(keep, 0, cap) + row``; the same
    permutation (kept rows by position, then dropped ones by position)
    comes here from two prefix sums and one scatter, without a sort."""
    keep = keep & batch.row_mask()
    cap = batch.capacity
    kept = torch.cumsum(keep, 0)
    n_keep = kept[-1:].reshape(()) if cap else keep.sum()
    dropped = torch.arange(1, cap + 1, device=keep.device) - kept
    dest = torch.where(keep, kept - 1, n_keep + dropped - 1)
    indices = torch.empty(cap, dtype=torch.int64, device=keep.device)
    indices.scatter_(0, dest, torch.arange(cap, device=keep.device))
    return gather_batch(batch, indices, n_keep.to(torch.int32))


def unify_column_widths(cols: Sequence[PrimitiveColumn]
                        ) -> list[PrimitiveColumn]:
    """Pad string widths / list element counts to the max across ``cols``
    so they can be concatenated; primitive columns have neither."""
    for c in cols:
        _require_primitive(c)
    return list(cols)


def concat_columns(a: PrimitiveColumn, b: PrimitiveColumn
                   ) -> PrimitiveColumn:
    """Stack two columns (capacities add)."""
    _require_primitive(a)
    _require_primitive(b)
    return PrimitiveColumn(torch.cat([a.data, b.data]),
                           torch.cat([a.validity, b.validity]))


def resize(batch: DeviceBatch, new_capacity: int) -> DeviceBatch:
    """Grow or shrink capacity (shrink drops padding only if num_rows
    fits — the caller's responsibility)."""
    cap = batch.capacity
    if new_capacity == cap:
        return batch

    def resize_col(c: PrimitiveColumn) -> PrimitiveColumn:
        _require_primitive(c)
        if new_capacity > cap:
            pad = new_capacity - cap
            return PrimitiveColumn(
                torch.nn.functional.pad(c.data, (0, pad)),
                torch.nn.functional.pad(c.validity, (0, pad)))
        return PrimitiveColumn(c.data[:new_capacity],
                               c.validity[:new_capacity])

    return DeviceBatch(tuple(resize_col(c) for c in batch.columns),
                       batch.num_rows)


def concat_batches(a: DeviceBatch, b: DeviceBatch) -> DeviceBatch:
    """Concatenate b's live rows after a's live rows: stacked-capacity
    concat + compaction of live rows; capacity = a's + b's."""
    cap = a.capacity + b.capacity
    stacked = DeviceBatch(
        tuple(concat_columns(ca, cb) for ca, cb in zip(a.columns, b.columns)),
        torch.full((), cap, dtype=torch.int32, device=a.device))
    keep = torch.cat([a.row_mask(), b.row_mask()])
    return compact(stacked, keep)


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
