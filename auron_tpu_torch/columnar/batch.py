"""Device-resident columnar batches: primitive, string and decimal128
columns.

The port of ``auron_tpu.columnar.batch``: every column is padded to a
static ``capacity``; the true row count is a 0-d int32 tensor on the
batch's device (``num_rows``), so ``row_mask()`` is computed on the device
and nothing on the hot path waits for the host. Validity is a dense bool
mask. A string column is a zero-padded byte matrix ``chars[capacity,
width]`` with a length per row; its width is a bucket
(``utils.shapes.bucket_string_width``), and columns of different widths
are padded to the wider one before they are concatenated. A decimal of
precision 19..38 is a ``Decimal128Column`` (``columnar/decimal128.py``):
two int64 limbs and a validity. List, map and struct columns (ROADMAP
item 16f) are not ported: a column op given one raises
``NotImplementedError``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence, Union

import numpy as np
import torch

from auron_tpu_torch.columnar.decimal128 import Decimal128Column


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
class StringColumn:
    """Fixed-width string column: chars[capacity, width] (zero padded),
    lens[capacity], validity[capacity]."""

    chars: torch.Tensor     # uint8[capacity, width]
    lens: torch.Tensor      # int32[capacity]
    validity: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.chars.shape[0]

    @property
    def width(self) -> int:
        return self.chars.shape[1]

    def with_validity(self, validity: torch.Tensor) -> "StringColumn":
        return StringColumn(self.chars, self.lens, validity)


Column = Union[PrimitiveColumn, StringColumn, Decimal128Column]


@dataclass(frozen=True)
class DeviceBatch:
    """A bundle of equal-capacity columns plus the dynamic row count."""

    columns: tuple[Column, ...]
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

    def column(self, i: int) -> Column:
        return self.columns[i]

    def with_columns(self, columns) -> "DeviceBatch":
        return DeviceBatch(tuple(columns), self.num_rows)


def _require_ported(col) -> None:
    """Raise for the column types the port does not carry yet."""
    if not isinstance(col, (PrimitiveColumn, StringColumn,
                            Decimal128Column)):
        raise NotImplementedError(
            f"{type(col).__name__}: the port carries primitive, string "
            "and decimal128 columns only (list, map and struct: ROADMAP "
            "item 16f-c)")


def column_nbytes(col: Column) -> int:
    """Device bytes held by one column (at capacity, incl. padding)."""
    _require_ported(col)
    if isinstance(col, StringColumn):
        return col.chars.nbytes + col.lens.nbytes + col.validity.nbytes
    if isinstance(col, Decimal128Column):
        return col.hi.nbytes + col.lo.nbytes + col.validity.nbytes
    return col.data.nbytes + col.validity.nbytes


def batch_nbytes(batch: DeviceBatch) -> int:
    """Device bytes held by the batch (at capacity, incl. padding)."""
    return sum(column_nbytes(c) for c in batch.columns)


def mask_validity(batch: DeviceBatch) -> DeviceBatch:
    """Force validity False on padding rows (defensive normalization)."""
    mask = batch.row_mask()
    return batch.with_columns(
        c.with_validity(c.validity & mask) for c in batch.columns)


def gather_column(col: Column, indices: torch.Tensor,
                  valid: torch.Tensor) -> Column:
    """Take rows ``indices`` from ``col``; rows where ``valid`` is False
    become null (a string's length is zeroed there too; a null row that
    ``valid`` keeps may still hold its chars)."""
    _require_ported(col)
    if isinstance(col, StringColumn):
        return StringColumn(col.chars[indices],
                            torch.where(valid, col.lens[indices], 0),
                            col.validity[indices] & valid)
    if isinstance(col, Decimal128Column):
        return Decimal128Column(col.hi[indices], col.lo[indices],
                                col.validity[indices] & valid)
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


def pad_string_width(col: StringColumn, width: int) -> StringColumn:
    """Zero-pad a string column's char matrix out to ``width`` bytes per
    row."""
    if col.width >= width:
        return col
    return StringColumn(
        torch.nn.functional.pad(col.chars, (0, width - col.width)),
        col.lens, col.validity)


def unify_column_widths(cols: Sequence[Column]) -> list[Column]:
    """Pad string widths to the max across ``cols`` so they can be
    concatenated (capacities may differ; widths must not)."""
    for c in cols:
        _require_ported(c)
    if cols and isinstance(cols[0], StringColumn):
        w = max(c.width for c in cols)
        return [pad_string_width(c, w) for c in cols]
    return list(cols)


def concat_columns(a: Column, b: Column) -> Column:
    """Stack two columns (capacities add); string widths are unified
    first."""
    a, b = unify_column_widths([a, b])
    if isinstance(a, StringColumn):
        return StringColumn(torch.cat([a.chars, b.chars]),
                            torch.cat([a.lens, b.lens]),
                            torch.cat([a.validity, b.validity]))
    if isinstance(a, Decimal128Column):
        return Decimal128Column(torch.cat([a.hi, b.hi]),
                                torch.cat([a.lo, b.lo]),
                                torch.cat([a.validity, b.validity]))
    return PrimitiveColumn(torch.cat([a.data, b.data]),
                           torch.cat([a.validity, b.validity]))


def resize(batch: DeviceBatch, new_capacity: int) -> DeviceBatch:
    """Grow or shrink capacity (shrink drops padding only if num_rows
    fits — the caller's responsibility)."""
    cap = batch.capacity
    if new_capacity == cap:
        return batch

    def fit(t: torch.Tensor) -> torch.Tensor:
        if new_capacity > cap:
            pad = (0, 0) * (t.dim() - 1) + (0, new_capacity - cap)
            return torch.nn.functional.pad(t, pad)
        return t[:new_capacity]

    def resize_col(c: Column) -> Column:
        _require_ported(c)
        if isinstance(c, StringColumn):
            return StringColumn(fit(c.chars), fit(c.lens), fit(c.validity))
        if isinstance(c, Decimal128Column):
            return Decimal128Column(fit(c.hi), fit(c.lo), fit(c.validity))
        return PrimitiveColumn(fit(c.data), fit(c.validity))

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


def batch_from_numpy(columns: Sequence[tuple], num_rows: int,
                     device) -> DeviceBatch:
    """A batch from numpy tuples — the same arrays a test hands to the
    JAX package's ``DeviceBatch``: ``(data, validity)`` for a primitive
    column, ``(chars, lens, validity)`` for a string column (its chars
    two-dimensional) and ``(hi, lo, validity)`` for a decimal128 one."""
    dev = torch.device(device)

    def t(a, dtype=None):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    def column(c):
        if len(c) == 2:
            return PrimitiveColumn(t(c[0]), t(c[1], np.bool_))
        if np.ndim(c[0]) == 2:
            return StringColumn(t(c[0], np.uint8), t(c[1], np.int32),
                                t(c[2], np.bool_))
        return Decimal128Column(t(c[0], np.int64), t(c[1], np.int64),
                                t(c[2], np.bool_))

    cols = tuple(column(c) for c in columns)
    return DeviceBatch(cols, torch.tensor(num_rows, dtype=torch.int32,
                                          device=dev))


def batch_to_numpy(batch: DeviceBatch) -> tuple[list[tuple], int]:
    """``([(data, validity), (chars, lens, validity) or (hi, lo,
    validity), ...], num_rows)`` on the host."""
    def arrays(c):
        if isinstance(c, StringColumn):
            return (c.chars, c.lens, c.validity)
        if isinstance(c, Decimal128Column):
            return (c.hi, c.lo, c.validity)
        return (c.data, c.validity)

    cols = [tuple(a.cpu().numpy() for a in arrays(c))
            for c in batch.columns]
    return cols, int(batch.num_rows)
