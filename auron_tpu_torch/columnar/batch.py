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
two int64 limbs and a validity.

Nested columns are padded too: a list is a ``[capacity, max_elems]``
matrix with element validity, a length and a row validity per row
(``ListColumn``; ``StringListColumn`` adds a width axis and element
lengths), a map two such matrices sharing one length column
(``MapColumn``, ``StringMapColumn``; a list<decimal(p > 18)> rides the
``MapColumn`` carrier with hi → keys and lo → values), and a struct its
child columns plus a row validity (``StructColumn``). A null list has
``validity`` False and length 0; an empty list is valid with length 0;
a list that holds nulls is valid with some ``elem_valid`` False.
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


@dataclass(frozen=True)
class ListColumn:
    """Padded list-of-primitive column: values[capacity, max_elems],
    element validity, list lengths and row validity (a null row is a
    null list)."""

    values: torch.Tensor      # [capacity, max_elems]
    elem_valid: torch.Tensor  # bool[capacity, max_elems]
    lens: torch.Tensor        # int32[capacity]
    validity: torch.Tensor    # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.values.shape[0]

    @property
    def max_elems(self) -> int:
        return self.values.shape[1]

    def with_validity(self, validity: torch.Tensor) -> "ListColumn":
        return ListColumn(self.values, self.elem_valid, self.lens, validity)


@dataclass(frozen=True)
class StringListColumn:
    """Padded list-of-string column: chars[capacity, max_elems, width]
    with a byte length per element."""

    chars: torch.Tensor       # uint8[capacity, max_elems, width]
    slens: torch.Tensor       # int32[capacity, max_elems]
    elem_valid: torch.Tensor  # bool[capacity, max_elems]
    lens: torch.Tensor        # int32[capacity]
    validity: torch.Tensor    # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.chars.shape[0]

    @property
    def max_elems(self) -> int:
        return self.chars.shape[1]

    @property
    def width(self) -> int:
        return self.chars.shape[2]

    def with_validity(self, validity: torch.Tensor) -> "StringListColumn":
        return StringListColumn(self.chars, self.slens, self.elem_valid,
                                self.lens, validity)


@dataclass(frozen=True)
class StringMapColumn:
    """Padded map<string, string> column: key and value char tensors
    sharing one length column. Map keys are never null, so only values
    carry an element validity."""

    kchars: torch.Tensor     # uint8[capacity, max_elems, kwidth]
    kslens: torch.Tensor     # int32[capacity, max_elems]
    vchars: torch.Tensor     # uint8[capacity, max_elems, vwidth]
    vslens: torch.Tensor     # int32[capacity, max_elems]
    val_valid: torch.Tensor  # bool[capacity, max_elems]
    lens: torch.Tensor       # int32[capacity]
    validity: torch.Tensor   # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.kchars.shape[0]

    @property
    def max_elems(self) -> int:
        return self.kchars.shape[1]

    def with_validity(self, validity: torch.Tensor) -> "StringMapColumn":
        return StringMapColumn(self.kchars, self.kslens, self.vchars,
                               self.vslens, self.val_valid, self.lens,
                               validity)


@dataclass(frozen=True)
class MapColumn:
    """Padded map column: key and value matrices sharing one length
    column (also the carrier of entry lists and of list<decimal(p >
    18)>, hi → keys, lo → values)."""

    keys: torch.Tensor       # [capacity, max_elems]
    values: torch.Tensor     # [capacity, max_elems]
    val_valid: torch.Tensor  # bool[capacity, max_elems]
    lens: torch.Tensor       # int32[capacity]
    validity: torch.Tensor   # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.keys.shape[0]

    @property
    def max_elems(self) -> int:
        return self.keys.shape[1]

    def with_validity(self, validity: torch.Tensor) -> "MapColumn":
        return MapColumn(self.keys, self.values, self.val_valid, self.lens,
                         validity)


@dataclass(frozen=True)
class StructColumn:
    """Struct column: its child columns and a row validity; field names
    and types live in the schema."""

    children: tuple         # tuple[Column, ...]
    validity: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.validity.shape[0]

    def with_validity(self, validity: torch.Tensor) -> "StructColumn":
        return StructColumn(self.children, validity)


Column = Union[PrimitiveColumn, StringColumn, Decimal128Column, ListColumn,
               StringListColumn, MapColumn, StringMapColumn, StructColumn]

#: the tensors of each column class, in field order; the row axis is
#: axis 0 of each, the rest is per-row layout
_TENSORS = {
    PrimitiveColumn: ("data", "validity"),
    StringColumn: ("chars", "lens", "validity"),
    Decimal128Column: ("hi", "lo", "validity"),
    ListColumn: ("values", "elem_valid", "lens", "validity"),
    StringListColumn: ("chars", "slens", "elem_valid", "lens", "validity"),
    MapColumn: ("keys", "values", "val_valid", "lens", "validity"),
    StringMapColumn: ("kchars", "kslens", "vchars", "vslens", "val_valid",
                      "lens", "validity"),
}


def column_tensors(col: Column) -> tuple:
    """Every tensor of a column, children's first for a struct."""
    if isinstance(col, StructColumn):
        return tuple(t for c in col.children for t in column_tensors(c)) \
            + (col.validity,)
    return tuple(getattr(col, n) for n in _TENSORS[type(col)])


def map_rows(col: Column, fn) -> Column:
    """``col`` with ``fn`` applied to each of its tensors (row axis
    first): a slice, a pad or a gather of rows."""
    if isinstance(col, StructColumn):
        return StructColumn(tuple(map_rows(c, fn) for c in col.children),
                            fn(col.validity))
    return type(col)(*(fn(getattr(col, n)) for n in _TENSORS[type(col)]))


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


def column_nbytes(col: Column) -> int:
    """Device bytes held by one column (at capacity, incl. padding)."""
    return sum(t.nbytes for t in column_tensors(col))


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
    become null (a string's or a list's length is zeroed there too, and
    a list's element validity; a null row that ``valid`` keeps may still
    hold its chars)."""
    if isinstance(col, ListColumn):
        return ListColumn(col.values[indices],
                          col.elem_valid[indices] & valid[:, None],
                          torch.where(valid, col.lens[indices], 0),
                          col.validity[indices] & valid)
    if isinstance(col, StringListColumn):
        return StringListColumn(col.chars[indices], col.slens[indices],
                                col.elem_valid[indices] & valid[:, None],
                                torch.where(valid, col.lens[indices], 0),
                                col.validity[indices] & valid)
    if isinstance(col, MapColumn):
        return MapColumn(col.keys[indices], col.values[indices],
                         col.val_valid[indices] & valid[:, None],
                         torch.where(valid, col.lens[indices], 0),
                         col.validity[indices] & valid)
    if isinstance(col, StringMapColumn):
        return StringMapColumn(col.kchars[indices], col.kslens[indices],
                               col.vchars[indices], col.vslens[indices],
                               col.val_valid[indices] & valid[:, None],
                               torch.where(valid, col.lens[indices], 0),
                               col.validity[indices] & valid)
    if isinstance(col, StructColumn):
        return StructColumn(tuple(gather_column(c, indices, valid)
                                  for c in col.children),
                            col.validity[indices] & valid)
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


def _pad_axes(t: torch.Tensor, *sizes: int) -> torch.Tensor:
    """Zero-pad ``t``'s axes 1.. out to ``sizes``."""
    pad = []
    for ax in range(len(sizes), 0, -1):
        pad += [0, sizes[ax - 1] - t.shape[ax]]
    if not any(pad):
        return t
    return torch.nn.functional.pad(t, pad)


def pad_list_elems(col: ListColumn, max_elems: int) -> ListColumn:
    """Pad a list column's element axis out to ``max_elems`` slots."""
    if col.max_elems >= max_elems:
        return col
    return ListColumn(_pad_axes(col.values, max_elems),
                      _pad_axes(col.elem_valid, max_elems), col.lens,
                      col.validity)


def pad_map_elems(col: MapColumn, max_elems: int) -> MapColumn:
    """Pad a map column's entry axis out to ``max_elems`` slots."""
    if col.max_elems >= max_elems:
        return col
    return MapColumn(_pad_axes(col.keys, max_elems),
                     _pad_axes(col.values, max_elems),
                     _pad_axes(col.val_valid, max_elems), col.lens,
                     col.validity)


def unify_column_widths(cols: Sequence[Column]) -> list[Column]:
    """Pad string widths and list element counts to the max across
    ``cols`` so they can be concatenated (capacities may differ; widths
    must not)."""
    if not cols:
        return []
    c0 = cols[0]
    if isinstance(c0, StringColumn):
        w = max(c.width for c in cols)
        return [pad_string_width(c, w) for c in cols]
    if isinstance(c0, ListColumn):
        m = max(c.max_elems for c in cols)
        return [pad_list_elems(c, m) for c in cols]
    if isinstance(c0, MapColumn):
        m = max(c.max_elems for c in cols)
        return [pad_map_elems(c, m) for c in cols]
    if isinstance(c0, StringListColumn):
        m = max(c.max_elems for c in cols)
        w = max(c.width for c in cols)
        return [StringListColumn(_pad_axes(c.chars, m, w),
                                 _pad_axes(c.slens, m),
                                 _pad_axes(c.elem_valid, m), c.lens,
                                 c.validity) for c in cols]
    if isinstance(c0, StringMapColumn):
        m = max(c.max_elems for c in cols)
        kw = max(c.kchars.shape[2] for c in cols)
        vw = max(c.vchars.shape[2] for c in cols)
        return [StringMapColumn(_pad_axes(c.kchars, m, kw),
                                _pad_axes(c.kslens, m),
                                _pad_axes(c.vchars, m, vw),
                                _pad_axes(c.vslens, m),
                                _pad_axes(c.val_valid, m), c.lens,
                                c.validity) for c in cols]
    if isinstance(c0, StructColumn):
        per_child = [unify_column_widths([c.children[i] for c in cols])
                     for i in range(len(c0.children))]
        return [StructColumn(tuple(kids[j] for kids in per_child),
                             c.validity) for j, c in enumerate(cols)]
    return list(cols)


def concat_many(cols: Sequence[Column]) -> Column:
    """Stack columns (capacities add); string widths and list element
    counts are unified first."""
    cols = unify_column_widths(cols)
    c0 = cols[0]
    if isinstance(c0, StructColumn):
        return StructColumn(
            tuple(concat_many([c.children[i] for c in cols])
                  for i in range(len(c0.children))),
            torch.cat([c.validity for c in cols]))
    return type(c0)(*(torch.cat(ts) for ts in
                      zip(*(column_tensors(c) for c in cols))))


def concat_columns(a: Column, b: Column) -> Column:
    """Stack two columns (capacities add)."""
    return concat_many([a, b])


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

    return DeviceBatch(tuple(map_rows(c, fit) for c in batch.columns),
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
