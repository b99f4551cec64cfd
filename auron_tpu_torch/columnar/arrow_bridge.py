"""pyarrow RecordBatch <-> DeviceBatch conversion: primitive, string and
decimal columns.

The port of ``auron_tpu.columnar.arrow_bridge`` for fixed-width columns
with validity (bool, integers, floats, date32 and timestamp[us]),
string columns (``string``, ``large_string`` and dictionaries of them)
and ``decimal128(p, s)`` columns. A string column's char matrix is
built on the host in numpy from Arrow's offset and data buffers, as the
reference builds it, at the width bucket of its longest value or at a
width the caller pins. A decimal is read straight from Arrow's 16-byte
little-endian values (one int64 view: even words are the low limb, odd
words the high one): precision <= 18 as the unscaled int64, precision
19..38 as a ``Decimal128Column`` of limbs, the same values the
reference builds row by row through Python's ``decimal``. List, map and
struct columns (ROADMAP item 16f) raise ``NotImplementedError`` here.

pyarrow is imported inside the functions, never at module level, so
the port imports and runs where pyarrow is not installed; only the
functions that take or make Arrow data need it.

Host → device: each column (a string column's chars, lengths and
validity alike) is padded to the batch capacity in a pinned host buffer
and copied with ``non_blocking=True`` on a CUDA device, so the copy does
not wait for the host. Device → host: one packed copy of every column's
live rows per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import (DeviceBatch, PrimitiveColumn,
                                            StringColumn)
from auron_tpu_torch.columnar.decimal128 import MAX_PRECISION, Decimal128Column
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.ops.base import host_copy, host_readback
from auron_tpu_torch.utils.shapes import bucket_rows, bucket_string_width

#: numpy payload of each fixed-width type the bridge carries
_NP = {
    DataType.BOOL: np.bool_, DataType.INT8: np.int8,
    DataType.INT16: np.int16, DataType.INT32: np.int32,
    DataType.INT64: np.int64, DataType.FLOAT32: np.float32,
    DataType.FLOAT64: np.float64, DataType.DATE32: np.int32,
    DataType.TIMESTAMP_US: np.int64, DataType.NULL: np.bool_,
    DataType.DECIMAL: np.int64,
}


def _pa_to_dt() -> dict:
    import pyarrow as pa
    return {
        pa.bool_(): DataType.BOOL, pa.int8(): DataType.INT8,
        pa.int16(): DataType.INT16, pa.int32(): DataType.INT32,
        pa.int64(): DataType.INT64, pa.float32(): DataType.FLOAT32,
        pa.float64(): DataType.FLOAT64, pa.date32(): DataType.DATE32,
        pa.timestamp("us"): DataType.TIMESTAMP_US, pa.null(): DataType.NULL,
        pa.string(): DataType.STRING, pa.large_string(): DataType.STRING,
    }


def _field_to_pa(f: Field):
    import pyarrow as pa
    dt = f.dtype
    if dt == DataType.DECIMAL:
        return pa.decimal128(f.precision, f.scale)
    if dt == DataType.DATE32:
        return pa.date32()
    if dt == DataType.TIMESTAMP_US:
        return pa.timestamp("us")
    if dt == DataType.NULL:
        return pa.null()
    if dt == DataType.STRING:
        return pa.string()
    if dt not in _NP:
        raise NotImplementedError(
            f"{dt.value} columns: the port carries primitive, string and "
            "decimal columns only (ROADMAP item 16f)")
    return pa.from_numpy_dtype(_NP[dt])


def schema_from_arrow(sch) -> Schema:
    """The logical schema of an Arrow schema; dictionary columns take
    their value type, any timestamp unit reads as microseconds."""
    import pyarrow as pa
    known = _pa_to_dt()
    fields = []
    for f in sch:
        t = f.type
        if pa.types.is_dictionary(t):
            t = t.value_type
        if t in known:
            fields.append(Field(f.name, known[t], f.nullable))
        elif pa.types.is_timestamp(t):
            fields.append(Field(f.name, DataType.TIMESTAMP_US, f.nullable))
        elif pa.types.is_decimal(t):
            if t.precision > MAX_PRECISION:
                raise NotImplementedError(
                    f"decimal precision {t.precision} > 38 not supported")
            fields.append(Field(f.name, DataType.DECIMAL, f.nullable,
                                t.precision, t.scale))
        else:
            raise NotImplementedError(
                f"arrow type {t}: the port carries primitive, string and "
                "decimal columns only (ROADMAP item 16f)")
    return Schema(tuple(fields))


def schema_to_arrow(schema: Schema):
    import pyarrow as pa
    return pa.schema([pa.field(f.name, _field_to_pa(f), f.nullable)
                      for f in schema])


def _pinned(n: int, dtype: torch.dtype, device: torch.device
            ) -> torch.Tensor:
    """A zeroed host staging buffer: pinned when it feeds a CUDA copy
    (PyTorch's caching host allocator reuses the blocks), pageable
    otherwise."""
    return torch.zeros(n, dtype=dtype, pin_memory=device.type == "cuda")


def _staged(a: np.ndarray, cap: int, device: torch.device) -> torch.Tensor:
    """``a`` (``n <= cap`` rows) zero-padded to ``cap`` rows in a staging
    buffer, then on ``device``."""
    dtype = torch.from_numpy(np.empty(0, a.dtype)).dtype
    t = _pinned(cap * int(np.prod(a.shape[1:], dtype=np.int64)), dtype,
                device).reshape((cap,) + a.shape[1:])
    t.numpy()[:a.shape[0]] = a
    if device.type == "cpu":
        return t
    return t.to(device, non_blocking=True)


def host_to_device(data: np.ndarray, validity: np.ndarray, cap: int,
                   device: torch.device) -> PrimitiveColumn:
    """One column from host arrays of ``n <= cap`` rows, zero-padded to
    ``cap`` and copied to ``device``."""
    return PrimitiveColumn(_staged(data, cap, device),
                           _staged(np.asarray(validity, np.bool_), cap,
                                   device))


def _string_arrays(arr, width: int | None):
    """(chars[n, w], lens[n], validity[n]) of a pyarrow string array from
    its offset and data buffers (no per-row Python), honouring the
    array's offset. ``width`` pins the char matrix's width; by default it
    is the bucket of the longest value. A null row's length is 0 (its
    bytes, if Arrow holds any, stay), as in the reference."""
    import pyarrow as pa
    if not pa.types.is_string(arr.type):
        arr = arr.cast(pa.string())
    n = len(arr)
    offsets = np.frombuffer(arr.buffers()[1], dtype=np.int32, count=n + 1,
                            offset=arr.offset * 4)
    buf = arr.buffers()[2]
    data = np.frombuffer(buf, dtype=np.uint8) if buf is not None \
        else np.zeros(0, np.uint8)
    lens = (offsets[1:] - offsets[:-1]).astype(np.int32)
    max_len = int(lens.max()) if n else 0
    w = width if width is not None else bucket_string_width(max_len)
    if max_len > w:
        raise ValueError(f"string of length {max_len} exceeds width "
                         f"bucket {w}")
    chars = np.zeros((n, w), dtype=np.uint8)
    if n and data.size:
        # chars[i, j] = data[offsets[i] + j] for j < lens[i]
        col_idx = np.arange(w, dtype=np.int64)[None, :]
        in_range = col_idx < lens[:, None]
        src = np.minimum(offsets[:-1, None].astype(np.int64) + col_idx,
                         data.size - 1)
        chars = np.where(in_range, data[src], np.uint8(0))
    validity = ~np.asarray(arr.is_null()) if arr.null_count \
        else np.ones(n, np.bool_)
    lens[~validity] = 0
    return chars, lens, validity


def _string_to_device(arr, cap: int, width: int | None,
                      device: torch.device) -> StringColumn:
    chars, lens, validity = _string_arrays(arr, width)
    return StringColumn(_staged(chars, cap, device),
                        _staged(lens, cap, device),
                        _staged(validity, cap, device))


def _decimal_limbs(arr) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(hi, lo, validity) of a pyarrow decimal128 array, read from its
    values buffer as one int64 view (even words the low limb, odd words
    the high one), honouring the array's offset; null rows hold 0."""
    import pyarrow as pa
    if not pa.types.is_decimal128(arr.type):
        arr = arr.cast(pa.decimal128(arr.type.precision, arr.type.scale))
    n = len(arr)
    words = np.frombuffer(arr.buffers()[1], dtype=np.int64,
                          count=2 * n, offset=arr.offset * 16)
    validity = (~np.asarray(arr.is_null()) if arr.null_count
                else np.ones(n, np.bool_))
    lo = np.where(validity, words[0::2], 0)
    hi = np.where(validity, words[1::2], 0)
    return hi, lo, validity


def _decimal_to_device(field: Field, arr, cap: int, device: torch.device):
    """A decimal column: the unscaled int64 for precision <= 18, the
    limbs for 19..38."""
    hi, lo, validity = _decimal_limbs(arr)
    if field.precision <= 18:
        return host_to_device(lo, validity, cap, device)
    return Decimal128Column(_staged(hi, cap, device),
                            _staged(lo, cap, device),
                            _staged(validity, cap, device))


def _column_to_device(field: Field, arr, cap: int, device: torch.device,
                      string_widths: dict | None = None):
    """One Arrow column → a padded device column; nulls hold 0 (False
    for bool), as in the reference. ``string_widths`` pins the width of
    the string columns it names."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_decode()
    if field.dtype == DataType.STRING:
        return _string_to_device(arr, cap, (string_widths or {}).get(
            field.name), device)
    n = len(arr)
    np_dtype = _NP.get(field.dtype)
    if np_dtype is None:
        raise NotImplementedError(
            f"{field.dtype.value} column {field.name!r}: the port carries "
            "primitive, string and decimal columns only (ROADMAP item 16f)")
    if field.dtype == DataType.DECIMAL:
        return _decimal_to_device(field, arr, cap, device)
    if field.dtype == DataType.NULL:
        return host_to_device(np.zeros(n, np.bool_), np.zeros(n, np.bool_),
                              cap, device)
    if field.dtype == DataType.TIMESTAMP_US:
        vals = arr.cast(pa.timestamp("us")).cast(pa.int64())
    elif field.dtype == DataType.DATE32:
        vals = arr.cast(pa.int32())
    else:
        vals = arr
    vals = vals.fill_null(False if field.dtype == DataType.BOOL else 0)
    data = np.asarray(vals).astype(np_dtype, copy=False)
    validity = (~np.asarray(arr.is_null()) if arr.null_count
                else np.ones(n, np.bool_))
    return host_to_device(data, validity, cap, device)


def to_device(rb, capacity: int | None = None, device=None,
              string_widths: dict | None = None
              ) -> tuple[DeviceBatch, Schema]:
    """Convert a pyarrow RecordBatch into a padded DeviceBatch on
    ``device`` (``cuda`` unless another is named); ``string_widths``
    pins the char width of the string columns it names."""
    dev = resolve_device(device)
    schema = schema_from_arrow(rb.schema)
    n = rb.num_rows
    cap = capacity if capacity is not None else bucket_rows(n)
    if n > cap:
        raise ValueError(f"batch of {n} rows exceeds capacity {cap}")
    cols = tuple(_column_to_device(f, arr, cap, dev, string_widths)
                 for f, arr in zip(schema, rb.columns))
    return DeviceBatch(cols, torch.full((), n, dtype=torch.int32,
                                        device=dev)), schema


def fetch_numpy(batch: DeviceBatch) -> tuple[list[tuple], int]:
    """``([(data, validity), (chars, lens, validity) or (hi, lo,
    validity), ...], n)`` of the batch's live rows: one readback of the
    row count, then ONE packed device → host copy of every column,
    string and decimal128 columns included."""
    (n,) = host_readback([batch.num_rows])
    parts, layout = [], []

    def add(t: torch.Tensor) -> None:
        t = t[:n].contiguous()
        layout.append((t.dtype, tuple(t.shape), t.numel() * t.element_size()))
        parts.append(t.view(torch.uint8).reshape(-1))

    for c in batch.columns:
        if isinstance(c, StringColumn):
            add(c.chars)
            add(c.lens)
        elif isinstance(c, Decimal128Column):
            add(c.hi)
            add(c.lo)
        elif isinstance(c, PrimitiveColumn):
            add(c.data)
        else:
            raise NotImplementedError(
                f"{type(c).__name__}: the port carries primitive, string "
                "and decimal128 columns only")
        add(c.validity)
    if not parts:
        return [], n
    host = host_copy(torch.cat(parts)).numpy()
    arrays, off = [], 0
    for dtype, shape, nbytes in layout:
        arrays.append(host[off:off + nbytes].view(
            torch.empty(0, dtype=dtype).numpy().dtype).reshape(shape))
        off += nbytes
    out, it = [], iter(arrays)
    for c in batch.columns:
        out.append((next(it), next(it), next(it))
                   if isinstance(c, (StringColumn, Decimal128Column))
                   else (next(it), next(it)))
    return out, n


def strings_to_python(chars: np.ndarray, lens: np.ndarray,
                      validity: np.ndarray) -> np.ndarray:
    """A fetched string column as a numpy object array of ``str`` (None
    where null): UTF-8 decoded, invalid bytes replaced."""
    out = np.empty(chars.shape[0], dtype=object)
    for i in range(chars.shape[0]):
        out[i] = bytes(chars[i, :lens[i]]).decode("utf-8", "replace") \
            if validity[i] else None
    return out


def _host_string_to_arrow(chars: np.ndarray, lens: np.ndarray,
                          validity: np.ndarray, n: int):
    """A fetched string column → a pyarrow StringArray built from its
    buffers: offsets from the lengths, the bytes below each length."""
    import pyarrow as pa
    lens = np.where(validity, lens.astype(np.int64), 0)
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(lens, out=offsets[1:])
    take = np.arange(chars.shape[1])[None, :] < lens[:, None]
    flat = chars[take].astype(np.uint8)
    return pa.StringArray.from_buffers(
        n, pa.py_buffer(offsets.tobytes()), pa.py_buffer(flat.tobytes()),
        pa.py_buffer(np.packbits(validity, bitorder="little").tobytes()),
        int((~validity).sum()))


def _host_decimal_to_arrow(field: Field, host: tuple, n: int):
    """A fetched decimal column (the unscaled int64, or the limbs) → a
    pyarrow decimal128 array built from one buffer of 16-byte values."""
    import pyarrow as pa
    if len(host) == 3:
        hi, lo, validity = host
    else:
        lo, validity = host
        hi = np.where(lo < 0, -1, 0)
    words = np.empty(2 * n, np.int64)
    words[0::2] = np.where(validity, lo, 0)
    words[1::2] = np.where(validity, hi, 0)
    nulls = int((~validity).sum())
    bits = pa.py_buffer(np.packbits(validity, bitorder="little").tobytes()) \
        if nulls else None
    return pa.Array.from_buffers(
        pa.decimal128(field.precision, field.scale), n,
        [bits, pa.py_buffer(words.tobytes())], nulls)


def _host_col_to_arrow(field: Field, host: tuple, n: int):
    """ONE host column → a pyarrow array."""
    import pyarrow as pa
    if field.dtype == DataType.STRING:
        return _host_string_to_arrow(*host, n)
    if field.dtype == DataType.DECIMAL:
        return _host_decimal_to_arrow(field, host, n)
    data, validity = host
    if field.dtype == DataType.NULL:
        return pa.nulls(n)
    mask = None if validity.all() else ~validity
    if field.dtype == DataType.DATE32:
        return pa.array(np.where(validity, data, 0), pa.int32(),
                        mask=mask).cast(pa.date32())
    if field.dtype == DataType.TIMESTAMP_US:
        return pa.array(np.where(validity, data, 0), pa.int64(),
                        mask=mask).cast(pa.timestamp("us"))
    return pa.array(data, _field_to_pa(field), mask=mask)


def to_arrow(batch: DeviceBatch, schema: Schema):
    """Materialize a DeviceBatch as a pyarrow RecordBatch: one packed
    device → host copy (``fetch_numpy``), then every column through
    ``_host_col_to_arrow``."""
    import pyarrow as pa
    fetched, n = fetch_numpy(batch)
    arrays = [_host_col_to_arrow(f, h, n) for f, h in zip(schema, fetched)]
    return pa.RecordBatch.from_arrays(arrays, schema=schema_to_arrow(schema))
