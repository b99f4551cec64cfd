"""pyarrow RecordBatch <-> DeviceBatch conversion, primitive columns.

The port of ``auron_tpu.columnar.arrow_bridge`` for fixed-width columns
with validity: bool, integers, floats, date32 and timestamp[us]. String,
decimal, list, map and struct columns come with the slices that need
them and raise ``NotImplementedError`` here.

pyarrow is imported inside the functions, never at module level, so
the port imports and runs where pyarrow is not installed; only the
functions that take or make Arrow data need it.

Host → device: each column is padded to the batch capacity in a pinned
host buffer and copied with ``non_blocking=True`` on a CUDA device, so
the copy does not wait for the host. Device → host: one packed copy of
every column's live rows per batch.
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch import resolve_device
from auron_tpu_torch.columnar.batch import DeviceBatch, PrimitiveColumn
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.ops.base import host_copy, host_readback
from auron_tpu_torch.utils.shapes import bucket_rows

#: numpy payload of each fixed-width type the bridge carries
_NP = {
    DataType.BOOL: np.bool_, DataType.INT8: np.int8,
    DataType.INT16: np.int16, DataType.INT32: np.int32,
    DataType.INT64: np.int64, DataType.FLOAT32: np.float32,
    DataType.FLOAT64: np.float64, DataType.DATE32: np.int32,
    DataType.TIMESTAMP_US: np.int64, DataType.NULL: np.bool_,
}


def _pa_to_dt() -> dict:
    import pyarrow as pa
    return {
        pa.bool_(): DataType.BOOL, pa.int8(): DataType.INT8,
        pa.int16(): DataType.INT16, pa.int32(): DataType.INT32,
        pa.int64(): DataType.INT64, pa.float32(): DataType.FLOAT32,
        pa.float64(): DataType.FLOAT64, pa.date32(): DataType.DATE32,
        pa.timestamp("us"): DataType.TIMESTAMP_US, pa.null(): DataType.NULL,
    }


def _dt_to_pa(dt: DataType):
    import pyarrow as pa
    if dt == DataType.DATE32:
        return pa.date32()
    if dt == DataType.TIMESTAMP_US:
        return pa.timestamp("us")
    if dt == DataType.NULL:
        return pa.null()
    if dt not in _NP:
        raise NotImplementedError(
            f"{dt.value} columns: the port carries primitive columns only")
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
        else:
            raise NotImplementedError(
                f"arrow type {t}: the port carries primitive columns only")
    return Schema(tuple(fields))


def schema_to_arrow(schema: Schema):
    import pyarrow as pa
    return pa.schema([pa.field(f.name, _dt_to_pa(f.dtype), f.nullable)
                      for f in schema])


def _pinned(n: int, dtype: torch.dtype, device: torch.device
            ) -> torch.Tensor:
    """A zeroed host staging buffer: pinned when it feeds a CUDA copy
    (PyTorch's caching host allocator reuses the blocks), pageable
    otherwise."""
    return torch.zeros(n, dtype=dtype, pin_memory=device.type == "cuda")


def host_to_device(data: np.ndarray, validity: np.ndarray, cap: int,
                   device: torch.device) -> PrimitiveColumn:
    """One column from host arrays of ``n <= cap`` rows, zero-padded to
    ``cap`` and copied to ``device``."""
    n = data.shape[0]
    dtype = torch.from_numpy(np.empty(0, data.dtype)).dtype
    d = _pinned(cap, dtype, device)
    v = _pinned(cap, torch.bool, device)
    d.numpy()[:n] = data
    v.numpy()[:n] = validity
    if device.type == "cpu":
        return PrimitiveColumn(d, v)
    return PrimitiveColumn(d.to(device, non_blocking=True),
                           v.to(device, non_blocking=True))


def _column_to_device(field: Field, arr, cap: int,
                      device: torch.device) -> PrimitiveColumn:
    """One Arrow column → a padded device column; nulls hold 0 (False
    for bool), as in the reference."""
    import pyarrow as pa
    if isinstance(arr, pa.ChunkedArray):
        arr = arr.combine_chunks()
    if pa.types.is_dictionary(arr.type):
        arr = arr.dictionary_decode()
    n = len(arr)
    np_dtype = _NP.get(field.dtype)
    if np_dtype is None:
        raise NotImplementedError(
            f"{field.dtype.value} column {field.name!r}: the port carries "
            "primitive columns only")
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


def to_device(rb, capacity: int | None = None, device=None
              ) -> tuple[DeviceBatch, Schema]:
    """Convert a pyarrow RecordBatch into a padded DeviceBatch on
    ``device`` (``cuda`` unless another is named)."""
    dev = resolve_device(device)
    schema = schema_from_arrow(rb.schema)
    n = rb.num_rows
    cap = capacity if capacity is not None else bucket_rows(n)
    if n > cap:
        raise ValueError(f"batch of {n} rows exceeds capacity {cap}")
    cols = tuple(_column_to_device(f, arr, cap, dev)
                 for f, arr in zip(schema, rb.columns))
    return DeviceBatch(cols, torch.full((), n, dtype=torch.int32,
                                        device=dev)), schema


def fetch_numpy(batch: DeviceBatch
                ) -> tuple[list[tuple[np.ndarray, np.ndarray]], int]:
    """``([(data, validity), ...], n)`` of the batch's live rows: one
    readback of the row count, then ONE packed device → host copy of
    every column."""
    (n,) = host_readback([batch.num_rows])
    parts, layout = [], []
    for c in batch.columns:
        if not isinstance(c, PrimitiveColumn):
            raise NotImplementedError(
                f"{type(c).__name__}: the port carries primitive columns")
        d = c.data[:n].contiguous()
        layout.append((d.dtype, d.numel() * d.element_size()))
        parts += [d.view(torch.uint8).reshape(-1),
                  c.validity[:n].view(torch.uint8)]
    if not parts:
        return [], n
    host = host_copy(torch.cat(parts)).numpy()
    out, off = [], 0
    for dtype, nbytes in layout:
        data = host[off:off + nbytes].view(
            torch.empty(0, dtype=dtype).numpy().dtype)
        off += nbytes
        validity = host[off:off + n].view(np.bool_)
        off += n
        out.append((data, validity))
    return out, n


def _host_col_to_arrow(field: Field, data: np.ndarray,
                       validity: np.ndarray, n: int):
    """ONE host column → a pyarrow array."""
    import pyarrow as pa
    if field.dtype == DataType.NULL:
        return pa.nulls(n)
    mask = None if validity.all() else ~validity
    if field.dtype == DataType.DATE32:
        return pa.array(np.where(validity, data, 0), pa.int32(),
                        mask=mask).cast(pa.date32())
    if field.dtype == DataType.TIMESTAMP_US:
        return pa.array(np.where(validity, data, 0), pa.int64(),
                        mask=mask).cast(pa.timestamp("us"))
    return pa.array(data, _dt_to_pa(field.dtype), mask=mask)


def to_arrow(batch: DeviceBatch, schema: Schema):
    """Materialize a DeviceBatch as a pyarrow RecordBatch: one packed
    device → host copy (``fetch_numpy``), then every column through
    ``_host_col_to_arrow``."""
    import pyarrow as pa
    fetched, n = fetch_numpy(batch)
    arrays = [_host_col_to_arrow(f, d, v, n)
              for f, (d, v) in zip(schema, fetched)]
    return pa.RecordBatch.from_arrays(arrays, schema=schema_to_arrow(schema))
