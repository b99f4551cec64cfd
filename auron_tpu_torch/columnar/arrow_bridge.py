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
reference builds row by row through Python's ``decimal``.

Nested columns (``columnar/batch.py``): list<primitive>,
list<decimal> (precision <= 18 as a ``ListColumn`` of the unscaled
int64, 19..38 on the ``MapColumn`` limb carrier), list<string>,
map<primitive, primitive>, map<string, string>, entry lists
(list<struct<key, value>> of two numeric children, on the ``MapColumn``
carrier) and structs of non-nested children. The padded matrices come
from Arrow's offsets in numpy, one gather per level, and go back the
same way: a null list is a null offset, an empty list a valid one of
length 0, and a list that holds nulls carries them in its child's
validity.

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
from auron_tpu_torch.columnar.batch import (DeviceBatch, ListColumn,
                                            MapColumn, PrimitiveColumn,
                                            StringColumn, StringListColumn,
                                            StringMapColumn, StructColumn,
                                            column_tensors)
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


#: fallback precision of a list<decimal> field whose precision slot is 0
_LIST_DECIMAL_FALLBACK_PRECISION = 38


def _prim_to_pa(dt: DataType):
    """The Arrow type of a non-nested, non-decimal element type."""
    import pyarrow as pa
    if dt == DataType.STRING:
        return pa.string()
    if dt == DataType.DATE32:
        return pa.date32()
    if dt == DataType.TIMESTAMP_US:
        return pa.timestamp("us")
    return pa.from_numpy_dtype(_NP[dt])


def _field_to_pa(f: Field):
    import pyarrow as pa
    dt = f.dtype
    if dt == DataType.LIST:
        if f.elem == DataType.STRUCT:
            return pa.list_(pa.struct(
                [pa.field(cf.name, _prim_to_pa(cf.dtype), cf.nullable)
                 for cf in f.children]))
        if f.elem == DataType.DECIMAL:
            # the element's (p, s) rides the list field's own slots
            return pa.list_(pa.decimal128(
                f.precision or _LIST_DECIMAL_FALLBACK_PRECISION, f.scale))
        return pa.list_(_prim_to_pa(f.elem))
    if dt == DataType.MAP:
        return pa.map_(_prim_to_pa(f.key), _prim_to_pa(f.elem))
    if dt == DataType.STRUCT:
        return pa.struct([pa.field(cf.name, _field_to_pa(cf), cf.nullable)
                          for cf in f.children])
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
    return pa.from_numpy_dtype(_NP[dt])


def schema_from_arrow(sch) -> Schema:
    """The logical schema of an Arrow schema; dictionary columns take
    their value type, any timestamp unit reads as microseconds."""
    return Schema(tuple(_field_from_arrow(f) for f in sch))


def _field_from_arrow(f) -> Field:
    """One Arrow field → a logical field, nested types included; the
    reference's refusals word for word."""
    import pyarrow as pa
    known = _pa_to_dt()
    t = f.type
    if pa.types.is_dictionary(t):
        t = t.value_type
    if t in known:
        return Field(f.name, known[t], f.nullable)
    if pa.types.is_timestamp(t):
        return Field(f.name, DataType.TIMESTAMP_US, f.nullable)
    if pa.types.is_decimal(t):
        if t.precision > MAX_PRECISION:
            raise NotImplementedError(
                f"decimal precision {t.precision} > 38 not supported")
        return Field(f.name, DataType.DECIMAL, f.nullable, t.precision,
                     t.scale)
    if pa.types.is_list(t) or pa.types.is_large_list(t):
        vt = t.value_type
        if pa.types.is_string(vt) or pa.types.is_large_string(vt):
            return Field(f.name, DataType.LIST, f.nullable,
                         elem=DataType.STRING)
        if pa.types.is_struct(vt):
            # an entry list: list<struct<K, V>> of two numeric children,
            # on the MapColumn carrier
            if vt.num_fields != 2:
                raise NotImplementedError(
                    f"list of {vt}: only 2-field entry structs "
                    "(key/value) are materialized")
            kids = []
            for i in range(vt.num_fields):
                cf = vt.field(i)
                cdt = known.get(cf.type)
                if cdt in (None, DataType.NULL, DataType.STRING):
                    raise NotImplementedError(
                        f"entry-struct child {cf.name}: {cf.type} "
                        "(numeric primitive children only)")
                kids.append(Field(cf.name, cdt, cf.nullable))
            return Field(f.name, DataType.LIST, f.nullable,
                         elem=DataType.STRUCT, children=tuple(kids))
        if pa.types.is_decimal(vt):
            if vt.precision > MAX_PRECISION:
                raise NotImplementedError(
                    f"list of {vt}: precision > 38")
            return Field(f.name, DataType.LIST, f.nullable, vt.precision,
                         vt.scale, elem=DataType.DECIMAL)
        elem = known.get(vt)
        if elem is None or elem == DataType.NULL:
            raise NotImplementedError(f"list of {vt}")
        return Field(f.name, DataType.LIST, f.nullable, elem=elem)
    if pa.types.is_map(t):
        key, val = known.get(t.key_type), known.get(t.item_type)
        if key == DataType.STRING and val == DataType.STRING:
            return Field(f.name, DataType.MAP, f.nullable,
                         elem=DataType.STRING, key=DataType.STRING)
        if key in (None, DataType.STRING, DataType.NULL) \
                or val in (None, DataType.STRING, DataType.NULL):
            raise NotImplementedError(
                f"map<{t.key_type}, {t.item_type}>: primitive "
                "keys/values or map<string,string> only")
        return Field(f.name, DataType.MAP, f.nullable, elem=val, key=key)
    if pa.types.is_struct(t):
        kids = []
        for i in range(t.num_fields):
            cf = t.field(i)
            sub = _field_from_arrow(cf)
            if sub.dtype in (DataType.MAP, DataType.STRUCT, DataType.LIST):
                raise NotImplementedError(
                    f"struct child {cf.name}: nested map/struct/list "
                    "children are not materialized yet")
            kids.append(sub)
        return Field(f.name, DataType.STRUCT, f.nullable,
                     children=tuple(kids))
    raise NotImplementedError(f"arrow type {t} not supported")


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


def _validity_np(arr) -> np.ndarray:
    return (~np.asarray(arr.is_null()) if arr.null_count
            else np.ones(len(arr), np.bool_))


def _list_layout(arr):
    """(offsets[n + 1] int64 from 0, lens[n] int32, validity[n], child)
    of a list or map array: ``child`` is the part of its values the rows
    span (a slice's rows span less than all of them); a null row's
    length is 0."""
    n = len(arr)
    offsets = np.asarray(arr.offsets)[:n + 1].astype(np.int64)
    o0 = int(offsets[0]) if n else 0
    child = arr.values.slice(o0, int(offsets[-1]) - o0 if n else 0)
    validity = _validity_np(arr)
    lens = np.where(validity, offsets[1:] - offsets[:-1], 0).astype(np.int32)
    return offsets - o0, lens, validity, child


def _padded(child: np.ndarray, offsets: np.ndarray, lens: np.ndarray,
            m: int, fill=0) -> np.ndarray:
    """``child`` (a flat array, trailing axes kept) as a padded [n, m,
    ...] matrix: row i holds child[offsets[i]:offsets[i] + lens[i]]."""
    n = lens.shape[0]
    out = np.full((n, m) + child.shape[1:], fill, child.dtype)
    if n and child.shape[0]:
        j = np.arange(m, dtype=np.int64)[None, :]
        take = j < lens[:, None]
        src = np.minimum(offsets[:-1, None] + j, child.shape[0] - 1)
        out[take] = child[src[take]]
    return out


def _prim_child(arr, dt: DataType) -> tuple[np.ndarray, np.ndarray]:
    """(values, validity) of a flat primitive child array; nulls hold 0
    (False for bool)."""
    import pyarrow as pa
    if dt == DataType.TIMESTAMP_US:
        vals = arr.cast(pa.timestamp("us")).cast(pa.int64())
    elif dt == DataType.DATE32:
        vals = arr.cast(pa.int32())
    else:
        vals = arr
    vals = vals.fill_null(False if dt == DataType.BOOL else 0)
    return np.asarray(vals).astype(_NP[dt], copy=False), _validity_np(arr)


def _list_to_device(field: Field, arr, cap: int, device: torch.device):
    """A list array → ListColumn, StringListColumn or the MapColumn
    carrier (list<decimal(p > 18)>: hi → keys, lo → values; an entry
    list: key → keys, value → values)."""
    import pyarrow as pa
    if pa.types.is_large_list(arr.type):
        arr = arr.cast(pa.list_(arr.type.value_type))
    offsets, lens, validity, child = _list_layout(arr)
    m = max(int(lens.max()) if len(lens) else 0, 1)

    def st(a):
        return _staged(a, cap, device)

    if field.elem == DataType.STRING:
        chars, slens, ev = _string_arrays(child, None)
        return StringListColumn(st(_padded(chars, offsets, lens, m)),
                                st(_padded(slens, offsets, lens, m)),
                                st(_padded(ev, offsets, lens, m, False)),
                                st(lens), st(validity))
    if field.elem == DataType.DECIMAL:
        hi, lo, ev = _decimal_limbs(child)
        lo_m = _padded(lo, offsets, lens, m)
        ev_m = _padded(ev, offsets, lens, m, False)
        if field.precision <= 18:
            return ListColumn(st(lo_m), st(ev_m), st(lens), st(validity))
        return MapColumn(st(_padded(hi, offsets, lens, m)), st(lo_m),
                         st(ev_m), st(lens), st(validity))
    if field.elem == DataType.STRUCT:
        return _entry_list_to_device(field, arr, cap, device)
    vals, ev = _prim_child(child, field.elem)
    return ListColumn(st(_padded(vals, offsets, lens, m)),
                      st(_padded(ev, offsets, lens, m, False)), st(lens),
                      st(validity))


def _entry_list_to_device(field: Field, arr, cap: int, device):
    """list<struct<K, V>> → the MapColumn carrier. A row holding a null
    entry struct is a null row (map_from_entries' "null entry → null"),
    and a null key of a live entry raises (map keys are never null)."""
    offsets, lens, validity, entries = _list_layout(arr)
    if entries.null_count:
        enull = np.asarray(entries.is_null()).astype(np.int64)
        cum = np.concatenate([[0], np.cumsum(enull)])
        validity = validity & ((cum[offsets[1:]] - cum[offsets[:-1]]) == 0)
        lens = np.where(validity, lens, 0).astype(np.int32)
    kf, vf = field.children
    kvals, kvalid = _prim_child(entries.field(0), kf.dtype)
    vvals, vvalid = _prim_child(entries.field(1), vf.dtype)
    m = max(int(lens.max()) if len(lens) else 0, 1)
    live_k = _padded(~kvalid, offsets, lens, m, False)
    if live_k.any():
        raise NotImplementedError(
            "entry list with NULL key children (Spark map keys are "
            "non-null)")
    return MapColumn(*(_staged(a, cap, device) for a in (
        _padded(kvals, offsets, lens, m), _padded(vvals, offsets, lens, m),
        _padded(vvalid, offsets, lens, m, False), lens, validity)))


def _map_to_device(field: Field, arr, cap: int, device: torch.device):
    """A map array → MapColumn, or StringMapColumn for map<string,
    string> (keys carry no element validity: they are never null)."""
    offsets, lens, validity, entries = _list_layout(arr)
    m = max(int(lens.max()) if len(lens) else 0, 1)

    def st(a):
        return _staged(a, cap, device)

    if field.key == DataType.STRING:
        kchars, kslens, _kv = _string_arrays(entries.field(0), None)
        vchars, vslens, vv = _string_arrays(entries.field(1), None)
        return StringMapColumn(
            st(_padded(kchars, offsets, lens, m)),
            st(_padded(kslens, offsets, lens, m)),
            st(_padded(vchars, offsets, lens, m)),
            st(_padded(vslens, offsets, lens, m)),
            st(_padded(vv, offsets, lens, m, False)), st(lens),
            st(validity))
    kvals, _kv = _prim_child(entries.field(0), field.key)
    vvals, vv = _prim_child(entries.field(1), field.elem)
    return MapColumn(st(_padded(kvals, offsets, lens, m)),
                     st(_padded(vvals, offsets, lens, m)),
                     st(_padded(vv, offsets, lens, m, False)), st(lens),
                     st(validity))


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
    if field.dtype == DataType.LIST:
        return _list_to_device(field, arr, cap, device)
    if field.dtype == DataType.MAP:
        return _map_to_device(field, arr, cap, device)
    if field.dtype == DataType.STRUCT:
        return StructColumn(
            tuple(_column_to_device(cf, arr.field(i), cap, device)
                  for i, cf in enumerate(field.children)),
            _staged(_validity_np(arr), cap, device))
    n = len(arr)
    np_dtype = _NP[field.dtype]
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
    row count, then ONE packed device → host copy of every column. A
    nested column comes back as its tensors in field order
    (``batch.column_tensors``); a struct as its children's tuples, then
    its validity."""
    (n,) = host_readback([batch.num_rows])
    parts, layout = [], []
    for c in batch.columns:
        for t in column_tensors(c):
            t = t[:n].contiguous()
            layout.append((t.dtype, tuple(t.shape),
                           t.numel() * t.element_size()))
            parts.append(t.view(torch.uint8).reshape(-1))
    if not parts:
        return [], n
    host = host_copy(torch.cat(parts)).numpy()
    arrays, off = [], 0
    for dtype, shape, nbytes in layout:
        arrays.append(host[off:off + nbytes].view(
            torch.empty(0, dtype=dtype).numpy().dtype).reshape(shape))
        off += nbytes
    it = iter(arrays)

    def rebuild(c):
        if isinstance(c, StructColumn):
            return tuple(rebuild(k) for k in c.children) + (next(it),)
        return tuple(next(it) for _ in column_tensors(c))

    return [rebuild(c) for c in batch.columns], n


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


def _offsets(lens: np.ndarray, validity: np.ndarray, n: int):
    """Arrow offsets from per-row lengths: null where the row is null
    (a null list), so an empty list stays a valid one of length 0."""
    import pyarrow as pa
    offsets = np.zeros(n + 1, np.int32)
    np.cumsum(np.where(validity, lens, 0), out=offsets[1:])
    if validity.all():
        return pa.array(offsets, pa.int32())
    mask = np.concatenate([~validity, [False]])
    return pa.array(offsets, pa.int32(), mask=mask)


def _elems(lens: np.ndarray, validity: np.ndarray, m: int) -> np.ndarray:
    """bool[n, m]: the element slots that hold a live row's elements."""
    ln = np.where(validity, lens, 0)
    return np.arange(m)[None, :] < ln[:, None]


def _child_to_arrow(dt: DataType, data: np.ndarray, valid: np.ndarray,
                    precision: int = 0, scale: int = 0):
    """A flat primitive (or narrow decimal) child array."""
    f = Field("c", dt, True, precision, scale)
    return _host_col_to_arrow(f, (data, valid), data.shape[0])


def _host_nested_to_arrow(field: Field, host: tuple, n: int):
    """A fetched list, map or struct column → a pyarrow array."""
    import pyarrow as pa
    if field.dtype == DataType.STRUCT:
        *kids, validity = host
        arrays = [_host_col_to_arrow(cf, h, n)
                  for cf, h in zip(field.children, kids)]
        mask = None if validity.all() else pa.array(~validity, pa.bool_())
        return pa.StructArray.from_arrays(
            arrays, fields=[pa.field(cf.name, _field_to_pa(cf), cf.nullable)
                            for cf in field.children], mask=mask)
    lens, validity = host[-2], host[-1]
    take = _elems(lens, validity, host[0].shape[1])
    off = _offsets(lens, validity, n)
    if field.dtype == DataType.MAP and field.key == DataType.STRING:
        kc, ks, vc, vs, vv = host[:5]
        k = take.sum()
        keys = _host_string_to_arrow(kc[take], ks[take], np.ones(k, bool), k)
        vals = _host_string_to_arrow(vc[take], vs[take], vv[take], k)
        return pa.MapArray.from_arrays(off, keys, vals)
    if field.dtype == DataType.MAP:
        keys, vals, vv = host[:3]
        k = take.sum()
        return pa.MapArray.from_arrays(
            off, _child_to_arrow(field.key, keys[take], np.ones(k, bool)),
            _child_to_arrow(field.elem, vals[take], vv[take]))
    if field.elem == DataType.STRING:
        chars, slens, ev = host[:3]
        k = take.sum()
        child = _host_string_to_arrow(chars[take], slens[take], ev[take], k)
    elif field.elem == DataType.STRUCT:
        keys, vals, vv = host[:3]
        kf, vf = field.children
        child = pa.StructArray.from_arrays(
            [_child_to_arrow(kf.dtype, keys[take],
                             np.ones(take.sum(), bool)),
             _child_to_arrow(vf.dtype, vals[take], vv[take])],
            fields=[pa.field(kf.name, _prim_to_pa(kf.dtype), kf.nullable),
                    pa.field(vf.name, _prim_to_pa(vf.dtype), vf.nullable)])
    elif field.elem == DataType.DECIMAL:
        p = field.precision or _LIST_DECIMAL_FALLBACK_PRECISION
        ef = Field("c", DataType.DECIMAL, True, p, field.scale)
        if len(host) == 5:      # the limb carrier: hi → keys, lo → values
            hi, lo, ev = host[:3]
            child = _host_decimal_to_arrow(ef, (hi[take], lo[take],
                                                ev[take]), take.sum())
        else:
            vals, ev = host[:2]
            child = _host_decimal_to_arrow(ef, (vals[take], ev[take]),
                                           take.sum())
    else:
        vals, ev = host[:2]
        child = _child_to_arrow(field.elem, vals[take], ev[take])
    return pa.ListArray.from_arrays(off, child)


def _host_col_to_arrow(field: Field, host: tuple, n: int):
    """ONE host column → a pyarrow array."""
    import pyarrow as pa
    if field.dtype in (DataType.LIST, DataType.MAP, DataType.STRUCT):
        return _host_nested_to_arrow(field, host, n)
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
