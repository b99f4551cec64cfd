"""The port's nested column classes and their Arrow bridge against the
JAX package's, on the CPU.

The cases of ``tests/test_generate.py``, ``test_map_struct.py`` and
``test_string_lists.py``'s round trips, at a small size: one record
batch of list<int64>, list<float64>, list<string>, list<decimal(7, 2)>,
list<decimal(25, 2)>, map<string, string>, map<int64, float64>, entry
lists and structs, holding a null list, an empty list and lists that
hold nulls, sliced so that Arrow's offsets start past 0.

- ``schema_from_arrow`` gives the reference's fields;
- ``to_device`` gives the reference's padded tensors, value for value
  (``elem_valid``, ``lens`` and ``validity`` keep a null list, an
  empty list and a list holding nulls apart);
- ``to_arrow`` of it equals the input (NaN aside: floats compared by
  their bits) and the reference's ``to_arrow``;
- gather, compact, concat (different element counts and widths),
  resize and ``null_column_for_field`` give the reference's columns;
- a parquet file of every nested type reads through the Session and
  collects to the table that was written.
"""

import decimal
import struct

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.columnar import batch as rbatch
from auron_tpu.columnar.schema import DataType as RDT
from auron_tpu.columnar.schema import Field as RField
from auron_tpu.exprs import eval as reval
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.columnar import batch as tbatch
from auron_tpu_torch.columnar.schema import DataType as TDT
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.exprs import eval as teval
from auron_tpu_torch.frontend.session import Session
from auron_tpu_torch.it import nested

D = decimal.Decimal


def _table():
    nan = float("nan")
    return pa.table({
        "li": pa.array([[1, 2, None], [], None, [4], [5, 5, 5, 5, 5]],
                       pa.list_(pa.int64())),
        "lf": pa.array([[1.5, nan], None, [], [-0.0, 0.0], [None]],
                       pa.list_(pa.float64())),
        "ls": pa.array([["a", "bcd", None], None, [], ["xyz"],
                        ["q" * 20]], pa.list_(pa.string())),
        "ldn": pa.array([[D("1.25"), None], [D("-3.00")], None, [], []],
                        pa.list_(pa.decimal128(7, 2))),
        "ldw": pa.array([[D("12345678901234567890.25"), None],
                         [D("-3.00")], None, [], [D("0.01")]],
                        pa.list_(pa.decimal128(25, 2))),
        "mss": pa.array([[("a", "x"), ("b", None)], None, [],
                         [("k", "v")], [("z", "")]],
                        pa.map_(pa.string(), pa.string())),
        "mif": pa.array([[(1, 1.5), (2, None)], None, [], [(3, 2.0)],
                         [(4, -1.0)]], pa.map_(pa.int64(), pa.float64())),
        "st": pa.array([{"a": 1, "b": "x"}, None, {"a": None, "b": "yy"},
                        {"a": 4, "b": None}, {"a": 5, "b": ""}],
                       pa.struct([("a", pa.int64()), ("b", pa.string())])),
        "el": pa.array([[{"key": 1, "value": 2.0}], [], None,
                        [{"key": 3, "value": None}], []],
                       pa.list_(pa.struct([("key", pa.int64()),
                                           ("value", pa.float64())]))),
    })


#: (name, slice): the whole table and slices whose offsets start past 0
SLICES = [("whole", 0, 5), ("tail", 1, 4), ("middle", 2, 2)]


def _bits(x):
    if isinstance(x, float):
        return struct.pack("<d", x)
    if isinstance(x, list):
        return [_bits(e) for e in x]
    if isinstance(x, tuple):
        return tuple(_bits(e) for e in x)
    if isinstance(x, dict):
        return {k: _bits(v) for k, v in x.items()}
    return x


def _same_table(got, want):
    assert got.schema == want.schema
    assert _bits(got.to_pylist()) == _bits(want.to_pylist())


def _arrays(col):
    """Every array of a column, nested ones included, as numpy."""
    if isinstance(col, (tbatch.StructColumn, rbatch.StructColumn)):
        return [a for c in col.children for a in _arrays(c)] \
            + [np.asarray(col.validity)]
    if isinstance(col, tbatch.Column.__args__):
        return [t.numpy() for t in tbatch.column_tensors(col)]
    names = {rbatch.ListColumn: tbatch.ListColumn,
             rbatch.StringListColumn: tbatch.StringListColumn,
             rbatch.MapColumn: tbatch.MapColumn,
             rbatch.StringMapColumn: tbatch.StringMapColumn,
             rbatch.StringColumn: tbatch.StringColumn,
             rbatch.PrimitiveColumn: tbatch.PrimitiveColumn}
    fields = tbatch._TENSORS[names.get(type(col), tbatch.Decimal128Column)]
    return [np.asarray(getattr(col, f)) for f in fields]


def _same_column(t, r, n=None):
    assert type(t).__name__ == type(r).__name__
    ta, ra = _arrays(t), _arrays(r)
    assert len(ta) == len(ra)
    for a, b in zip(ta, ra):
        assert a.shape == b.shape, (type(t).__name__, a.shape, b.shape)
        if n is not None:
            a, b = a[:n], b[:n]
        if a.dtype.kind == "f":
            np.testing.assert_array_equal(a.view(np.int64 if a.itemsize == 8
                                                 else np.int32),
                                          b.view(np.int64 if b.itemsize == 8
                                                 else np.int32))
        else:
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,start,length", SLICES)
def test_schema_and_device_layout_match_reference(name, start, length):
    rb = _table().slice(start, length).combine_chunks().to_batches()[0]
    tsch = tbridge.schema_from_arrow(rb.schema)
    rsch = rbridge.schema_from_arrow(rb.schema)
    assert [(f.name, f.dtype.value, f.precision, f.scale,
             f.elem and f.elem.value, f.key and f.key.value,
             [(c.name, c.dtype.value) for c in f.children])
            for f in tsch] == \
        [(f.name, f.dtype.value, f.precision, f.scale,
          f.elem and f.elem.value, f.key and f.key.value,
          [(c.name, c.dtype.value) for c in f.children]) for f in rsch]
    tb, _ = tbridge.to_device(rb, capacity=8, device="cpu")
    rbd, _ = rbridge.to_device(rb, capacity=8)
    for t, r in zip(tb.columns, rbd.columns):
        _same_column(t, r)


@pytest.mark.parametrize("name,start,length", SLICES)
def test_arrow_round_trip_is_identical(name, start, length):
    table = _table().slice(start, length)
    rb = table.combine_chunks().to_batches()[0] if length else None
    tb, tsch = tbridge.to_device(rb, capacity=8, device="cpu")
    got = pa.Table.from_batches([tbridge.to_arrow(tb, tsch)])
    _same_table(got, pa.Table.from_batches([rb]))
    rbd, rsch = rbridge.to_device(rb, capacity=8)
    _same_table(got, pa.Table.from_batches([rbridge.to_arrow(rbd, rsch)]))


def test_null_empty_and_null_holding_lists_stay_apart():
    rb = _table().to_batches()[0]
    tb, _ = tbridge.to_device(rb, capacity=8, device="cpu")
    li = tb.columns[0]
    assert li.validity.tolist()[:5] == [True, True, False, True, True]
    assert li.lens.tolist()[:5] == [3, 0, 0, 1, 5]
    assert li.elem_valid[0].tolist()[:3] == [True, True, False]


def _both(rb, cap=8):
    return (tbridge.to_device(rb, capacity=cap, device="cpu")[0],
            rbridge.to_device(rb, capacity=cap)[0])


def test_column_ops_match_reference():
    rb = _table().to_batches()[0]
    tb, rbd = _both(rb)
    idx = np.array([4, 0, 0, 3, 1, 2, 7, 5])
    valid = np.array([1, 1, 0, 1, 1, 1, 0, 0], bool)
    for t, r in zip(tb.columns, rbd.columns):
        _same_column(tbatch.gather_column(t, torch.from_numpy(idx),
                                          torch.from_numpy(valid)),
                     rbatch.gather_column(r, jnp.asarray(idx),
                                          jnp.asarray(valid)))
    keep = np.array([1, 0, 1, 1, 0, 1, 0, 0], bool)
    tc = tbatch.compact(tb, torch.from_numpy(keep))
    rc = rbatch.compact(rbd, jnp.asarray(keep))
    assert int(tc.num_rows) == int(rc.num_rows)
    for t, r in zip(tc.columns, rc.columns):
        _same_column(t, r, int(tc.num_rows))
    for cap in (16, 4):
        for t, r in zip(tbatch.resize(tb, cap).columns,
                        rbatch.resize(rbd, cap).columns):
            _same_column(t, r)


def test_concat_unifies_element_counts_and_widths():
    """Two batches whose lists and strings have different maxima
    concatenate as the reference's: padded to the larger."""
    a = _table().slice(0, 2).combine_chunks().to_batches()[0]
    b = _table().slice(3, 2).combine_chunks().to_batches()[0]
    ta, ra = _both(a, 4)
    tb2, rb2 = _both(b, 4)
    got = tbatch.concat_batches(ta, tb2)
    # the reference's concat asks its callers to unify first
    pairs = [rbatch.unify_column_widths([x, y])
             for x, y in zip(ra.columns, rb2.columns)]
    want = rbatch.concat_batches(
        rbatch.DeviceBatch(tuple(p[0] for p in pairs), ra.num_rows),
        rbatch.DeviceBatch(tuple(p[1] for p in pairs), rb2.num_rows))
    assert int(got.num_rows) == int(want.num_rows) == 4
    for t, r in zip(got.columns, want.columns):
        _same_column(t, r, 4)


@pytest.mark.parametrize("field", [
    ("LIST", dict(elem="INT64")), ("LIST", dict(elem="STRING")),
    ("MAP", dict(key="INT64", elem="FLOAT64")),
    ("MAP", dict(key="STRING", elem="STRING")),
    ("STRUCT", dict(children=[("a", "INT64"), ("b", "STRING")]))])
def test_null_column_for_field_matches_reference(field):
    dt, kw = field

    def make(DT, F):
        args = {k: getattr(DT, v) for k, v in kw.items()
                if k in ("elem", "key")}
        kids = tuple(F(n, getattr(DT, d)) for n, d in kw.get("children",
                                                              ()))
        return F("f", getattr(DT, dt), children=kids, **args)

    got = teval.null_column_for_field(make(TDT, TField), 5,
                                      torch.device("cpu"))
    want = reval.null_column_for_field(make(RDT, RField), 5)
    _same_column(got, want)


def test_nested_parquet_reads_through_the_session(tmp_path):
    files = nested.write_nested(str(tmp_path), 300)
    got = Session(device="cpu").read_parquet(files).collect()
    _same_table(got, pq.read_table(files[0]))


def test_batch_nbytes_counts_every_tensor():
    tb, rbd = _both(_table().to_batches()[0])
    assert tbatch.batch_nbytes(tb) == rbatch.batch_nbytes(rbd)
