"""Array and map constructors, accessors and set operations.

The port of ``auron_tpu.exprs.fn_arrays``: 28 of the reference's array
and map functions over the padded nested columns of
``columnar/batch.py``. A constructor is one stack of its argument
columns, an accessor one gather along the element axis, and a set
operation an [E, E] equality mask per row. Maps follow Spark: a row
that would build a null key is null instead, and duplicate keys resolve
by ``auron.map.key_dedup_policy`` (``LAST_WIN`` keeps the last entry).

``split``, ``array_join`` and ``str_to_map`` are Python string code on
the host, as the reference's ``jax.pure_callback`` sites are: each makes
one packed readback and one upload per batch (``exprs/host.py``).
"""

from __future__ import annotations

import re
from functools import reduce

import numpy as np
import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch.columnar.batch import (ListColumn, MapColumn,
                                            PrimitiveColumn, StringColumn,
                                            StringListColumn,
                                            StringMapColumn, pad_list_elems)
from auron_tpu_torch.columnar.schema import DataType, Field
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import (TypedValue, cast_value, common_type,
                                        infer_dtype, infer_field)
from auron_tpu_torch.exprs.functions import register
from auron_tpu_torch.exprs.host import decode, host_map
from auron_tpu_torch.ops.hashing import nan_aware_eq
from auron_tpu_torch.ops.strings import string_be_words
from auron_tpu_torch.utils.shapes import bucket_string_width


def _list_result(expr, schema):
    return DataType.LIST, 0, 0


def elem_dtype_of(a: ir.Expr, schema) -> DataType:
    """Static element type of an array- or map-valued expression."""
    if isinstance(a, ir.ScalarFunction):
        if a.name in ("array", "array_repeat") and a.args:
            return infer_dtype(a.args[0], schema)[0]
        if a.name in ("sort_array", "array_distinct", "array_union",
                      "array_intersect", "array_except"):
            return elem_dtype_of(a.args[0], schema)
        if a.name == "split":
            return DataType.STRING
        if a.name in ("map_keys", "map_values"):
            m = a.args[0]
            k = 0 if a.name == "map_keys" else 1
            if isinstance(m, ir.ScalarFunction) and m.name == "map" \
                    and m.args:
                return infer_dtype(m.args[k], schema)[0]
            if isinstance(m, ir.ScalarFunction) \
                    and m.name == "map_from_arrays":
                return elem_dtype_of(m.args[k], schema)
    if isinstance(a, ir.ColumnRef):
        return schema[a.index].elem
    return DataType.INT64


def _elem_dtype(expr, schema) -> DataType:
    """Element type of the function's first (array) argument."""
    return elem_dtype_of(expr.args[0], schema)


def _elem_result(expr, schema):
    return _elem_dtype(expr, schema), 0, 0


def _element_at_result(expr, schema):
    a = expr.args[0]
    if infer_dtype(a, schema)[0] == DataType.MAP:
        mf = _map_field(a, schema)
        if mf.elem is not None:
            return mf.elem, 0, 0
    return _elem_dtype(expr, schema), 0, 0


def _iota(n: int, device) -> torch.Tensor:
    return torch.arange(n, device=device)


def _in_len(col) -> torch.Tensor:
    """bool[cap, E]: the slots below each row's length."""
    return _iota(col.max_elems, col.lens.device)[None, :] \
        < col.lens[:, None]


def _ones(n: int, device) -> torch.Tensor:
    return torch.ones(n, dtype=torch.bool, device=device)


def _take(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``t[row, idx[row]]`` for a per-row index (trailing axes kept)."""
    ix = idx.to(torch.int64).reshape(-1, 1, *([1] * (t.dim() - 2)))
    ix = ix.expand(-1, 1, *t.shape[2:])
    return torch.gather(t, 1, ix)[:, 0]


def _take_along(t: torch.Tensor, order: torch.Tensor) -> torch.Tensor:
    """``t`` reordered along axis 1 by ``order[cap, E]``."""
    ix = order.reshape(*order.shape, *([1] * (t.dim() - 2)))
    return torch.gather(t, 1, ix.expand(*order.shape, *t.shape[2:]))


# ---------------------------------------------------------------------------
# arrays
# ---------------------------------------------------------------------------

@register("array", _list_result)
def _array(args, expr, batch, schema, ctx):
    """array(e1, ..., ek): a list of k elements per row."""
    n, dev = batch.capacity, batch.device
    if not args:
        return TypedValue(ListColumn(
            torch.zeros((n, 1), dtype=torch.int64, device=dev),
            torch.zeros((n, 1), dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev), _ones(n, dev)),
            DataType.LIST)
    if any(isinstance(a.col, StringColumn) for a in args):
        if not all(isinstance(a.col, StringColumn) for a in args):
            raise NotImplementedError("array() mixing STRING and non-"
                                      "STRING elements")
        w = max(a.col.width for a in args)
        chars = torch.stack([torch.nn.functional.pad(
            a.col.chars, (0, w - a.col.width)) for a in args], dim=1)
        return TypedValue(StringListColumn(
            chars, torch.stack([a.col.lens for a in args], dim=1),
            torch.stack([a.validity for a in args], dim=1),
            torch.full((n,), len(args), dtype=torch.int32, device=dev),
            _ones(n, dev)), DataType.LIST)
    target = args[0].dtype
    vals = [cast_value(a, target) if a.dtype != target else a for a in args]
    return TypedValue(ListColumn(
        torch.stack([v.data for v in vals], dim=1),
        torch.stack([v.validity for v in vals], dim=1),
        torch.full((n,), len(args), dtype=torch.int32, device=dev),
        _ones(n, dev)), DataType.LIST)


@register("size", DataType.INT32)
@register("cardinality", DataType.INT32)
def _size(args, expr, batch, schema, ctx):
    """The element count; -1 for a null list or map (Spark's legacy
    sizeOfNull)."""
    v = args[0]
    if not isinstance(v.col, (ListColumn, StringListColumn, MapColumn,
                              StringMapColumn)):
        raise TypeError("size() needs an array/map")
    out = torch.where(v.validity, v.col.lens, -1).to(torch.int32)
    return TypedValue(PrimitiveColumn(out, torch.ones_like(v.validity)),
                      DataType.INT32)


def _string_hits(chars, slens, nc: StringColumn) -> torch.Tensor:
    """bool[cap, E]: element strings equal to each row's needle."""
    w = max(chars.shape[2], nc.width)
    ch = torch.nn.functional.pad(chars, (0, w - chars.shape[2]))
    nh = torch.nn.functional.pad(nc.chars, (0, w - nc.width))
    return (ch == nh[:, None, :]).all(dim=2) & (slens == nc.lens[:, None])


@register("array_contains", DataType.BOOL)
def _array_contains(args, expr, batch, schema, ctx):
    """Spark's three-valued contains: no match but a null element in the
    list is null, not false."""
    arr, needle = args
    col = arr.col
    in_list = _in_len(col)
    if isinstance(col, StringListColumn):
        if not isinstance(needle.col, StringColumn):
            raise NotImplementedError(
                "array_contains over array<string> needs a STRING needle")
        same = _string_hits(col.chars, col.slens, needle.col)
    else:
        if isinstance(needle.col, StringColumn):
            raise NotImplementedError("array_contains with STRING needle")
        same = nan_aware_eq(col.values, needle.data[:, None])
    hit = (same & col.elem_valid & in_list).any(dim=1)
    has_null_elem = (~col.elem_valid & in_list).any(dim=1)
    return TypedValue(PrimitiveColumn(
        hit, arr.validity & needle.validity & (hit | ~has_null_elem)),
        DataType.BOOL)


@register("array_position", DataType.INT64)
def _array_position(args, expr, batch, schema, ctx):
    """The 1-based position of the first match, 0 when none."""
    arr, needle = args
    col = arr.col
    eq = nan_aware_eq(col.values, needle.data[:, None]) \
        & col.elem_valid & _in_len(col)
    first = torch.argmax(eq.to(torch.int8), dim=1)
    pos = torch.where(eq.any(dim=1), first + 1, 0).to(torch.int64)
    return TypedValue(PrimitiveColumn(pos, arr.validity & needle.validity),
                      DataType.INT64)


@register("element_at", _element_at_result)
@register("get_map_value", _element_at_result)
def _element_at(args, expr, batch, schema, ctx):
    """arr[i], 1-based, negative from the end, null out of range; or a
    map's value at a key."""
    v = args[0]
    if isinstance(v.col, (MapColumn, StringMapColumn)):
        return _map_get(v, args[1], expr, schema)
    col = v.col
    idx = cast_value(args[1], DataType.INT32).data
    zero = torch.where(idx > 0, idx - 1, col.lens + idx)
    in_range = (zero >= 0) & (zero < col.lens)
    zi = zero.clamp(0, col.max_elems - 1)
    valid = v.validity & in_range & _take(col.elem_valid, zi)
    if isinstance(col, StringListColumn):
        return TypedValue(StringColumn(
            _take(col.chars, zi), torch.where(valid, _take(col.slens, zi),
                                              0), valid), DataType.STRING)
    return TypedValue(PrimitiveColumn(_take(col.values, zi), valid),
                      _elem_dtype(expr, schema))


def _array_minmax(args, expr, schema, largest: bool):
    v = args[0]
    col = v.col
    live = _in_len(col) & col.elem_valid
    dt = col.values.dtype
    if dt.is_floating_point:
        neutral = float("-inf") if largest else float("inf")
    else:
        info = torch.iinfo(dt)
        neutral = info.min if largest else info.max
    masked = torch.where(live, col.values,
                         torch.tensor(neutral, dtype=dt,
                                      device=col.values.device))
    data = masked.amax(dim=1) if largest else masked.amin(dim=1)
    return TypedValue(PrimitiveColumn(data, v.validity & live.any(dim=1)),
                      _elem_dtype(expr, schema))


@register("array_max", _elem_result)
def _array_max(args, expr, batch, schema, ctx):
    return _array_minmax(args, expr, schema, largest=True)


@register("array_min", _elem_result)
def _array_min(args, expr, batch, schema, ctx):
    return _array_minmax(args, expr, schema, largest=False)


def _class_key(in_list, ev, asc: bool) -> torch.Tensor:
    """Spark's sort_array null placement as a class per slot: ascending
    nulls < values < padding, descending values < nulls < padding."""
    return torch.where(in_list & ~ev, 0 if asc else 1,
                       torch.where(in_list & ev, 1 if asc else 0, 2))


def _chain(order: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """One more stable sort pass: ``order`` re-sorted by ``key``."""
    k = _take_along(key, order)
    return _take_along(order, torch.argsort(k, dim=1, stable=True))


@register("sort_array", _list_result)
def _sort_array(args, expr, batch, schema, ctx):
    v = args[0]
    asc = True
    if len(expr.args) > 1 and isinstance(expr.args[1], ir.Literal):
        asc = bool(expr.args[1].value)
    col = v.col
    in_list = _in_len(col)
    cap, e = col.lens.shape[0], col.max_elems
    order = _iota(e, col.lens.device)[None, :].repeat(cap, 1)
    if isinstance(col, StringListColumn):
        words = string_be_words(col.chars.reshape(cap * e, col.width)) \
            .reshape(cap, e, -1)
        if not asc:
            words = ~words
        for k in range(words.shape[2] - 1, -1, -1):
            order = _chain(order, words[:, :, k])
        order = _chain(order, _class_key(in_list, col.elem_valid, asc))
        return TypedValue(StringListColumn(
            _take_along(col.chars, order), _take_along(col.slens, order),
            _take_along(col.elem_valid, order), col.lens, col.validity),
            DataType.LIST)
    # the value order first, then the class, both stable
    order = torch.argsort(col.values if asc else -col.values, dim=1,
                          stable=True)
    order = _chain(order, _class_key(in_list, col.elem_valid, asc))
    return TypedValue(ListColumn(_take_along(col.values, order),
                                 _take_along(col.elem_valid, order),
                                 col.lens, col.validity), DataType.LIST)


@register("array_repeat", _list_result)
def _array_repeat(args, expr, batch, schema, ctx):
    v = args[0]
    times = int(expr.args[1].value) if isinstance(expr.args[1], ir.Literal) \
        else 1
    times = max(times, 0)
    n, k = batch.capacity, max(times, 1)
    return TypedValue(ListColumn(
        v.data[:, None].expand(n, k).contiguous(),
        v.validity[:, None].expand(n, k).contiguous(),
        torch.full((n,), times, dtype=torch.int32, device=batch.device),
        _ones(n, batch.device)), DataType.LIST)


# ---------------------------------------------------------------------------
# maps
# ---------------------------------------------------------------------------

def _map_field(expr, schema) -> Field:
    """Result Field of a map-valued expression (key and value types)."""
    if isinstance(expr, ir.ColumnRef):
        return schema[expr.index]
    if not isinstance(expr, ir.ScalarFunction):
        raise TypeError(f"not a map expression: {expr!r}")
    if expr.name in ("map", "create_map"):
        k = reduce(common_type, [infer_dtype(e, schema)[0]
                                 for e in expr.args[0::2]])
        v = reduce(common_type, [infer_dtype(e, schema)[0]
                                 for e in expr.args[1::2]])
        return Field("m", DataType.MAP, True, key=k, elem=v)
    if expr.name == "map_from_arrays":
        return Field("m", DataType.MAP, True,
                     key=elem_dtype_of(expr.args[0], schema),
                     elem=elem_dtype_of(expr.args[1], schema))
    if expr.name == "map_concat":
        return _map_field(expr.args[0], schema)
    if expr.name == "map_from_entries":
        return _map_from_entries_field(expr, schema)
    return infer_field(expr, schema)


def _map_result(expr, schema):
    return DataType.MAP, 0, 0


def _key_dedup_policy() -> str:
    policy = cfg.get_config().get(cfg.MAP_KEY_DEDUP_POLICY)
    if policy not in ("LAST_WIN", "EXCEPTION"):
        raise ValueError(
            f"auron.map.key_dedup_policy: unknown policy {policy!r} "
            "(LAST_WIN|EXCEPTION)")
    return policy


def _dedupe_last_wins(keys, values, vev, lens, row_valid):
    """Resolve duplicate map keys: LAST_WIN drops entry i when a later
    in-range entry has its key and compacts the rest left; EXCEPTION
    raises when a valid row holds a duplicate. Returns (keys, values,
    value_valid, lens, row_valid)."""
    m = keys.shape[1]
    jj = _iota(m, keys.device)
    in_rng = jj[None, :] < lens[:, None]
    same = keys[:, :, None] == keys[:, None, :]
    later = jj[None, None, :] > jj[None, :, None]
    dup = (same & later & in_rng[:, None, :]).any(dim=2)
    if _key_dedup_policy() == "EXCEPTION":
        from auron_tpu_torch.ops.base import host_readback
        (has_dup,) = host_readback([((dup & in_rng).any(dim=1)
                                     & row_valid).any()])
        if has_dup:
            raise ValueError(
                "duplicate map key (auron.map.key_dedup_policy="
                "EXCEPTION; set LAST_WIN to keep the last entry)")
    keep = in_rng & ~dup
    order = torch.argsort((~keep).to(torch.int8), dim=1, stable=True)
    lens = keep.sum(dim=1).to(torch.int32)
    return (_take_along(keys, order), _take_along(values, order),
            _take_along(vev & keep, order),
            torch.where(row_valid, lens, 0), row_valid)


def _reject_unsupported_map_args(name, args, expr, schema):
    if any(isinstance(a.col, StringColumn) for a in args):
        raise NotImplementedError(
            f"{name}() over STRING keys/values: no string map "
            "materialization")
    for a in expr.args:
        if infer_dtype(a, schema)[0] == DataType.DECIMAL:
            raise NotImplementedError(
                f"{name}() over DECIMAL keys/values: map element types "
                "carry no precision/scale; cast to double first")


@register("map", _map_result, result_field=_map_field)
@register("create_map", _map_result, result_field=_map_field)
@register("map_from_arrays", _map_result, result_field=_map_field)
def _map(args, expr, batch, schema, ctx):
    if expr.name == "map_from_arrays":
        karr, varr = args
        for a in expr.args:
            if elem_dtype_of(a, schema) == DataType.DECIMAL:
                raise NotImplementedError(
                    "map_from_arrays over DECIMAL elements: map element "
                    "types carry no precision/scale; cast to double first")
        m = max(karr.col.max_elems, varr.col.max_elems)
        kcol = pad_list_elems(karr.col, m)
        vcol = pad_list_elems(varr.col, m)
        # a null key or a length mismatch nulls the row
        ok = (karr.validity & varr.validity & (kcol.lens == vcol.lens)
              & ~(_in_len(kcol) & ~kcol.elem_valid).any(dim=1))
        kv, vv, vev, lens, ok = _dedupe_last_wins(
            kcol.values, vcol.values, vcol.elem_valid,
            torch.where(ok, kcol.lens, 0), ok)
        return TypedValue(MapColumn(kv, vv, vev, lens, ok), DataType.MAP)
    if not args or len(args) % 2:
        raise ValueError("map() needs key/value pairs")
    _reject_unsupported_map_args("map", args, expr, schema)
    keys, vals = args[0::2], args[1::2]
    kt = reduce(common_type, [a.dtype for a in keys])
    vt = reduce(common_type, [a.dtype for a in vals])
    keys = [cast_value(a, kt) if a.dtype != kt else a for a in keys]
    vals = [cast_value(a, vt) if a.dtype != vt else a for a in vals]
    ok = torch.stack([x.validity for x in keys], dim=1).all(dim=1)
    kv, vv, vev, lens, ok = _dedupe_last_wins(
        torch.stack([x.data for x in keys], dim=1),
        torch.stack([x.data for x in vals], dim=1),
        torch.stack([x.validity for x in vals], dim=1),
        torch.where(ok, len(keys), 0).to(torch.int32), ok)
    return TypedValue(MapColumn(kv, vv, vev, lens, ok), DataType.MAP)


def _map_keys_field(expr, schema):
    return Field("c", DataType.LIST, True,
                 elem=_map_field(expr.args[0], schema).key)


def _map_values_field(expr, schema):
    return Field("c", DataType.LIST, True,
                 elem=_map_field(expr.args[0], schema).elem)


@register("map_keys", _list_result, result_field=_map_keys_field)
def _map_keys(args, expr, batch, schema, ctx):
    m = args[0].col
    if isinstance(m, StringMapColumn):
        return TypedValue(StringListColumn(m.kchars, m.kslens, _in_len(m),
                                           m.lens, args[0].validity),
                          DataType.LIST)
    return TypedValue(ListColumn(m.keys, _in_len(m), m.lens,
                                 args[0].validity), DataType.LIST)


@register("map_values", _list_result, result_field=_map_values_field)
def _map_values(args, expr, batch, schema, ctx):
    m = args[0].col
    if isinstance(m, StringMapColumn):
        return TypedValue(StringListColumn(
            m.vchars, m.vslens, m.val_valid & _in_len(m), m.lens,
            args[0].validity), DataType.LIST)
    return TypedValue(ListColumn(m.values, m.val_valid & _in_len(m),
                                 m.lens, args[0].validity), DataType.LIST)


def _map_entries_field(expr, schema):
    mf = _map_field(expr.args[0], schema)
    if DataType.STRING in (mf.key, mf.elem):
        raise NotImplementedError(
            "map_entries over map<string,...>: no string entry-struct "
            "materialization")
    return Field("c", DataType.LIST, True, elem=DataType.STRUCT,
                 children=(Field("key", mf.key, False),
                           Field("value", mf.elem, True)))


@register("map_entries", _list_result, result_field=_map_entries_field)
def _map_entries(args, expr, batch, schema, ctx):
    """map → array<struct<key, value>> in entry order: the MapColumn
    layout is the entry list's, so this re-types the carrier."""
    m = args[0].col
    if isinstance(m, StringMapColumn):
        raise NotImplementedError(
            "map_entries over map<string,string>: no string entry-struct "
            "materialization")
    return TypedValue(MapColumn(m.keys, m.values, m.val_valid, m.lens,
                                args[0].validity), DataType.LIST)


def _map_from_entries_field(expr, schema):
    ef = infer_field(expr.args[0], schema)
    if ef.dtype != DataType.LIST or ef.elem != DataType.STRUCT \
            or len(ef.children) != 2:
        raise NotImplementedError(
            f"map_from_entries over {ef.dtype.value}: needs "
            "array<struct<key,value>>")
    kf, vf = ef.children
    if DataType.DECIMAL in (kf.dtype, vf.dtype):
        raise NotImplementedError(
            "map_from_entries over DECIMAL entry children: map element "
            "types carry no precision/scale; cast to double first")
    return Field("m", DataType.MAP, True, key=kf.dtype, elem=vf.dtype)


@register("map_from_entries", _map_result,
          result_field=_map_from_entries_field)
def _map_from_entries(args, expr, batch, schema, ctx):
    _map_from_entries_field(expr, schema)   # the typed refusals
    m = args[0].col
    if not isinstance(m, MapColumn):
        raise NotImplementedError(
            "map_from_entries needs an array<struct<key,value>> entry "
            "list")
    kv, vv, vev, lens, ok = _dedupe_last_wins(
        m.keys, m.values, m.val_valid,
        torch.where(args[0].validity, m.lens, 0), args[0].validity)
    return TypedValue(MapColumn(kv, vv, vev, lens, ok), DataType.MAP)


@register("map_contains_key", DataType.BOOL)
def _map_contains_key(args, expr, batch, schema, ctx):
    v, key = args
    m = v.col
    if isinstance(m, StringMapColumn):
        if not isinstance(key.col, StringColumn):
            raise NotImplementedError(
                "map_contains_key over map<string,..> needs a STRING key")
        hit = (_string_hits(m.kchars, m.kslens, key.col)
               & _in_len(m)).any(dim=1)
    else:
        hit = ((m.keys == key.data[:, None]) & _in_len(m)).any(dim=1)
    return TypedValue(PrimitiveColumn(hit, v.validity & key.validity),
                      DataType.BOOL)


@register("map_concat", _map_result, result_field=_map_field)
def _map_concat(args, expr, batch, schema, ctx):
    """Concatenate maps' entries, duplicate keys LAST_WIN (the later
    argument, the later entry)."""
    out = args[0]
    for nxt in args[1:]:
        a, b = out.col, nxt.col
        cap, m = a.capacity, a.max_elems + b.max_elems
        dev = a.lens.device
        # each of b's in-range slots lands right after a's entries; its
        # other slots go to one sink column that is then cut
        jb = _iota(b.max_elems, dev)[None, :]
        tgt = torch.where(_in_len(b), a.lens[:, None].to(torch.int64) + jb,
                          m).expand(cap, -1)

        def splice(xa, xb, fill=0):
            buf = torch.full((cap, m + 1), fill, dtype=xa.dtype, device=dev)
            buf[:, :a.max_elems] = torch.where(_in_len(a), xa,
                                               torch.tensor(fill).to(xa))
            return buf.scatter(1, tgt, xb)[:, :m]

        ok = out.validity & nxt.validity
        keys, values, vev, lens, ok = _dedupe_last_wins(
            splice(a.keys, b.keys), splice(a.values, b.values),
            splice(a.val_valid, b.val_valid, False),
            torch.where(ok, a.lens + b.lens, 0), ok)
        out = TypedValue(MapColumn(keys, values, vev, lens, ok),
                         DataType.MAP)
    return out


def _last_hit(hit: torch.Tensor) -> torch.Tensor:
    """The index of each row's last True (the last matching key wins)."""
    m = hit.shape[1]
    return (m - 1 - torch.argmax(hit.flip(1).to(torch.int8), dim=1)) \
        .clamp(0, m - 1)


def _map_get(v: TypedValue, key: TypedValue, expr, schema) -> TypedValue:
    """map[key]; the last matching key wins, as in Spark."""
    if isinstance(v.col, StringMapColumn):
        return _string_map_get(v, key)
    if isinstance(key.col, StringColumn):
        raise NotImplementedError("map lookup with STRING key")
    m = v.col
    eq = (m.keys == key.data[:, None]) & _in_len(m)
    li = _last_hit(eq)
    mf = _map_field(expr.args[0], schema) if expr is not None else None
    dt = mf.elem if mf is not None and mf.elem is not None else (
        DataType.FLOAT64 if m.values.dtype.is_floating_point
        else DataType.INT64)
    return TypedValue(PrimitiveColumn(
        _take(m.values, li),
        v.validity & key.validity & eq.any(dim=1) & _take(m.val_valid, li)),
        dt)


def _string_map_get(v: TypedValue, key: TypedValue) -> TypedValue:
    """map<string, string> lookup by a string key."""
    col = v.col
    if not isinstance(key.col, StringColumn):
        raise NotImplementedError("string-map lookup needs a STRING key")
    hit = _string_hits(col.kchars, col.kslens, key.col) & _in_len(col)
    li = _last_hit(hit)
    valid = v.validity & key.validity & hit.any(dim=1) \
        & _take(col.val_valid, li)
    return TypedValue(StringColumn(
        _take(col.vchars, li), torch.where(valid, _take(col.vslens, li), 0),
        valid), DataType.STRING)


# ---------------------------------------------------------------------------
# array set operations (Spark's ArrayDistinct, ArrayUnion, ArrayIntersect,
# ArrayExcept and ArraysOverlap)
# ---------------------------------------------------------------------------

def _elem_eq_cross(av, ae, bv, be) -> torch.Tensor:
    """[cap, Ea, Eb] element equality: both valid and equal (NaN equal to
    NaN), or both null."""
    eq = nan_aware_eq(av[:, :, None], bv[:, None, :])
    both_valid = ae[:, :, None] & be[:, None, :]
    both_null = ~ae[:, :, None] & ~be[:, None, :]
    return (both_valid & eq) | both_null


def _first_occurrence(values, ev, in_list) -> torch.Tensor:
    """bool[cap, E]: an in-list element no equal element precedes."""
    e = values.shape[1]
    eq = _elem_eq_cross(values, ev, values, ev)
    lower = torch.tril(torch.ones((e, e), dtype=torch.bool,
                                  device=values.device), diagonal=-1)
    dup = (eq & in_list[:, None, :] & lower[None, :, :]).any(dim=2)
    return in_list & ~dup


def _member_of(av, ae, bv, be, b_in) -> torch.Tensor:
    """bool[cap, Ea]: a's element occurs among b's in-list elements."""
    return (_elem_eq_cross(av, ae, bv, be) & b_in[:, None, :]).any(dim=2)


def _compact_elems(values, ev, keep):
    """Kept elements left-compacted in their order: one scatter into an
    extra sink column that is then cut."""
    cap, e = values.shape
    pos = torch.cumsum(keep, dim=1) - 1
    tgt = torch.where(keep, pos, e)
    out_v = torch.zeros((cap, e + 1), dtype=values.dtype,
                        device=values.device).scatter(1, tgt, values)
    out_e = torch.zeros((cap, e + 1), dtype=torch.bool,
                        device=values.device).scatter(1, tgt, ev & keep)
    return out_v[:, :e], out_e[:, :e], keep.sum(dim=1).to(torch.int32)


@register("array_distinct", _list_result)
def _array_distinct(args, expr, batch, schema, ctx):
    col = args[0].col
    keep = _first_occurrence(col.values, col.elem_valid, _in_len(col))
    v, ev, lens = _compact_elems(col.values, col.elem_valid, keep)
    return TypedValue(ListColumn(v, ev, lens, col.validity), DataType.LIST)


@register("array_union", _list_result)
def _array_union(args, expr, batch, schema, ctx):
    a, b = args[0].col, args[1].col
    values = torch.cat([a.values, b.values], dim=1)
    ev = torch.cat([a.elem_valid, b.elem_valid], dim=1)
    in_list = torch.cat([_in_len(a), _in_len(b)], dim=1)
    keep = _first_occurrence(values, ev, in_list)
    v, e2, lens = _compact_elems(values, ev, keep)
    return TypedValue(ListColumn(v, e2, lens, a.validity & b.validity),
                      DataType.LIST)


def _intersect_or_except(args, member: bool) -> TypedValue:
    a, b = args[0].col, args[1].col
    hit = _member_of(a.values, a.elem_valid, b.values, b.elem_valid,
                     _in_len(b))
    keep = _first_occurrence(a.values, a.elem_valid, _in_len(a)) \
        & (hit if member else ~hit)
    v, ev, lens = _compact_elems(a.values, a.elem_valid, keep)
    return TypedValue(ListColumn(v, ev, lens, a.validity & b.validity),
                      DataType.LIST)


@register("array_intersect", _list_result)
def _array_intersect(args, expr, batch, schema, ctx):
    return _intersect_or_except(args, member=True)


@register("array_except", _list_result)
def _array_except(args, expr, batch, schema, ctx):
    return _intersect_or_except(args, member=False)


@register("arrays_overlap", DataType.BOOL)
def _arrays_overlap(args, expr, batch, schema, ctx):
    """Spark's three-valued overlap: a common non-null element is true;
    else, both non-empty and a null element on either side is null; else
    false."""
    a, b = args[0].col, args[1].col
    a_in, b_in = _in_len(a), _in_len(b)
    eq = nan_aware_eq(a.values[:, :, None], b.values[:, None, :]) \
        & a.elem_valid[:, :, None] & b.elem_valid[:, None, :] \
        & a_in[:, :, None] & b_in[:, None, :]
    hit = eq.flatten(1).any(dim=1)
    has_null = (~a.elem_valid & a_in).any(dim=1) \
        | (~b.elem_valid & b_in).any(dim=1)
    unknown = ~hit & (a.lens > 0) & (b.lens > 0) & has_null
    return TypedValue(PrimitiveColumn(
        hit, args[0].validity & args[1].validity & ~unknown), DataType.BOOL)


# ---------------------------------------------------------------------------
# host string functions: split, array_join, str_to_map
# ---------------------------------------------------------------------------

def _put(buf: np.ndarray, i, j, b: bytes) -> None:
    buf[i, j, :len(b)] = np.frombuffer(b, np.uint8)


@register("split", _list_result)
def _split(args, expr, batch, schema, ctx):
    """split(str, regex[, limit]) → array<string>, Java's regex split:
    limit <= 0 keeps every part (Spark's -1), a zero-width match at 0
    makes no empty leading part, and an empty regex drops the trailing
    empty one (Spark 3.4+)."""
    v = args[0]
    col = v.col
    if not isinstance(col, StringColumn):
        raise NotImplementedError("split() needs a STRING input")
    pat = expr.args[1]
    if not isinstance(pat, ir.Literal) or pat.value is None:
        raise NotImplementedError("split(): the regex must be a literal")
    pattern = re.compile(str(pat.value))
    zero_width = pattern.match("") is not None
    limit = -1
    if len(expr.args) > 2 and isinstance(expr.args[2], ir.Literal) \
            and expr.args[2].value is not None:
        limit = int(expr.args[2].value)
    cap, w = col.chars.shape
    # a W-byte string splits into at most W + 1 parts; the element budget
    # is capped, and a row past it fails rather than truncates
    max_e = min(w + 1, 64) if limit <= 0 else min(limit, w + 1)
    out_w = bucket_string_width(max(w, 1))

    def host(n, chars_np, lens_np, valid_np):
        chars = np.zeros((cap, max_e, out_w), np.uint8)
        slens = np.zeros((cap, max_e), np.int32)
        ev = np.zeros((cap, max_e), bool)
        lens = np.zeros(cap, np.int32)
        for i in np.flatnonzero(valid_np[:n]):
            s = decode(chars_np, lens_np, i)
            parts = pattern.split(s) if limit <= 0 \
                else pattern.split(s, maxsplit=limit - 1)
            if zero_width and parts and parts[0] == "":
                parts = parts[1:]
            if zero_width and parts and parts[-1] == "":
                parts = parts[:-1]
            if len(parts) > max_e:
                raise ValueError(
                    f"split() produced {len(parts)} parts; the static "
                    f"element budget is {max_e} — pass an explicit limit")
            lens[i] = len(parts)
            for j, p in enumerate(parts):
                b = p.encode()[:out_w]
                _put(chars, i, j, b)
                slens[i, j] = len(b)
                ev[i, j] = True
        return chars, slens, ev, lens

    chars, slens, ev, lens = host_map(
        host, [col.chars, col.lens, v.validity], batch.num_rows,
        [(np.uint8, (max_e, out_w)), (np.int32, (max_e,)),
         (np.bool_, (max_e,)), (np.int32, ())], batch.device)
    return TypedValue(StringListColumn(chars, slens, ev, lens, v.validity),
                      DataType.LIST)


@register("array_join", DataType.STRING)
def _array_join(args, expr, batch, schema, ctx):
    """array_join(arr, sep[, null_replacement]): null elements are
    skipped unless a replacement is given; a null separator gives
    null."""
    v = args[0]
    col = v.col
    if not isinstance(col, StringListColumn):
        raise NotImplementedError("array_join() needs an array<string>")
    sep = expr.args[1]
    if not isinstance(sep, ir.Literal):
        raise NotImplementedError("array_join(): separator must be literal")
    cap = col.capacity
    if sep.value is None:
        dev = col.lens.device
        return TypedValue(StringColumn(
            torch.zeros((cap, 8), dtype=torch.uint8, device=dev),
            torch.zeros(cap, dtype=torch.int32, device=dev),
            torch.zeros(cap, dtype=torch.bool, device=dev)), DataType.STRING)
    sep_s = str(sep.value)
    repl = None
    if len(expr.args) > 2 and isinstance(expr.args[2], ir.Literal) \
            and expr.args[2].value is not None:
        repl = str(expr.args[2].value)
    m, w = col.max_elems, col.width
    repl_w = len(repl.encode()) if repl is not None else 0
    out_w = bucket_string_width(
        min(m * (max(w, repl_w) + len(sep_s.encode())) + 8, 4096))

    def host(n, chars_np, slens_np, ev_np, lens_np, valid_np):
        chars = np.zeros((cap, out_w), np.uint8)
        lens = np.zeros(cap, np.int32)
        for i in np.flatnonzero(valid_np[:n]):
            parts = []
            for j in range(lens_np[i]):
                if ev_np[i, j]:
                    parts.append(bytes(chars_np[i, j, :slens_np[i, j]])
                                 .decode("utf-8", "replace"))
                elif repl is not None:
                    parts.append(repl)
            b = sep_s.join(parts).encode()
            if len(b) > out_w:
                raise ValueError(
                    f"array_join() produced {len(b)} bytes; the static "
                    f"width budget is {out_w}")
            chars[i, :len(b)] = np.frombuffer(b, np.uint8)
            lens[i] = len(b)
        return chars, lens

    chars, lens = host_map(
        host, [col.chars, col.slens, col.elem_valid, col.lens, v.validity],
        batch.num_rows, [(np.uint8, (out_w,)), (np.int32, ())],
        batch.device)
    return TypedValue(StringColumn(chars, lens, v.validity), DataType.STRING)


def _str_to_map_field(expr, schema):
    return Field("m", DataType.MAP, True, key=DataType.STRING,
                 elem=DataType.STRING)


@register("str_to_map", DataType.MAP, result_field=_str_to_map_field)
def _str_to_map(args, expr, batch, schema, ctx):
    """str_to_map(text[, pairDelim[, keyValueDelim]]): regex delimiters
    (Spark's defaults ',' and ':'), duplicate keys LAST_WIN, a pair
    without the key-value delimiter maps its key to null."""
    v = args[0]
    col = v.col
    if not isinstance(col, StringColumn):
        raise NotImplementedError("str_to_map() needs a STRING input")

    def delim(k, default):
        if len(expr.args) > k:
            a = expr.args[k]
            if not isinstance(a, ir.Literal) or a.value is None:
                raise NotImplementedError(
                    "str_to_map(): delimiters must be literals")
            return str(a.value)
        return default

    pair_re = re.compile(delim(1, ","))
    kv_re = re.compile(delim(2, ":"))
    cap, w = col.chars.shape
    max_e = min(w + 1, 64)
    out_w = bucket_string_width(max(w, 1))

    def host(n, chars_np, lens_np, valid_np):
        kchars = np.zeros((cap, max_e, out_w), np.uint8)
        kslens = np.zeros((cap, max_e), np.int32)
        vchars = np.zeros((cap, max_e, out_w), np.uint8)
        vslens = np.zeros((cap, max_e), np.int32)
        vv = np.zeros((cap, max_e), bool)
        lens = np.zeros(cap, np.int32)
        for i in np.flatnonzero(valid_np[:n]):
            entries = {}
            for pair in pair_re.split(decode(chars_np, lens_np, i)):
                kv = kv_re.split(pair, maxsplit=1)
                entries[kv[0]] = kv[1] if len(kv) > 1 else None
            if len(entries) > max_e:
                raise ValueError(
                    f"str_to_map() produced {len(entries)} entries; the "
                    f"static budget is {max_e}")
            lens[i] = len(entries)
            for j, (k, val) in enumerate(entries.items()):
                kb = k.encode()[:out_w]
                _put(kchars, i, j, kb)
                kslens[i, j] = len(kb)
                if val is not None:
                    vb = val.encode()[:out_w]
                    _put(vchars, i, j, vb)
                    vslens[i, j] = len(vb)
                    vv[i, j] = True
        return kchars, kslens, vchars, vslens, vv, lens

    kchars, kslens, vchars, vslens, vv, lens = host_map(
        host, [col.chars, col.lens, v.validity], batch.num_rows,
        [(np.uint8, (max_e, out_w)), (np.int32, (max_e,)),
         (np.uint8, (max_e, out_w)), (np.int32, (max_e,)),
         (np.bool_, (max_e,)), (np.int32, ())], batch.device)
    return TypedValue(StringMapColumn(kchars, kslens, vchars, vslens, vv,
                                      lens, v.validity), DataType.MAP)
