"""Struct constructors and accessors: ``named_struct``, ``struct`` and
``get_struct_field``.

The port of ``auron_tpu.exprs.fn_structs``. A struct is a
``StructColumn``, its child columns and a row validity, so building one
packs the argument columns into a tuple and reading a field is a tuple
index with the struct's validity ANDed in. Field names and types live
in the result field (``infer_field``), never on the device.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import StructColumn
from auron_tpu_torch.columnar.schema import DataType, Field
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import TypedValue, infer_field
from auron_tpu_torch.exprs.functions import register


def _literal_name(e: ir.Expr, default: str) -> str:
    if isinstance(e, ir.Literal) and isinstance(e.value, str):
        return e.value
    return default


def _named_struct_field(expr, schema) -> Field:
    kids = []
    for i in range(0, len(expr.args), 2):
        nm = _literal_name(expr.args[i], f"col{i // 2}")
        kids.append(infer_field(expr.args[i + 1], schema, name=nm))
    return Field("c", DataType.STRUCT, True, children=tuple(kids))


def _struct_field(expr, schema) -> Field:
    kids = []
    for i, a in enumerate(expr.args):
        # Spark's naming: the source column's name for a plain reference,
        # else colN
        name = schema[a.index].name if isinstance(a, ir.ColumnRef) \
            else f"col{i + 1}"
        kids.append(infer_field(a, schema, name=name))
    return Field("c", DataType.STRUCT, True, children=tuple(kids))


def _struct_result(expr, schema):
    return DataType.STRUCT, 0, 0


def _all_valid(batch) -> torch.Tensor:
    return torch.ones(batch.capacity, dtype=torch.bool, device=batch.device)


@register("named_struct", _struct_result, result_field=_named_struct_field)
def _named_struct(args, expr, batch, schema, ctx):
    """named_struct(name1, val1, name2, val2, ...): the names are string
    literals read at plan time; only the values make columns."""
    if not args or len(args) % 2:
        raise ValueError("named_struct needs name/value pairs")
    kids = tuple(args[i].col for i in range(1, len(args), 2))
    return TypedValue(StructColumn(kids, _all_valid(batch)), DataType.STRUCT)


@register("struct", _struct_result, result_field=_struct_field)
def _struct(args, expr, batch, schema, ctx):
    return TypedValue(StructColumn(tuple(a.col for a in args),
                                   _all_valid(batch)), DataType.STRUCT)


def _field_index(expr, schema) -> int:
    """The ordinal of the field ``get_struct_field`` selects: by name for
    a string literal, else the literal ordinal."""
    sf = infer_field(expr.args[0], schema)
    sel = expr.args[1]
    if isinstance(sel, ir.Literal) and isinstance(sel.value, str):
        names = [cf.name for cf in sf.children]
        if sel.value not in names:
            raise KeyError(f"struct has no field {sel.value!r}")
        return names.index(sel.value)
    return int(sel.value)


def _get_struct_field_field(expr, schema) -> Field:
    return infer_field(expr.args[0], schema).children[
        _field_index(expr, schema)]


def _get_struct_field_result(expr, schema):
    f = _get_struct_field_field(expr, schema)
    return f.dtype, f.precision, f.scale


@register("get_struct_field", _get_struct_field_result,
          result_field=_get_struct_field_field)
def _get_struct_field(args, expr, batch, schema, ctx):
    """get_struct_field(struct, name_or_ordinal): the function form of
    ``GetStructField``; null where the struct is null."""
    v = args[0]
    if not isinstance(v.col, StructColumn):
        raise TypeError("get_struct_field needs a struct")
    idx = _field_index(expr, schema)
    cf = _get_struct_field_field(expr, schema)
    child = v.col.children[idx]
    return TypedValue(child.with_validity(child.validity & v.validity),
                      cf.dtype, cf.precision, cf.scale)
