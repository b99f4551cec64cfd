"""GenerateOp: explode, posexplode and json_tuple.

The port of ``auron_tpu.ops.generate``. An explode over a padded list is
one mask and one compact: the [capacity, max_elems] element matrix
flattens to capacity * max_elems slots, the slots past each list's
length (and the rows past the batch's) drop, and the pass-through
columns follow by a gather of the row index. ``outer`` keeps one slot,
a null element (and a null position), for a null or an empty list.
``json_tuple`` is the reference's host generator: the batch goes to
Arrow, Python's ``json`` reads each row, and the result comes back in
one upload. A UDTF needs the UDF registry of ROADMAP item 17b and
raises naming it.
"""

from __future__ import annotations

import json
from typing import Iterator, Optional

import torch

from auron_tpu_torch.columnar.batch import (Decimal128Column, DeviceBatch,
                                            ListColumn, MapColumn,
                                            PrimitiveColumn, StringColumn,
                                            StringListColumn, compact,
                                            gather_column)
from auron_tpu_torch.columnar.schema import DataType, Field, Schema
from auron_tpu_torch.exprs import ir
from auron_tpu_torch.exprs.eval import EvalContext, evaluate, infer_field
from auron_tpu_torch.ops.base import (ExecContext, PhysicalOp, count_output,
                                      timer)
from auron_tpu_torch.utils.shapes import bucket_rows


def element_field(generator: ir.Expr, schema: Schema) -> Field:
    """The ``col`` field an explode of ``generator`` yields: the list's
    element type (a decimal keeps the list's precision and scale)."""
    f = infer_field(generator, schema)
    if f.dtype != DataType.LIST:
        raise TypeError("explode generator must be a list")
    elem = f.elem or DataType.INT64
    if elem == DataType.DECIMAL:
        return Field("col", elem, True, f.precision or 38, f.scale)
    return Field("col", elem, True)


def explode(batch: DeviceBatch, col, pass_through, with_pos: bool,
            outer: bool) -> DeviceBatch:
    """Rows × list elements → one row per element, the pass-through
    columns of ``batch`` first, then the position (``with_pos``), then
    the element; capacity ``capacity * max_elems``."""
    cap, m = col.capacity, col.max_elems
    dev = col.lens.device
    flat_n = cap * m
    live = batch.row_mask()
    elem_idx = torch.arange(m, device=dev).repeat(cap)
    row_idx = torch.arange(cap, device=dev).repeat_interleave(m)
    keep = (elem_idx < col.lens[row_idx]) & live[row_idx]
    elem_valid = col.elem_valid.reshape(flat_n) if not isinstance(
        col, MapColumn) else col.val_valid.reshape(flat_n)
    outer_slot = torch.zeros(flat_n, dtype=torch.bool, device=dev)
    if outer:
        empty = (col.lens == 0) | ~col.validity
        outer_slot = (elem_idx == 0) & empty[row_idx] & live[row_idx]
        keep = keep | outer_slot
        elem_valid = elem_valid & ~outer_slot
    cols = [gather_column(batch.columns[i], row_idx, keep)
            for i in pass_through]
    if with_pos:
        cols.append(PrimitiveColumn(elem_idx.to(torch.int64),
                                    keep & ~outer_slot))
    ev = elem_valid & keep
    if isinstance(col, StringListColumn):
        cols.append(StringColumn(col.chars.reshape(flat_n, col.width),
                                 col.slens.reshape(flat_n), ev))
    elif isinstance(col, MapColumn):    # list<decimal(p > 18)>
        cols.append(Decimal128Column(col.keys.reshape(flat_n),
                                     col.values.reshape(flat_n), ev))
    else:
        cols.append(PrimitiveColumn(col.values.reshape(flat_n), ev))
    flat = DeviceBatch(tuple(cols), torch.full((), flat_n, dtype=torch.int32,
                                               device=dev))
    return compact(flat, keep)


class GenerateOp(PhysicalOp):
    name = "generate"

    def __init__(self, child: PhysicalOp, kind: str,
                 generator: Optional[ir.Expr] = None,
                 json_fields: Optional[list[str]] = None,
                 udtf_name: Optional[str] = None,
                 required_child_output: Optional[list[int]] = None,
                 outer: bool = False,
                 output_names: Optional[list[str]] = None):
        if kind not in ("explode", "posexplode", "json_tuple", "udtf"):
            raise ValueError(f"GenerateOp kind {kind!r}")
        if kind == "udtf":
            raise NotImplementedError(
                f"generate kind 'udtf' ({udtf_name!r}): host UDTFs need "
                "the UDF registry of ROADMAP item 17b")
        self.child = child
        self.kind = kind
        self.generator = generator
        self.json_fields = list(json_fields or [])
        self.outer = outer
        in_schema = child.schema()
        self.required_child_output = list(
            required_child_output if required_child_output is not None
            else range(len(in_schema)))
        gen_fields: list[Field] = []
        if kind in ("explode", "posexplode"):
            if kind == "posexplode":
                gen_fields.append(Field("pos", DataType.INT64, False))
            gen_fields.append(element_field(generator, in_schema))
        else:
            gen_fields = [Field(n, DataType.STRING, True)
                          for n in self.json_fields]
        if output_names:
            gen_fields = [f.with_name(n)
                          for f, n in zip(gen_fields, output_names)]
        self._schema = Schema(tuple(in_schema[i]
                                    for i in self.required_child_output)
                              + tuple(gen_fields))

    @property
    def children(self):
        return [self.child]

    def schema(self) -> Schema:
        return self._schema

    def _json_tuple_host(self, rb):
        """The json_tuple generator over one Arrow batch: the row count
        stays (bad JSON gives nulls), so pass-through columns are kept
        as they are."""
        import pyarrow as pa
        from auron_tpu_torch.columnar.arrow_bridge import schema_to_arrow
        texts = rb.column(self.generator.index).to_pylist()
        outs: list[list] = [[] for _ in self.json_fields]
        for t in texts:
            vals = [None] * len(self.json_fields)
            if t is not None:
                try:
                    obj = json.loads(t)
                    for j, f in enumerate(self.json_fields):
                        v = obj.get(f) if isinstance(obj, dict) else None
                        if v is not None and not isinstance(v, str):
                            v = json.dumps(v)
                        vals[j] = v
                except (ValueError, TypeError):
                    pass
            for j, v in enumerate(vals):
                outs[j].append(v)
        arrays = [rb.column(i) for i in self.required_child_output]
        arrays += [pa.array(o, pa.string()) for o in outs]
        return pa.RecordBatch.from_arrays(
            arrays, schema=schema_to_arrow(self._schema))

    def execute(self, partition: int,
                ctx: ExecContext) -> Iterator[DeviceBatch]:
        metrics = ctx.metrics_for(self)
        elapsed = metrics.counter("elapsed_compute")
        in_schema = self.child.schema()
        ectx = EvalContext(partition_id=partition)

        def stream():
            for batch in self.child.execute(partition, ctx):
                ctx.check_cancelled()
                if self.kind == "json_tuple":
                    from auron_tpu_torch.columnar.arrow_bridge import (
                        to_arrow, to_device)
                    with timer(elapsed):
                        out = self._json_tuple_host(to_arrow(batch,
                                                             in_schema))
                    if out.num_rows:
                        yield to_device(out,
                                        capacity=bucket_rows(out.num_rows),
                                        device=batch.device)[0]
                    continue
                with timer(elapsed):
                    v = evaluate(self.generator, batch, in_schema, ectx)
                    if not isinstance(v.col, (ListColumn, StringListColumn,
                                              MapColumn)):
                        raise TypeError("explode needs a list column")
                    out = explode(batch, v.col, self.required_child_output,
                                  self.kind == "posexplode", self.outer)
                yield out

        return count_output(stream(), metrics)

    def __repr__(self):
        return f"GenerateOp[{self.kind}, outer={self.outer}]"
