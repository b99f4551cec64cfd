"""Logical schema, kept host-side.

Device batches are bare tensors; the logical types (the analogue of the
Arrow schema that travels with every RecordBatch) live here and never
reach the device. A copy of ``auron_tpu.columnar.schema``: the same type
names and values, so a schema means the same in both packages.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import torch


class DataType(enum.Enum):
    BOOL = "bool"
    INT8 = "int8"
    INT16 = "int16"
    INT32 = "int32"
    INT64 = "int64"
    FLOAT32 = "float32"
    FLOAT64 = "float64"
    DATE32 = "date32"          # days since epoch, int32 payload
    TIMESTAMP_US = "timestamp_us"  # microseconds since epoch, int64 payload
    DECIMAL = "decimal"        # precision<=18 stored as scaled int64
    STRING = "string"
    LIST = "list"              # list of primitives; element type in Field.elem
    MAP = "map"                # primitive keys/values; types in Field.key/elem
    STRUCT = "struct"          # child fields in Field.children
    NULL = "null"

    @property
    def is_integer(self) -> bool:
        return self in (DataType.INT8, DataType.INT16, DataType.INT32,
                        DataType.INT64)

    @property
    def is_floating(self) -> bool:
        return self in (DataType.FLOAT32, DataType.FLOAT64)

    def to_torch(self) -> torch.dtype:
        return _TORCH[self]


# Physical payload of each fixed-width logical type (strings and nested
# types have none).
_TORCH = {
    DataType.BOOL: torch.bool,
    DataType.INT8: torch.int8,
    DataType.INT16: torch.int16,
    DataType.INT32: torch.int32,
    DataType.INT64: torch.int64,
    DataType.FLOAT32: torch.float32,
    DataType.FLOAT64: torch.float64,
    DataType.DATE32: torch.int32,
    DataType.TIMESTAMP_US: torch.int64,
    DataType.DECIMAL: torch.int64,
    DataType.NULL: torch.bool,
}


@dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    # decimal only
    precision: int = 0
    scale: int = 0
    # list element / map VALUE type (dtype in (LIST, MAP))
    elem: "DataType" = None
    # map KEY type (dtype == MAP)
    key: "DataType" = None
    # struct child fields (dtype == STRUCT)
    children: tuple = ()

    def with_name(self, name: str) -> "Field":
        return Field(name, self.dtype, self.nullable, self.precision,
                     self.scale, self.elem, self.key, self.children)


@dataclass(frozen=True)
class Schema:
    fields: tuple[Field, ...] = field(default_factory=tuple)

    def __post_init__(self):
        object.__setattr__(self, "fields", tuple(self.fields))

    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def __getitem__(self, i) -> Field:
        return self.fields[i]

    def index_of(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no field named {name!r} in {self.names}")

    @property
    def names(self) -> list[str]:
        return [f.name for f in self.fields]
