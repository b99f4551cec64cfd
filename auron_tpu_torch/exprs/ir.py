"""Physical expression IR, the subset the ported slice evaluates.

A copy of the first nodes of ``auron_tpu.exprs.ir``: frozen dataclass
trees, hashable and comparable, with the same fields, so a tree built for
one package reads the same in the other.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

from auron_tpu_torch.columnar.schema import DataType


class Expr:
    """Base class; subclasses are frozen dataclasses."""

    def children(self) -> tuple["Expr", ...]:
        return ()


@dataclass(frozen=True)
class ColumnRef(Expr):
    """Bound reference to an input column by ordinal."""
    index: int
    # optional name for debugging only
    name: str = ""


@dataclass(frozen=True)
class Literal(Expr):
    value: Any           # python scalar; None for typed null
    dtype: DataType
    precision: int = 0   # decimal only
    scale: int = 0


@dataclass(frozen=True)
class BinaryExpr(Expr):
    """op in {+,-,*,/,%, ==,!=,<,<=,>,>=, and,or}."""
    op: str
    left: Expr
    right: Expr

    def children(self):
        return (self.left, self.right)


@dataclass(frozen=True)
class Not(Expr):
    child: Expr

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class IsNull(Expr):
    child: Expr

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class IsNotNull(Expr):
    child: Expr

    def children(self):
        return (self.child,)
