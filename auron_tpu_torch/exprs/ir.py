"""Physical expression IR, the subset the port evaluates.

A copy of the scalar nodes of ``auron_tpu.exprs.ir``: frozen dataclass
trees, hashable and comparable, with the same fields, so a tree built for
one package reads the same in the other. The reference's bloom-filter
probe, scalar subquery, row-number, partition-id, monotonic-id and host
UDF nodes (ROADMAP item 17b) and struct field access (16f) are not here.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

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


@dataclass(frozen=True)
class Negative(Expr):
    child: Expr

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class CaseWhen(Expr):
    """CASE WHEN c1 THEN v1 ... ELSE e END; when_then pairs, else optional."""
    when_then: tuple[tuple[Expr, Expr], ...]
    otherwise: Optional[Expr] = None

    def children(self):
        out = []
        for w, t in self.when_then:
            out += [w, t]
        if self.otherwise is not None:
            out.append(self.otherwise)
        return tuple(out)


@dataclass(frozen=True)
class InList(Expr):
    child: Expr
    values: tuple[Any, ...]   # python scalars (non-null)
    negated: bool = False

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Cast(Expr):
    child: Expr
    dtype: DataType
    precision: int = 0
    scale: int = 0
    # try_cast: null on failure instead of error (reference: TryCast,
    # datafusion-ext-exprs/src/cast.rs)
    safe: bool = True

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class Like(Expr):
    """LIKE with a constant pattern; lowered to starts/ends/contains/regex."""
    child: Expr
    pattern: str
    negated: bool = False

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class StringStartsWith(Expr):
    child: Expr
    prefix: str

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class StringEndsWith(Expr):
    child: Expr
    suffix: str

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class StringContains(Expr):
    child: Expr
    infix: str

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class ScalarFunction(Expr):
    """Named scalar function from the registry (``exprs/functions.py``)."""
    name: str
    args: tuple[Expr, ...]
    # some functions need a target type/scale (e.g. make_decimal)
    dtype: Optional[DataType] = None
    precision: int = 0
    scale: int = 0

    def children(self):
        return self.args


@dataclass(frozen=True)
class GetIndexedField(Expr):
    """list[ordinal] element access, 0-based; the port evaluates it over
    ``split(...)`` only."""
    child: Expr
    ordinal: int

    def children(self):
        return (self.child,)


@dataclass(frozen=True)
class ScalarSubquery(Expr):
    """Uncorrelated scalar subquery: ``plan_bytes`` is a serialized
    PlanNode run once per task by ``ops/subquery.py``'s binder, whose one
    value replaces this node as a Literal before any operator runs. Held
    as bytes so the tree stays hashable; it has no expression children
    (the plan is opaque here). ``sid`` tells apart subqueries built
    separately and takes no part in resolution."""
    plan_bytes: bytes
    dtype: DataType
    precision: int = 0
    scale: int = 0
    sid: int = 0


@dataclass(frozen=True)
class SortOrder:
    expr: Expr
    ascending: bool = True
    nulls_first: bool = True


@dataclass(frozen=True)
class AggFunction:
    """One aggregate: fn in {sum,count,avg,min,max,first,first_ignores_null,
    count_star, bloom_filter, collect_list, collect_set}; the port's
    AggOp runs sum, count, count_star, avg, min, max and first."""
    fn: str
    arg: Optional[Expr] = None     # None for count(*)
    distinct: bool = False
    # bloom_filter sizing; 0 = engine defaults
    expected_items: int = 0
    fpp: float = 0.0
