"""Result differ: a copy of ``auron_tpu.it.comparator``.

Row counts must match exactly; both sides are sorted canonically
(engine output order is unspecified); doubles compare with a relative
and an absolute tolerance, everything else exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass
class ComparisonResult:
    name: str
    ok: bool
    rows: int
    mismatches: list = field(default_factory=list)
    error: str = ""
    elapsed_s: float = 0.0

    def report(self) -> str:
        if self.ok:
            return f"[PASS] {self.name}: {self.rows} rows"
        if self.error:
            return f"[FAIL] {self.name}: {self.error}"
        head = "; ".join(str(m) for m in self.mismatches[:5])
        return (f"[FAIL] {self.name}: {len(self.mismatches)} mismatching "
                f"cells of {self.rows} rows — {head}")


class QueryResultComparator:
    def __init__(self, double_rel_tol: float = 1e-9,
                 double_abs_tol: float = 1e-9):
        self.rel = double_rel_tol
        self.abs = double_abs_tol

    @staticmethod
    def _cell_key(v):
        """Type-ranked, numeric sort key: None < numbers (by value, NaN
        last) < strings < other."""
        if v is None:
            return (0, 0, "")
        if isinstance(v, bool):
            return (1, 2, float(v))
        if isinstance(v, (int, float)):
            f = float(v)
            if math.isnan(f):
                return (1, 2, math.inf)
            return (1, 2, f)
        if isinstance(v, str):
            return (1, 3, v)
        return (1, 4, str(v))

    @classmethod
    def _canon_rows(cls, table) -> list[tuple]:
        rows = [tuple(r[c] for c in table.column_names)
                for r in table.to_pylist()]
        return sorted(rows, key=lambda row: tuple(cls._cell_key(v)
                                                  for v in row))

    def _cell_equal(self, a, b) -> bool:
        if a is None or b is None:
            return a is None and b is None
        if isinstance(a, float) or isinstance(b, float):
            if isinstance(a, float) and isinstance(b, float):
                if math.isnan(a) and math.isnan(b):
                    return True
            return math.isclose(float(a), float(b),
                                rel_tol=self.rel, abs_tol=self.abs)
        return a == b

    def compare(self, name: str, got, expected) -> ComparisonResult:
        """got / expected: pyarrow Tables with the same column names."""
        if set(got.column_names) != set(expected.column_names):
            return ComparisonResult(
                name, False, got.num_rows,
                error=f"column sets differ: {got.column_names} vs "
                      f"{expected.column_names}")
        expected = expected.select(got.column_names)
        if got.num_rows != expected.num_rows:
            return ComparisonResult(
                name, False, got.num_rows,
                error=f"row counts differ: {got.num_rows} vs "
                      f"{expected.num_rows}")
        g = self._canon_rows(got)
        e = self._canon_rows(expected)
        mismatches = []
        for i, (gr, er) in enumerate(zip(g, e)):
            for j, (gv, ev) in enumerate(zip(gr, er)):
                if not self._cell_equal(gv, ev):
                    mismatches.append((i, got.column_names[j], gv, ev))
                    if len(mismatches) > 20:
                        return ComparisonResult(name, False, got.num_rows,
                                                mismatches=mismatches)
        return ComparisonResult(name, not mismatches, got.num_rows,
                                mismatches=mismatches)
