"""Result differ: a copy of ``auron_tpu.it.comparator``.

Row counts must match exactly; both sides are sorted canonically
(engine output order is unspecified); doubles compare with a relative
and an absolute tolerance, everything else exactly.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

#: float columns named with this prefix hold transcendental results (exp,
#: log, pow, trigonometric, hyperbolic, cbrt, hypot, atan2): they may
#: differ from the reference's, or between devices, by a few units in the
#: last place
ULP_PREFIX = "u_"

#: the units in the last place those columns may differ by: the largest
#: gap measured between torch's and XLA's CPU results is 7 (tanh)
ULP_BOUND = 8


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


def compare_cells(want, got):
    """Two pyarrow tables cell by cell, in row order: equal names and
    types, equal nulls, strings byte for byte, every other value exactly
    (floats bit for bit, NaN equal to NaN), but the float columns named
    with ``ULP_PREFIX``, which may differ by ``ULP_BOUND`` units in the
    last place. Returns (mismatch messages, {ulp column: largest difference
    in units in the last place})."""
    import numpy as np
    import pyarrow as pa
    bad, seen = [], {}
    if want.column_names != got.column_names or \
            want.num_rows != got.num_rows:
        return [f"shape {want.column_names}/{want.num_rows} != "
                f"{got.column_names}/{got.num_rows}"], seen
    for name in want.column_names:
        w, g = want[name].combine_chunks(), got[name].combine_chunks()
        if not w.type.equals(g.type):
            bad.append(f"{name}: type {w.type} != {g.type}")
            continue
        if not np.array_equal(w.is_null().to_numpy(zero_copy_only=False),
                              g.is_null().to_numpy(zero_copy_only=False)):
            bad.append(f"{name}: nulls differ")
            continue
        if pa.types.is_string(w.type):
            # a byte above 0x7F alone (chr) is not UTF-8: compare bytes
            w, g = w.cast(pa.binary()), g.cast(pa.binary())
        if not pa.types.is_floating(w.type):
            if not w.equals(g):
                bad.append(f"{name}: values differ")
            continue
        keep = ~w.is_null().to_numpy(zero_copy_only=False)
        wa = w.fill_null(0).to_numpy(zero_copy_only=False)[keep]
        ga = g.fill_null(0).to_numpy(zero_copy_only=False)[keep]
        if not np.array_equal(np.isnan(wa), np.isnan(ga)):
            bad.append(f"{name}: NaNs differ")
            continue
        real = ~np.isnan(wa)
        iv = np.int64 if wa.dtype == np.float64 else np.int32
        diff = np.abs(wa[real].view(iv).astype(np.int64)
                      - ga[real].view(iv).astype(np.int64))
        worst = int(diff.max(initial=0))
        limit = ULP_BOUND if name.startswith(ULP_PREFIX) else 0
        if limit:
            seen[name] = worst
        if worst > limit:
            bad.append(f"{name}: {worst} units in the last place apart "
                       f"(limit {limit})")
    return bad, seen
