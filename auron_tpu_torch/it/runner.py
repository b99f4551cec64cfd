"""Integration-harness runner of the port: one query through a fresh
``Session`` against its pandas oracle (the port of
``auron_tpu.it.runner.run_query``). The session runs on ``cuda`` unless
``device`` names another."""

from __future__ import annotations

import time
import traceback

from auron_tpu_torch.frontend.session import Session
from auron_tpu_torch.it.comparator import (ComparisonResult,
                                           QueryResultComparator)


def run_query(query, tables, pd_tables, comparator=None,
              device=None) -> ComparisonResult:
    """Run ``query`` over ``tables`` ({name: [files]}) and compare it with
    its oracle over ``pd_tables`` ({name: pandas DataFrame}). A crash is
    a FAIL with the error recorded."""
    comparator = comparator or QueryResultComparator()
    t0 = time.perf_counter()
    try:
        with Session(device=device) as session:
            got = query.run(session, tables)
    except Exception:
        return ComparisonResult(query.name, False, 0,
                                error=traceback.format_exc(limit=8))
    elapsed = time.perf_counter() - t0
    res = comparator.compare(query.name, got, query.expected(pd_tables))
    res.elapsed_s = round(elapsed, 3)
    return res
