"""Integration-harness runner of the port (the port of
``auron_tpu.it.runner``): queries through a fresh ``Session`` each,
diffed against their oracles. The sessions run on ``cuda`` unless
``device`` names another.

    python -m auron_tpu_torch.it.runner --suite tpcds --scale 2.88
    python -m auron_tpu_torch.it.runner --suite tpch --scale 100
    python -m auron_tpu_torch.it.runner --suite synth --queries q01,q05

``--suite tpcds`` runs the 99 TPC-DS queries of ``it/tpcds_queries.py``
(scale 2.88 gives SF1's fact row counts), ``--suite tpch`` the 6 TPC-H
queries of ``it/tpch_queries.py`` (scale 100 is SF1) and ``--suite
synth`` the queries of ``it/queries.py`` over ``it/tpcds_data.py``'s
synthetic store_sales. The suites' oracles run first, in one process
per host core but one. The exit code is 0 iff every query matched.
"""

from __future__ import annotations

import sys
import tempfile
import time
import traceback

from auron_tpu_torch.frontend.session import Session
from auron_tpu_torch.it.comparator import (ComparisonResult,
                                           QueryResultComparator)
from auron_tpu_torch.ops.base import host_readback
from auron_tpu_torch.ops.subquery import ScalarSubqueryBinderOp


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


def run_all(data_dir=None, scale: float = 1.0, names=None, device=None,
            verbose: bool = True) -> list[ComparisonResult]:
    """The synthetic-star queries of ``it/queries.py``."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    from auron_tpu_torch.it.queries import QUERIES
    from auron_tpu_torch.it.tpcds_data import generate
    tables = generate(data_dir or tempfile.mkdtemp(prefix="auron_it_"),
                      scale=scale)
    pd_tables = {n: pa.concat_tables([pq.read_table(f) for f in files])
                 .to_pandas() for n, files in tables.items()}
    results = []
    for q in QUERIES:
        if names and q.name not in names \
                and q.name.split("_")[0] not in names:
            continue
        results.append(run_query(q, tables, pd_tables, device=device))
        if verbose:
            print(results[-1].report() + f" ({results[-1].elapsed_s}s)",
                  flush=True)
    return results


def _defloat_decimals(tbl):
    """Cast decimal columns to float64 so engine decimals (exact,
    Spark-typed) and the Acero oracle's mixed decimal/float outputs
    compare under the double tolerance. Money sums at TPC-DS scale stay
    within float64's 2^53 exact-integer range."""
    import pyarrow as pa
    cols = []
    for i, f in enumerate(tbl.schema):
        c = tbl.column(i)
        if pa.types.is_decimal(f.type):
            c = c.cast(pa.float64())
        cols.append(c)
    return pa.table({f.name: c for f, c in zip(tbl.schema, cols)})


#: suite → (its generator module, its queries' module)
SUITES = {"tpcds": ("auron_tpu_torch.it.tpcds",
                    "auron_tpu_torch.it.tpcds_queries"),
          "tpch": ("auron_tpu_torch.it.tpch",
                   "auron_tpu_torch.it.tpch_queries")}

#: a worker process's Arrow tables, by suite and files
_LOADED: dict = {}


def _oracle_job(suite: str, tables: dict, name: str):
    """One query's oracle in a worker process: (name, table, seconds).
    The worker loads the suite's tables once."""
    import importlib
    gen_mod, queries_mod = SUITES[suite]
    key = (suite, repr(sorted(tables.items())))
    if key not in _LOADED:
        _LOADED.clear()
        _LOADED[key] = importlib.import_module(gen_mod).load_arrow(tables)
    (q,) = [q for q in importlib.import_module(queries_mod).QUERIES
            if q.name == name]
    t0 = time.perf_counter()
    table = q.oracle(_LOADED[key])
    return name, table, time.perf_counter() - t0


def suite_oracles(jobs) -> dict:
    """The oracles of ``jobs`` ([(suite, tables, query name)]) in one
    process per host core but one: {(suite, name): (table, seconds)}.
    The oracles are pyarrow and pandas on one core each; at TPC-DS SF1
    they take longer than the queries on the card."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor
    out = {}
    workers = max(1, (os.cpu_count() or 2) - 1)
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn")) as pool:
        futures = {pool.submit(_oracle_job, *job): job[0] for job in jobs}
        for f, suite in futures.items():
            name, table, seconds = f.result()
            out[(suite, name)] = (table, seconds)
    return out


def _run_suite(queries, tables, expected, comparator, device=None,
               verbose: bool = True) -> list[ComparisonResult]:
    """The per-query loop: a fresh session, the diff against
    ``expected`` ({name: (oracle table, oracle seconds)}), the report.
    Each result also carries what the query cost: ``elapsed_s`` (its
    run), ``oracle_s``, ``syncs`` (its ``host_readback`` round trips)
    and ``subqueries`` / ``subquery_ms`` (the scalar subqueries it
    resolved and their wall time)."""
    results = []
    for q in queries:
        syncs0 = host_readback.syncs
        subs0 = (ScalarSubqueryBinderOp.resolved,
                 ScalarSubqueryBinderOp.resolve_ns)
        t0 = time.perf_counter()
        try:
            with Session(device=device) as session:
                got = q.run(session, tables)
        except Exception:
            results.append(ComparisonResult(
                q.name, False, 0, error=traceback.format_exc(limit=8)))
            if verbose:
                print(results[-1].report(), flush=True)
            continue
        elapsed = time.perf_counter() - t0
        syncs = host_readback.syncs - syncs0
        want, oracle_s = expected[q.name]
        res = comparator.compare(q.name, _defloat_decimals(got),
                                 _defloat_decimals(want))
        res.elapsed_s, res.oracle_s, res.syncs = elapsed, oracle_s, syncs
        res.subqueries = ScalarSubqueryBinderOp.resolved - subs0[0]
        res.subquery_ms = (ScalarSubqueryBinderOp.resolve_ns
                           - subs0[1]) / 1e6
        results.append(res)
        if verbose:
            print(res.report() + f" ({elapsed:.3f}s, oracle "
                  f"{oracle_s:.3f}s, {syncs} syncs)", flush=True)
    return results


#: the reference's comparator settings for each suite
TPCDS_TOLERANCE = dict(double_rel_tol=1e-7, double_abs_tol=1e-6)
TPCH_TOLERANCE = dict(double_rel_tol=1e-7, double_abs_tol=1e-5)


def _run_named_suite(suite: str, tolerance: dict, data_dir, scale: float,
                     names, device, verbose: bool):
    """Generate ``suite``'s tables, run the oracles of its queries (those
    in ``names`` if given) in worker processes, then the queries."""
    import importlib
    gen_mod, queries_mod = SUITES[suite]
    queries = [q for q in importlib.import_module(queries_mod).QUERIES
               if not names or q.name in names]
    tables = importlib.import_module(gen_mod).generate(
        data_dir or tempfile.mkdtemp(prefix=f"auron_{suite}_"), scale=scale)
    expected = {n: v for (_s, n), v in suite_oracles(
        [(suite, tables, q.name) for q in queries]).items()}
    return _run_suite(queries, tables, expected,
                      QueryResultComparator(**tolerance), device=device,
                      verbose=verbose)


def run_tpcds(data_dir=None, scale: float = 1.0, names=None, device=None,
              verbose: bool = True) -> list[ComparisonResult]:
    """The real-schema TPC-DS gate: the 99 TPC-DS query shapes over
    ``it/tpcds.py``'s dataset (scale 1.0 = 1M store_sales rows), diffed
    against the pyarrow/Acero oracle (reference gate:
    .github/workflows/tpcds-reusable.yml:70-83)."""
    return _run_named_suite("tpcds", TPCDS_TOLERANCE, data_dir, scale,
                            names, device, verbose)


def run_tpch(data_dir=None, scale: float = 1.0, names=None, device=None,
             verbose: bool = True) -> list[ComparisonResult]:
    """TPC-H q1/q3/q5/q6/q9/q18 over ``it/tpch.py``'s dataset (scale 1.0
    = 60,000 lineitems), diffed against pandas oracles."""
    return _run_named_suite("tpch", TPCH_TOLERANCE, data_dir, scale,
                            names, device, verbose)


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--scale", type=float, default=1.0)
    ap.add_argument("--suite", default="synth",
                    choices=["synth", "tpcds", "tpch"])
    ap.add_argument("--queries", default="",
                    help="comma-separated names (q01 or full name)")
    ap.add_argument("--data", default=None,
                    help="reuse/create dataset in this directory")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    names = [n.strip() for n in args.queries.split(",") if n.strip()] or None
    run = {"tpcds": run_tpcds, "tpch": run_tpch, "synth": run_all}
    results = run[args.suite](data_dir=args.data, scale=args.scale,
                              names=names, device=args.device)
    if not results:
        print(f"no queries matched --queries {args.queries!r} in suite "
              f"{args.suite!r} — nothing ran", file=sys.stderr)
        return 2
    failed = [r for r in results if not r.ok]
    print(f"{len(results) - len(failed)}/{len(results)} queries passed")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
