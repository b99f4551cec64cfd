"""The port's ShuffleExchangeOp against the JAX package's, on the CPU.

The same seeded pyarrow batches, in three input partitions, go through
a MemoryScanOp and a 4-way exchange in each package; every output
partition must hold the same rows in the same order (identical values
and null masks). Hash partitioning keys on an int64 column with nulls
and negatives, on a float64 column with ±0.0 and NaN, and on an int32 +
float32 pair; round-robin and single partitioning too.
"""

import functools

import numpy as np
import pyarrow as pa
import pytest

from auron_tpu.columnar import arrow_bridge as rbridge
from auron_tpu.exprs import ir as rir
from auron_tpu.io.parquet import MemoryScanOp as RMem
from auron_tpu.ops.base import ExecContext as RCtx
from auron_tpu.parallel import partitioning as rpart
from auron_tpu.parallel.exchange import ShuffleExchangeOp as RShuffle
from auron_tpu_torch.columnar import arrow_bridge as tbridge
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.io.parquet import MemoryScanOp as TMem
from auron_tpu_torch.ops.base import ExecContext as TCtx
from auron_tpu_torch.parallel import partitioning as tpart
from auron_tpu_torch.parallel.exchange import ShuffleExchangeOp as TShuffle

N_OUT = 4


def _partitions(seed=4, rows=600, batch=128, maps=3):
    rng = np.random.default_rng(seed)
    k = rng.integers(-2**40, 2**40, rows)
    f = rng.normal(size=rows)
    f[::7] = 0.0
    f[1::7] = -0.0
    f[2::11] = np.nan
    i32 = rng.integers(-50, 50, rows).astype(np.int32)
    cols = {"k": pa.array(k, pa.int64(), mask=rng.random(rows) < 0.05),
            "f": pa.array(f, pa.float64(), mask=rng.random(rows) < 0.05),
            "i": pa.array(i32, pa.int32()),
            "g": pa.array(f.astype(np.float32), pa.float32())}
    tbl = pa.table(cols)
    rbs = [tbl.slice(s, batch).to_batches()[0]
           for s in range(0, rows, batch)]
    return [rbs[m::maps] for m in range(maps)]


@pytest.fixture(scope="module")
def parts():
    return _partitions()


def _run(parts, partitioning, ns):
    mem, shuffle, ctx, bridge = ns
    scan = mem(parts, bridge.schema_from_arrow(parts[0][0].schema),
               capacity=128)
    ex = shuffle(scan, partitioning, input_partitions=len(parts))
    out = []
    for p in range(N_OUT):
        c = ctx(partition_id=p, num_partitions=N_OUT)
        bs = [bridge.to_arrow(b, ex.schema()) for b in ex.execute(p, c)
              if int(b.num_rows)]
        out.append(pa.Table.from_batches(
            bs, schema=bridge.schema_to_arrow(ex.schema())))
    return out, ex


def _same(g: pa.Table, w: pa.Table) -> bool:
    """Identical schema, null masks and values, NaN equal to NaN and
    -0.0 told from 0.0."""
    if g.schema != w.schema or g.num_rows != w.num_rows:
        return False
    for a, b in zip(g.columns, w.columns):
        if not np.array_equal(a.is_null().to_numpy(), b.is_null().to_numpy()):
            return False
        x = a.fill_null(0).to_numpy()
        y = b.fill_null(0).to_numpy()
        if x.dtype.kind == "f":
            if not (np.array_equal(x, y, equal_nan=True)
                    and np.array_equal(np.signbit(x), np.signbit(y))):
                return False
        elif not np.array_equal(x, y):
            return False
    return True


REF = (RMem, RShuffle, RCtx, rbridge)
PORT = (functools.partial(TMem, device="cpu"), TShuffle, TCtx, tbridge)


def _hash(part, ir, cols):
    return part.HashPartitioning(tuple(ir.ColumnRef(c) for c in cols),
                                 N_OUT)


CASES = {
    "hash_int64": lambda part, ir: _hash(part, ir, [0]),
    "hash_float64": lambda part, ir: _hash(part, ir, [1]),
    "hash_int32_float32": lambda part, ir: _hash(part, ir, [2, 3]),
    "round_robin": lambda part, ir: part.RoundRobinPartitioning(N_OUT),
    "single": lambda part, ir: part.SinglePartitioning(N_OUT),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_exchange_rows_per_partition_match_reference(parts, case):
    want, _ = _run(parts, CASES[case](rpart, rir), REF)
    got, _ = _run(parts, CASES[case](tpart, tir), PORT)
    assert sum(t.num_rows for t in want) == 600
    for p, (g, w) in enumerate(zip(got, want)):
        assert g.num_rows == w.num_rows, p
        assert _same(g, w), p
    if case.startswith("hash"):
        assert sum(t.num_rows > 0 for t in got) > 1


def test_exchange_records_route_and_materializes_once(parts):
    """The host route is recorded in the reference's counter, and every
    output partition reads one buffer filled by one pass of the map
    side (one counts readback per input batch)."""
    from auron_tpu_torch.ops.base import host_readback
    scan = TMem(parts, tbridge.schema_from_arrow(parts[0][0].schema),
                capacity=128, device="cpu")
    ex = TShuffle(scan, tpart.HashPartitioning((tir.ColumnRef(0),), N_OUT),
                  input_partitions=len(parts))
    metrics = {}
    before = host_readback.syncs
    for p in range(N_OUT):
        c = TCtx(partition_id=p, num_partitions=N_OUT)
        c.metrics = metrics
        list(ex.execute(p, c))
    snap = metrics["shuffle_exchange"].snapshot()
    assert snap["exchange_route_device_buffer"] == 1
    n_batches = sum(len(p) for p in parts)
    assert host_readback.syncs - before == n_batches
    assert metrics["memory_scan"].snapshot()["output_batches"] == n_batches
