"""The port's flagship q01 stage against the JAX package's, end to end.

The same numpy batches go to ``__graft_entry__`` and to
``auron_tpu_torch.entry``. The dense stage runs in the reference with its
Pallas kernel through the interpreter and with the one-hot matmul; in the
port with the CUDA kernel's plain version (CPU tensors) and with its
matmul. The sort twins are compared too.

Tolerances: group keys, key validity, counts, hashes and the sort twin's
group order are identical everywhere; sums and averages are identical in
the integer-valued shapes (exact f32 partial sums); in the float shape,
f32 sums agree per key within 1e-5 of the key's sum of |v| and the sort
twin's f64 sums within a relative 1e-12.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import __graft_entry__ as graft
from auron_tpu.columnar import batch as jbatch
from auron_tpu_torch import entry as tentry
from auron_tpu_torch.columnar import batch as tbatch
from auron_tpu_torch.kernels import registry

ROOT = Path(__file__).resolve().parent.parent
F32_SUM_TOL = 1e-5
F64_REL_TOL = 1e-12


def _shape(name):
    """(columns as (data, validity) numpy pairs, num_rows, exact)."""
    rng = np.random.default_rng(7)
    if name == "example_batch":
        b = tentry._example_batch(device="cpu")
        cols, n = tbatch.batch_to_numpy(b)
        return cols, n, False
    if name == "random_keys_with_nulls":
        cap = 4096
        keys = rng.integers(0, 3000, cap)
        values = rng.integers(-100, 100, cap).astype(np.float64)
        valid = rng.random(cap) > 0.15
        n = cap
    elif name == "empty_partition":
        cap = 2048
        keys, values = np.zeros(cap, np.int64), np.zeros(cap)
        valid, n = np.ones(cap, bool), 0
    elif name == "single_group":
        cap = 2048
        keys, values = np.full(cap, 37), np.arange(cap, dtype=np.float64)
        valid, n = np.ones(cap, bool), cap
    elif name == "full_domain":
        cap = 1 << 16
        keys = np.arange(cap)
        values = (keys % 97).astype(np.float64)
        valid, n = np.ones(cap, bool), cap
    elif name == "clipped_keys":
        # keys outside [0, 2^16) land in the boundary groups 0 and 65535
        cap = 2048
        keys = rng.integers(-5, 70000, cap)
        keys[:4] = [-1, -(1 << 40), 65536, 1 << 40]
        values = rng.integers(-100, 100, cap).astype(np.float64)
        valid, n = rng.random(cap) > 0.1, cap - 100
    else:
        raise ValueError(name)
    f = rng.integers(0, 40, cap).astype(np.int32)
    if name != "clipped_keys":
        f[:] = 20   # every live row passes the predicate
    ones = np.ones(cap, bool)
    return [(keys.astype(np.int64), ones), (values, valid), (f, ones)], n, \
        True


def _jax_batch(cols, n):
    return jbatch.DeviceBatch(
        tuple(jbatch.PrimitiveColumn(jnp.asarray(d), jnp.asarray(v))
              for d, v in cols), jnp.asarray(n, jnp.int32))


SHAPES = ["random_keys_with_nulls", "empty_partition", "single_group",
          "full_domain", "clipped_keys", "example_batch"]
BACKENDS = {"pallas": (("pallas_vmem", True), ("cuda_dense", True)),
            "dense": (("dense_matmul", False), ("dense_matmul", False))}


def _abs_scale(cols, n, domain):
    """Per-key sum of |v| over the rows the stage keeps, keys clipped."""
    (k, _), (v, vv), (f, _) = cols
    keep = (np.arange(k.size) < n) & vv & (f > 10)
    kc = np.clip(k, 0, domain - 1)
    return np.bincount(kc[keep], weights=np.abs(v[keep]), minlength=domain)


@pytest.mark.parametrize("backend", sorted(BACKENDS))
@pytest.mark.parametrize("shape", SHAPES)
def test_flagship_matches_reference(shape, backend):
    cols, n, exact = _shape(shape)
    (jb_name, j_interp), (tb_name, t_interp) = BACKENDS[backend]
    want = jax.device_get(jax.jit(graft._flagship_fn(jb_name, j_interp))(
        _jax_batch(cols, n)))
    got = tentry._flagship_fn(tb_name, t_interp)(
        tbatch.batch_from_numpy(cols, n, "cpu"))
    names = ("group_keys", "key_valid", "sums", "counts", "avg")
    got = {k: t.numpy() for k, t in zip(names, got)}
    want = {k: np.asarray(a) for k, a in zip(names, want)}
    for k in names:
        assert got[k].dtype == want[k].dtype, k
    for k in ("group_keys", "key_valid", "counts"):
        np.testing.assert_array_equal(got[k], want[k])
    if exact:
        np.testing.assert_array_equal(got["sums"], want["sums"])
        np.testing.assert_array_equal(got["avg"], want["avg"])
    else:
        scale = _abs_scale(cols, n, got["sums"].size)
        assert np.all(np.abs(got["sums"] - want["sums"])
                      <= F32_SUM_TOL * scale)
        cnt = np.maximum(got["counts"], 1)
        assert np.all(np.abs(got["avg"] - want["avg"])
                      <= F32_SUM_TOL * scale / cnt)


@pytest.mark.parametrize("shape", SHAPES)
def test_sort_twin_matches_reference(shape):
    cols, n, exact = _shape(shape)
    want = jax.device_get(jax.jit(graft._q01_kernel_sort)(
        _jax_batch(cols, n)))
    got = [t.numpy() for t in tentry._q01_kernel_sort(
        tbatch.batch_from_numpy(cols, n, "cpu"))]
    for g, w in zip(got, want):
        assert g.dtype == np.asarray(w).dtype
    # group order (by signed hash), keys, validity and counts: identical
    for i in (0, 1, 3):
        np.testing.assert_array_equal(got[i], want[i])
    for i in (2, 4):
        if exact:
            np.testing.assert_array_equal(got[i], want[i])
        else:
            np.testing.assert_allclose(got[i], want[i], rtol=F64_REL_TOL,
                                       atol=0)


@pytest.mark.parametrize("shape", [s for s in SHAPES if s != "full_domain"])
def test_hash_twin_matches_reference(shape):
    """Slot order, keys, validity and counts identical; f64 sums and
    averages within a relative 1e-12 of the key's sum of |v|."""
    cols, n, _exact = _shape(shape)
    want = [np.asarray(a) for a in jax.jit(graft._q01_kernel_hash)(
        _jax_batch(cols, n))]
    got = [t.numpy() for t in tentry._q01_kernel_hash(
        tbatch.batch_from_numpy(cols, n, "cpu"))]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
    for i in (0, 1, 3):       # keys, group_valid, counts
        np.testing.assert_array_equal(got[i], want[i])
    (k, _), (v, vv), (f, _) = cols
    keep = (np.arange(k.size) < n) & vv & (f > 10)
    abs_by_key = {}
    for key, a in zip(k[keep], np.abs(v[keep])):
        abs_by_key[key] = abs_by_key.get(key, 0.0) + a
    scale = np.array([abs_by_key.get(key, 0.0) if ok else 0.0
                      for key, ok in zip(got[0], got[1])])
    assert np.all(np.abs(got[2] - want[2]) <= F64_REL_TOL * scale)
    assert np.all(np.abs(got[4] - want[4])
                  <= F64_REL_TOL * scale / np.maximum(got[3], 1))
    assert got[1].sum() == len(abs_by_key)


def test_entry_on_cpu_matches_reference_example():
    fn, (batch,) = tentry.entry(device="cpu")
    assert fn is tentry._q01_kernel
    jfn, (jb,) = graft.entry()
    cols, n = tbatch.batch_to_numpy(batch)
    assert n == int(jb.num_rows)
    for (d, v), jc in zip(cols, jb.columns):
        np.testing.assert_array_equal(d, np.asarray(jc.data))
        np.testing.assert_array_equal(v, np.asarray(jc.validity))
    assert tbatch.batch_nbytes(batch) == jbatch.batch_nbytes(jb)
    before = registry.snapshot()["cuda_dense"]
    out = fn(batch)
    after = registry.snapshot()["cuda_dense"]
    assert after["selected"] == before["selected"] + 1
    assert after["interpret"] == before["interpret"] + 1
    ref = tentry._flagship_fn("cuda_dense", True)(batch)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)


def test_entry_without_device_raises_when_cuda_is_missing(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tentry.flagship_kernel()


@pytest.mark.parametrize("choice,ref_choice,expected", [
    ("sort", "sort", "_q01_kernel_dense_matmul"),
    ("dense", "dense", "_q01_kernel_dense_matmul"),
    ("cuda", "pallas", "_q01_kernel_cuda_dense_interpret"),
])
def test_flagship_backend_follows_config(choice, ref_choice, expected):
    # the flagship is dense by contract: a declined policy runs the matmul
    from auron_tpu import config as jcfg
    from auron_tpu_torch import config as tcfg
    tcfg.get_config().set(tcfg.KERNELS_BACKEND, choice)
    jcfg.get_config().set(jcfg.KERNELS_BACKEND, ref_choice)
    try:
        assert tentry.flagship_kernel("cpu").__name__ == expected
        assert graft.flagship_kernel().__name__.replace(
            "pallas_vmem", "cuda_dense") == expected
    finally:
        tcfg.get_config().unset(tcfg.KERNELS_BACKEND)
        jcfg.get_config().unset(jcfg.KERNELS_BACKEND)


def test_compact_and_gather_match_reference():
    rng = np.random.default_rng(9)
    cap = 64
    cols = [(rng.integers(-9, 9, cap), rng.random(cap) > 0.3),
            (rng.normal(size=cap), rng.random(cap) > 0.1)]
    keep = rng.random(cap) > 0.4
    jb, tb = _jax_batch(cols, 50), tbatch.batch_from_numpy(cols, 50, "cpu")
    want = jbatch.compact(jb, jnp.asarray(keep))
    got = tbatch.compact(tb, torch.from_numpy(keep))
    assert int(got.num_rows) == int(want.num_rows)
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
    idx = rng.integers(0, cap, 40).astype(np.int32)
    want = jbatch.gather_batch(jb, jnp.asarray(idx), jnp.asarray(30))
    got = tbatch.gather_batch(tb, torch.from_numpy(idx).long(),
                              torch.tensor(30))
    assert got.num_rows.dtype == torch.int32 and int(got.num_rows) == 30
    for g, w in zip(got.columns, want.columns):
        np.testing.assert_array_equal(g.data.numpy(), np.asarray(w.data))
        np.testing.assert_array_equal(g.validity.numpy(),
                                      np.asarray(w.validity))
    back, n = tbatch.batch_to_numpy(tb)
    assert n == 50
    for (d, v), (d0, v0) in zip(back, cols):
        np.testing.assert_array_equal(d, d0)
        np.testing.assert_array_equal(v, v0)


_FORBIDDEN = ("jax", "jaxlib", "auron_tpu", "__graft_entry__", "bench")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in _FORBIDDEN


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    code = ("import sys, auron_tpu_torch.entry, auron_tpu_torch.hashtable, "
            "auron_tpu_torch.kernels._build, auron_tpu_torch.ops.agg, "
            "auron_tpu_torch.parallel.exchange, auron_tpu_torch.io.parquet, "
            "auron_tpu_torch.runtime.executor, "
            "auron_tpu_torch.it.tpcds_data, auron_tpu_torch.ir.auron_pb2, "
            "auron_tpu_torch.ir.serde, auron_tpu_torch.ir.planner, "
            "auron_tpu_torch.frontend.session, "
            "auron_tpu_torch.frontend.dataframe, auron_tpu_torch.ops.limit, "
            "auron_tpu_torch.ops.fused, auron_tpu_torch.ops.joins, "
            "auron_tpu_torch.ops.sort, auron_tpu_torch.it.queries, "
            "auron_tpu_torch.it.comparator, auron_tpu_torch.it.runner, "
            "auron_tpu_torch.ops.strings, auron_tpu_torch.utils.shapes, "
            "auron_tpu_torch.ops.subquery, auron_tpu_torch.it.tpcds, "
            "auron_tpu_torch.it.tpcds_queries, auron_tpu_torch.it.tpch, "
            "auron_tpu_torch.it.tpch_queries"
            "\nbad = sorted(m for m in "
            "sys.modules if m.split('.')[0]"
            f" in {_FORBIDDEN!r})\nprint(bad)\nsys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr

    files = sorted((ROOT / "auron_tpu_torch").rglob("*.py")) + \
        [ROOT / "chip_smoke.py"]
    assert ROOT / "auron_tpu_torch" / "ir" / "auron_pb2.py" in files
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [m for m in names if _forbidden(m)]
            assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_pipeline_imports_and_runs_without_pyarrow_or_pandas():
    """The card may have neither pyarrow nor pandas: with both blocked,
    the entry and AggOp import, and q01 runs over device batches through
    collect_numpy."""
    code = (
        "import sys\n"
        "sys.modules['pyarrow'] = None\nsys.modules['pandas'] = None\n"
        "import auron_tpu_torch.entry as e, auron_tpu_torch.ops.agg\n"
        "from auron_tpu_torch.it.tpcds_data import store_sales_columns\n"
        "cols = store_sales_columns(0.05, 42)\n"
        "out = e.q01_pipeline(e.store_sales_batches(cols, 'cpu'), "
        "device='cpu')\n"
        "print(sorted(out['ss_store_sk'][0].tolist()), "
        "int(out['paid_cnt'][0].sum()))\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('pyarrow', 'pandas') and sys.modules[m] is not None)\n"
        "sys.exit(1 if bad else 0)")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split() == ["[0,", "1]", "4302"], proc.stdout
