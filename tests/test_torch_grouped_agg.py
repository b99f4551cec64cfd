"""The port's dense grouped-agg kernels against the JAX package's.

Every input is made with numpy from a seed and handed to both. The JAX
side runs its Pallas kernel through the interpreter, as
tests/test_kernels.py does; the port's ``cuda_sum_count`` is given CPU
tensors, so it runs its plain version (``sum_count_reference``), which is
what the CUDA kernel is held to on the card by chip_smoke.py.

Tolerances: counts are identical, and so are sums of integer-valued
inputs (every partial sum is exact in f32 below 2^24). Sums of other
float inputs are added in another order (the reference splits each value
into three bf16 terms for its matrix unit), so they agree per key within
1e-5 of the key's sum of |v|.
"""

import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.kernels import grouped_agg as jga
from auron_tpu_torch.kernels import grouped_agg as tga

F32_SUM_TOL = 1e-5


def _case(name):
    """(k int32, v f32 with nulls zeroed, c f32 0/1, key_domain, exact)."""
    rng = np.random.default_rng(11)
    if name == "float_values":
        n, dom = 8192, 1 << 12
        k = rng.integers(0, dom, n)
        c = rng.random(n) > 0.05
        v = rng.normal(size=n)
        exact = False
    elif name == "integer_values":
        n, dom = 4096, 1 << 16
        k = rng.integers(0, 3000, n)
        c = rng.random(n) > 0.15
        v = rng.integers(-100, 100, n)
        exact = True
    elif name == "out_of_range_keys":
        # keys outside [0, key_domain) contribute nothing, in both
        n, dom = 2048, 1000
        k = rng.integers(0, dom, n)
        k[:5] = [-1, 1000, 1500, 3000, 70000]
        k[5:50] = rng.choice([-1, 1000, 1500, 3000, 70000], 45)
        c = rng.random(n) > 0.1
        v = rng.integers(-100, 100, n)
        exact = True
    else:
        raise ValueError(name)
    v = np.where(c, v, 0).astype(np.float32)
    return k.astype(np.int32), v, c.astype(np.float32), dom, exact


def _assert_sum_count(got, want, k, v, dom, exact):
    gs, gc = (np.asarray(x, np.float64) for x in got)
    ws, wc = (np.asarray(x, np.float64) for x in want)
    np.testing.assert_array_equal(gc, wc)
    if exact:
        np.testing.assert_array_equal(gs, ws)
    else:
        ok = (k >= 0) & (k < dom)
        scale = np.bincount(k[ok], weights=np.abs(v[ok]).astype(np.float64),
                            minlength=dom)
        assert np.all(np.abs(gs - ws) <= F32_SUM_TOL * scale)


def _torch(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


CASES = ["float_values", "integer_values", "out_of_range_keys"]


@pytest.mark.parametrize("name", CASES)
def test_cuda_sum_count_matches_pallas(name):
    k, v, c, dom, exact = _case(name)
    want = jga.pallas_sum_count(jnp.asarray(k), jnp.asarray(v),
                                jnp.asarray(c), dom, interpret=True)
    before = tga.cuda_sum_count.launches
    got = tga.cuda_sum_count(*_torch(k, v, c), dom)
    # CPU tensors run the plain version and launch nothing
    assert tga.cuda_sum_count.launches == before
    assert got[0].dtype == got[1].dtype == torch.float32
    assert got[0].shape == got[1].shape == (dom,)
    _assert_sum_count(got, want, k, v, dom, exact)


@pytest.mark.parametrize("name", ["float_values", "out_of_range_keys"])
def test_dense_matmul_matches_reference(name):
    k, v, c, dom, exact = _case(name)
    want = jga.dense_matmul_sum_count(jnp.asarray(k), jnp.asarray(v),
                                      jnp.asarray(c), dom)
    got = tga.dense_matmul_sum_count(*_torch(k, v, c), dom, block=1024)
    _assert_sum_count(got, want, k, v, dom, exact)


@pytest.mark.parametrize("backend", ["cuda_dense", "dense_matmul"])
def test_sum_count_backends_agree(backend):
    k, v, c, dom, _ = _case("integer_values")
    want = tga.sum_count_reference(*_torch(k, v, c), dom)
    got = tga.sum_count(*_torch(k, v, c), dom, backend=backend,
                        interpret=True)
    _assert_sum_count(got, want, k, v, dom, True)


def test_sum_count_unknown_backend():
    k, v, c, dom, _ = _case("integer_values")
    with pytest.raises(ValueError, match="unknown dense grouped-agg"):
        tga.sum_count(*_torch(k, v, c), dom, backend="pallas_vmem")


def test_empty_input():
    e = np.zeros(0, np.int32), np.zeros(0, np.float32), \
        np.zeros(0, np.float32)
    sums, counts = tga.cuda_sum_count(*_torch(*e), 300)
    assert sums.shape == counts.shape == (300,)
    assert not sums.any() and not counts.any()


@pytest.mark.parametrize("key_domain", [1 << 16, 1000, 1, 256, 257,
                                        0, -5, (1 << 16) + 1])
def test_grid_dims_matches_reference(key_domain):
    try:
        want = jga.grid_dims(key_domain)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tga.grid_dims(key_domain)
        return
    assert tga.grid_dims(key_domain) == want


@pytest.mark.parametrize("n,blk", [(3000, 2048), (6144, 4096),
                                   (4096, 2048), (1000, 2048)])
def test_block_contract_matches_reference(n, blk):
    rng = np.random.default_rng(n)
    k = rng.integers(0, 500, n).astype(np.int32)
    v = np.ones(n, np.float32)
    try:
        jga.pallas_sum_count(jnp.asarray(k), jnp.asarray(v), jnp.asarray(v),
                             500, blk=blk, interpret=True)
    except ValueError as e:
        with pytest.raises(ValueError, match=re.escape(str(e))):
            tga.cuda_sum_count(*_torch(k, v, v), 500, blk=blk)
        return
    _, counts = tga.cuda_sum_count(*_torch(k, v, v), 500, blk=blk)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(k, minlength=500))


@pytest.mark.parametrize("bad", ["k_int64", "v_float64", "two_d",
                                 "strided", "short_c"])
def test_wrapper_rejects_malformed_operands(bad):
    n = 64
    k = torch.zeros(n, dtype=torch.int32)
    v = torch.zeros(n, dtype=torch.float32)
    c = torch.zeros(n, dtype=torch.float32)
    if bad == "k_int64":
        k, err = k.long(), TypeError
    elif bad == "v_float64":
        v, err = v.double(), TypeError
    elif bad == "two_d":
        k, err = k.reshape(8, 8), ValueError
    elif bad == "strided":
        v, err = torch.zeros(2 * n)[::2], ValueError
    else:
        c, err = c[:32], ValueError
    with pytest.raises(err):
        tga.cuda_sum_count(k, v, c, 100)


_DTYPES = [(jnp.int32, torch.int32), (jnp.int64, torch.int64),
           (jnp.float32, torch.float32), (jnp.float64, torch.float64)]


@pytest.mark.parametrize("kind", ["sum", "count", "min", "max"])
@pytest.mark.parametrize("dtypes", _DTYPES, ids=lambda d: d[1].__repr__())
def test_scatter_reduce_matches_reference(kind, dtypes):
    """Identical, integer-valued: including the reference's index rule
    (keys in [-dom, 0) count from the end, others outside are dropped)."""
    jdt, tdt = dtypes
    rng = np.random.default_rng(5)
    n, dom = 300, 40
    k = rng.integers(-50, 60, n).astype(np.int32)
    v = rng.integers(-1000, 1000, n).astype(np.int64)
    valid = rng.random(n) > 0.2
    want = jga.scatter_reduce(kind, jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(valid), dom, jdt)
    got = tga.scatter_reduce(kind, torch.from_numpy(k), torch.from_numpy(v),
                             torch.from_numpy(valid), dom, tdt)
    want = np.asarray(want)
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)


def test_scatter_reduce_unknown_kind():
    with pytest.raises(ValueError, match="unknown scatter reduction"):
        tga.scatter_reduce("median", torch.zeros(3, dtype=torch.int32),
                           torch.zeros(3), torch.ones(3, dtype=torch.bool),
                           4, torch.float32)


# ---------------------------------------------------------------------------
# the CUDA kernel's launch plan and its NaN behaviour, checked on the CPU
# ---------------------------------------------------------------------------

def _h100(key_domain: int) -> "tga.DeviceProps":
    """An H100 SXM's launch inputs for one domain, as the kernel's props
    call reported them on the card: 132 SMs, 227 KB of opt-in shared
    memory per block, 6 resident 256-thread blocks per SM on the global
    path (40 registers a thread); on the shared path 1024-thread blocks,
    at most 2 per SM by their launch bounds and as many as 228 KB of
    shared memory per SM holds with 1 KB reserved per block (0 where the
    domain does not fit a block)."""
    smem = 8 * key_domain
    occupancy = min(2, 233472 // (smem + 1024)) if smem <= 232448 else 0
    return tga.DeviceProps(sms=132, smem_optin=232448, global_occupancy=6,
                           shared_occupancy=occupancy, threads=256,
                           shared_threads=1024)


_G, _S = tga.PATH_GLOBAL, tga.PATH_SHARED
#: a small made-up card, to show that blocks follow the props given
_SMALL = tga.DeviceProps(4, 232448, 3, 1, 256, 1024)


@pytest.mark.parametrize("n,key_domain,props,want", [
    # the shared path where every block sees a row per key or more
    (1 << 20, 1000, None, (_S, 256, 8000)),
    (1 << 20, 4096, None, (_S, 256, 32768)),
    (1 << 20, 8192, None, (_G, 792, 0)),
    (1 << 22, 8192, None, (_S, 264, 65536)),
    # 128 KB leaves room for one block per SM, so 132 blocks
    (1 << 20, 16384, None, (_G, 792, 0)),
    (1 << 22, 16384, None, (_S, 132, 131072)),
    # 2^16 float2 (512 KB) never fits a block's shared memory
    (1 << 22, 1 << 16, None, (_G, 792, 0)),
    # a domain the props say does not fit (occupancy 0)
    (1 << 22, 1000, _h100(1000)._replace(shared_occupancy=0),
     (_G, 792, 0)),
    # blocks follow the given SM count, occupancy and block size
    (1 << 22, 1 << 16, _SMALL, (_G, 12, 0)),
    (1 << 22, 1000, _SMALL, (_S, 4, 8000)),
    (4096, 1 << 16, _SMALL._replace(threads=128), (_G, 8, 0)),
    (4096, 1, _SMALL._replace(shared_threads=256), (_S, 4, 8)),
    # tiny inputs: one block, never 0
    (6, 1000, None, (_G, 1, 0)),
    (1, 1, None, (_S, 1, 8)),
    (2048, 1000, None, (_S, 1, 8000)),
    (2048, 4096, None, (_G, 2, 0)),
], ids=lambda x: str(x) if not isinstance(x, tuple) else None)
def test_plan_chooses_path_and_blocks(n, key_domain, props, want):
    assert tga._plan(n, key_domain, props or _h100(key_domain)) == want


@pytest.mark.parametrize("path,key_domain,want", [
    (_G, 1000, (_G, 792, 0)),
    (_S, 16384, (_S, 132, 131072)),
    (_S, 1 << 16, ValueError),
    (7, 1000, ValueError),
])
def test_plan_forced_path(path, key_domain, want):
    if want is ValueError:
        with pytest.raises(ValueError):
            tga._plan(1 << 20, key_domain, _h100(key_domain), path)
    else:
        assert tga._plan(1 << 20, key_domain, _h100(key_domain),
                         path) == want


def test_launch_rejects_unknown_variant():
    k, v, c = _torch(np.zeros(4, np.int32), np.ones(4, np.float32),
                     np.ones(4, np.float32))
    with pytest.raises(ValueError, match="unknown variant"):
        tga._launch(k, v, c, 4, "match_always")


def test_nan_value_stays_on_its_key():
    """One NaN in v, on key 3 of key_domain=1000 (no row holds keys 0-2).

    The port's ``cuda_sum_count`` (its plain version, on CPU tensors) and
    ``sum_count_reference`` put NaN on key 3 alone, as a float64 oracle,
    Spark and the reference's sort twin do. The reference's Pallas
    kernel does not: it returns NaN on all 256 keys of key 3's hi row
    (keys 0-255), because ``masked(v)`` carries the NaN into the hi
    one-hot row and the dot with the lo one-hots multiplies it by 0 in
    every lane (ROADMAP Queue 3). Every key outside that row, and every
    count, equals the Pallas kernel's."""
    rng = np.random.default_rng(7)
    n, dom = 2048, 1000
    k = rng.integers(4, dom, n).astype(np.int32)
    v = rng.integers(-100, 100, n).astype(np.float32)
    c = np.ones(n, np.float32)
    k[7], v[7] = 3, np.nan
    o_sum = np.bincount(k, weights=v.astype(np.float64), minlength=dom)
    o_cnt = np.bincount(k, minlength=dom)
    ps, pc = (np.asarray(x) for x in jga.pallas_sum_count(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(c), dom,
        interpret=True))
    assert np.flatnonzero(np.isnan(ps)).tolist() == list(range(256))
    for fn in (tga.cuda_sum_count, tga.sum_count_reference):
        gs, gc = (x.numpy() for x in fn(*_torch(k, v, c), dom))
        assert np.flatnonzero(np.isnan(gs)).tolist() == [3]
        rest = np.arange(dom) != 3
        np.testing.assert_array_equal(gs[rest], o_sum[rest])
        np.testing.assert_array_equal(gs[256:], ps[256:])
        np.testing.assert_array_equal(gc, o_cnt)
        np.testing.assert_array_equal(gc, pc)
