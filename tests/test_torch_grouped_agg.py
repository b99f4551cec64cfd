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
