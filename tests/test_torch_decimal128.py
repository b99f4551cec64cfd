"""The port's two-limb decimal arithmetic against the JAX package's:
bit-identical limbs.

Every function of ``auron_tpu_torch.columnar.decimal128`` runs on the
same seeded int64 limbs as ``auron_tpu.columnar.decimal128`` (compiled
with ``jax.jit``, as the reference's operators run it): random 128-bit
values, values below 10^38 in magnitude, and the edge limbs where
two's-complement wrap and the carries across the limb line show
(``±2^63``, ``2^64 - 1``, ``±(10^38 - 1)``, ``-1``, ``0``). The host
conversions round-trip python ints, and ``to_float64`` matches bit for
bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from auron_tpu.columnar import decimal128 as R
from auron_tpu_torch.columnar import decimal128 as T

N = 256
KS = (1, 9, 10, 18, 19, 38)

_EDGE_INTS = [0, 1, -1, 2 ** 63, -(2 ** 63), 2 ** 63 - 1, 2 ** 64 - 1,
              2 ** 64, -(2 ** 64), 10 ** 38 - 1, -(10 ** 38 - 1),
              10 ** 18, -(10 ** 18), 2 ** 127 - 1, -(2 ** 127), 2 ** 32 - 1,
              5 * 10 ** 17, -5 * 10 ** 17, 10 ** 19 + 5, 123456789 * 10 ** 20]


def _limbs(seed: int, bound: int | None):
    """(hi, lo) int64 numpy arrays of N values: the edge values first,
    then random ones (below ``bound`` in magnitude when it is set)."""
    rng = np.random.default_rng(seed)
    vals = list(_EDGE_INTS)
    while len(vals) < N:
        if bound is None:
            v = int.from_bytes(rng.bytes(16), "little", signed=True)
        else:
            digits = int(rng.integers(1, len(str(bound))))
            v = int(rng.integers(0, 10 ** min(digits, 18))) \
                * 10 ** max(0, digits - 18) + int(rng.integers(0, 10 ** 6))
            v = min(v, bound - 1) * (1 if rng.random() < 0.5 else -1)
        vals.append(v)
    if bound is not None:
        vals = [v if abs(v) < bound else v % bound for v in vals]
    hi, lo, _ = T.limbs_from_ints(vals, N)
    return hi, lo


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        np.testing.assert_array_equal(g, np.asarray(w))
        assert g.dtype == np.asarray(w).dtype


@pytest.fixture(scope="module")
def operands():
    a = _limbs(1, None)
    b = _limbs(2, None)
    small = _limbs(3, 10 ** 38)
    small_b = _limbs(4, 10 ** 38)
    return a, b, small, small_b


@pytest.mark.parametrize("name", ["add128", "sub128", "mul128", "cmp128"])
def test_binary_ops_match_reference(name, operands):
    a, b, small, small_b = operands
    for (ah, al), (bh, bl) in ((a, b), (small, small_b), (a, small)):
        want = jax.jit(getattr(R, name))(*_j(ah, al, bh, bl))
        got = getattr(T, name)(*_t(ah, al, bh, bl))
        _same(got, want)


@pytest.mark.parametrize("name", ["neg128", "abs128", "to_int64",
                                  "to_float64"])
def test_unary_ops_match_reference(name, operands):
    for h, l in operands:
        want = jax.jit(getattr(R, name))(*_j(h, l))
        _same(getattr(T, name)(*_t(h, l)), want)


def test_from_int64_matches_reference(operands):
    for _h, l in operands:
        _same(T.from_int64(*_t(l)), jax.jit(R.from_int64)(*_j(l)))


@pytest.mark.parametrize("k", KS + (0, 39))
def test_scaling_matches_reference(k, operands):
    _a, _b, small, _sb = operands
    h, l = small
    for name in ("mul_pow10", "div_pow10_half_up", "div_pow10_trunc"):
        if name == "mul_pow10" and k > 38:
            continue
        fn = getattr(R, name)
        want = jax.jit(lambda x, y: fn(x, y, k))(*_j(h, l))
        _same(getattr(T, name)(*_t(h, l), k), want)


@pytest.mark.parametrize("p", (1, 9, 18, 19, 20, 30, 38))
def test_fits_precision_matches_reference(p, operands):
    for h, l in operands:
        want = jax.jit(lambda x, y: R.fits_precision(x, y, p))(*_j(h, l))
        _same(T.fits_precision(*_t(h, l), p), want)


@pytest.mark.parametrize("k", (0, 1, 4, 6, 9))
def test_avg_division_matches_reference(k, operands):
    _a, _b, small, _sb = operands
    h, l = small
    rng = np.random.default_rng(k)
    count = rng.integers(1, 1 << 20, N).astype(np.int64)
    count[:4] = [1, 2, (1 << 31) - 1, 1 << 31]   # the 2^31 bound
    want = jax.jit(lambda x, y, c: R.avg_pow10_div_half_up(x, y, c, k))(
        *_j(h, l, count))
    _same(T.avg_pow10_div_half_up(*_t(h, l, count), k), want)


def test_host_conversions_round_trip():
    vals = _EDGE_INTS + [None, 7, -7]
    hi, lo, valid = T.limbs_from_ints(vals, len(vals) + 2)
    rhi, rlo, rvalid = R.limbs_from_ints(vals, len(vals) + 2)
    _same((hi, lo, valid), (rhi, rlo, rvalid))
    back = T.ints_from_limbs(hi, lo, valid)
    wrapped = [None if v is None else
               ((v + 2 ** 127) % 2 ** 128) - 2 ** 127 for v in vals]
    assert back == wrapped + [None, None]
    assert back == R.ints_from_limbs(rhi, rlo, rvalid)


def test_int64_wraps_as_twos_complement():
    """The partial products rely on wrapping int64 ``*``, ``+`` and
    ``<<``: check the limb arithmetic's own primitives on this device."""
    x = torch.tensor([2 ** 62, -(2 ** 63), 2 ** 63 - 1, -1], dtype=torch.int64)
    assert (x * 4).tolist() == [0, 0, -4, -4]
    assert (x + x).tolist() == [-(2 ** 63), 0, -2, -2]
    assert (x << 1).tolist() == [-(2 ** 63), 0, -2, -2]
    assert ((x >> 32) & 0xFFFFFFFF).tolist() == [2 ** 30, 2 ** 31,
                                                 2 ** 31 - 1, 2 ** 32 - 1]
