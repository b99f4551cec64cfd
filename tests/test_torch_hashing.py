"""The port's xxhash64 against the JAX package's: bit-identical.

Edge values of every primitive type the port hashes (0, ±1, the int32
and int64 extremes, signed zeros, NaN, infinities), with nulls, one
column at a time and chained across columns; plus the two word hashes
with a tensor of running hashes as the seed.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.ops import hashing as jh
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.ops import hashing as th

I32, I64 = np.iinfo(np.int32), np.iinfo(np.int64)

EDGE = {
    "int64": np.array([0, 1, -1, I32.min, I32.max, I64.min, I64.max,
                       I64.min + 1, 2**32, -2**32, 42, 123456789012345]),
    "int32": np.array([0, 1, -1, I32.min, I32.max, I32.min + 1, 65536,
                       -65536, 42, 7, -7, 1 << 30], np.int32),
    "int16": np.array([0, 1, -1, -32768, 32767, 255, -256, 42, 3, -3,
                       1000, -1000], np.int16),
    "int8": np.array([0, 1, -1, -128, 127, 64, -64, 42, 3, -3, 100, -100],
                     np.int8),
    "bool": np.array([True, False] * 6),
    "float32": np.array([0.0, -0.0, 1.0, -1.0, np.nan, np.inf, -np.inf,
                         3.4e38, -1.2e-38, 1e-45, 0.1, 42.0], np.float32),
    "float64": np.array([0.0, -0.0, 1.0, -1.0, np.nan, np.inf, -np.inf,
                         1.7e308, -2.2e-308, 5e-324, 0.1, 42.0]),
}


def _valid(n, seed):
    v = np.random.default_rng(seed).random(n) > 0.25
    v[0] = True
    return v


def _hash_both(arrays):
    n = arrays[0].size
    valids = [_valid(n, i) for i in range(len(arrays))]
    want = jh.xxhash64_columns(
        [JCol(jnp.asarray(a), jnp.asarray(v)) for a, v in zip(arrays, valids)],
        n)
    got = th.xxhash64_columns(
        [TCol(torch.from_numpy(a.copy()), torch.from_numpy(v))
         for a, v in zip(arrays, valids)], n)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dtype", sorted(EDGE))
def test_xxhash64_column_matches_reference(dtype):
    want, got = _hash_both([EDGE[dtype]])
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)


def test_xxhash64_all_null_keeps_seed():
    a = EDGE["int64"]
    want = jh.xxhash64_columns(
        [JCol(jnp.asarray(a), jnp.zeros(a.size, bool))], a.size, seed=7)
    got = th.xxhash64_columns(
        [TCol(torch.from_numpy(a), torch.zeros(a.size, dtype=torch.bool))],
        a.size, seed=7)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got == 7).all()


def test_xxhash64_chains_across_columns():
    want, got = _hash_both([EDGE["int64"], EDGE["float64"], EDGE["int32"],
                            EDGE["bool"], EDGE["float32"]])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("width", ["int64", "int32"])
def test_word_hashes_with_running_seed(width):
    seeds = np.asarray(jh.xxhash64_int64(jnp.asarray(EDGE["int64"]), 42))
    vals = EDGE[width]
    jfn = jh.xxhash64_int64 if width == "int64" else jh.xxhash64_int32
    tfn = th.xxhash64_int64 if width == "int64" else th.xxhash64_int32
    want = jfn(jnp.asarray(vals), jnp.asarray(seeds).view(jnp.uint64))
    got = tfn(torch.from_numpy(vals), torch.from_numpy(seeds.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
