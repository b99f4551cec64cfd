"""The port's xxhash64 and murmur3 against the JAX package's:
bit-identical.

Edge values of every primitive type the port hashes (0, ±1, the int32
and int64 extremes, signed zeros, NaN, infinities, subnormals), with
nulls, one column at a time and chained across columns; the word hashes
with a tensor of running hashes as the seed; and the hash shuffle's
partition ids (murmur3 seed 42, pmod) on the same values. Decimals:
a wide column hashes its low then its high limb (the reference's limb
pair, not Spark's bytes), a narrow one its int64, chained with other
columns, and the partition ids over both equal the reference's; key
equality (``adjacent_eq``, ``pairwise_eq``) compares both limbs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from auron_tpu.columnar.batch import DeviceBatch as JBatch
from auron_tpu.columnar.batch import PrimitiveColumn as JCol
from auron_tpu.columnar.schema import DataType as JType
from auron_tpu.columnar.schema import Field as JField
from auron_tpu.columnar.schema import Schema as JSchema
from auron_tpu.exprs import ir as jir
from auron_tpu.ops import hashing as jh
from auron_tpu.parallel.partitioning import HashPartitioning as JHash
from auron_tpu_torch.columnar.batch import PrimitiveColumn as TCol
from auron_tpu_torch.columnar.batch import batch_from_numpy
from auron_tpu_torch.columnar.schema import DataType as TType
from auron_tpu_torch.columnar.schema import Field as TField
from auron_tpu_torch.columnar.schema import Schema as TSchema
from auron_tpu_torch.exprs import ir as tir
from auron_tpu_torch.ops import hashing as th
from auron_tpu_torch.parallel.partitioning import HashPartitioning as THash

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


def _murmur_both(arrays, seed=th.SPARK_SHUFFLE_SEED):
    n = arrays[0].size
    valids = [_valid(n, i + 10) for i in range(len(arrays))]
    want = jh.murmur3_columns(
        [JCol(jnp.asarray(a), jnp.asarray(v)) for a, v in zip(arrays, valids)],
        n, seed)
    got = th.murmur3_columns(
        [TCol(torch.from_numpy(a.copy()), torch.from_numpy(v))
         for a, v in zip(arrays, valids)], n, seed)
    return np.asarray(want), got.numpy()


@pytest.mark.parametrize("dtype", sorted(EDGE))
def test_murmur3_column_matches_reference(dtype):
    want, got = _murmur_both([EDGE[dtype]])
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)


def test_murmur3_chains_across_columns_and_keeps_seed_on_null():
    want, got = _murmur_both([EDGE["int64"], EDGE["float64"],
                              EDGE["int32"], EDGE["bool"],
                              EDGE["float32"], EDGE["int8"]])
    np.testing.assert_array_equal(got, want)
    a = EDGE["int64"]
    none = th.murmur3_columns(
        [TCol(torch.from_numpy(a), torch.zeros(a.size, dtype=torch.bool))],
        a.size)
    assert (none == th.SPARK_SHUFFLE_SEED).all()


@pytest.mark.parametrize("width", ["int64", "int32"])
def test_murmur3_words_with_running_seed(width):
    """murmur3_int64 / murmur3_int32 seeded by a column of running
    int32 hashes, negative ones included."""
    seeds = np.asarray(jh.murmur3_int64(jnp.asarray(EDGE["int64"]),
                                        jnp.uint32(42)))
    assert (seeds < 0).any()
    vals = EDGE[width]
    jfn = jh.murmur3_int64 if width == "int64" else jh.murmur3_int32
    tfn = th.murmur3_int64 if width == "int64" else th.murmur3_int32
    want = jfn(jnp.asarray(vals), jnp.asarray(seeds).view(jnp.uint32))
    got = tfn(torch.from_numpy(vals), torch.from_numpy(seeds.copy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_partitions", [1, 4, 7, 200])
def test_hash_partition_ids_match_reference(num_partitions):
    """HashPartitioning.partition_ids on int64 (negative keys and the
    extremes), float64 (±0.0, NaN, subnormals), int32 and float32 keys
    with nulls, chained: pmod keeps every id in [0, n)."""
    rng = np.random.default_rng(num_partitions)
    n = 4096
    cols = {
        "k": np.concatenate([EDGE["int64"], rng.integers(
            I64.min, I64.max, n - 12, dtype=np.int64)]),
        "f": np.concatenate([EDGE["float64"], rng.normal(size=n - 12)]),
        "i": np.concatenate([EDGE["int32"], rng.integers(
            I32.min, I32.max, n - 12).astype(np.int32)]),
        "g": np.concatenate([EDGE["float32"], rng.normal(
            size=n - 12).astype(np.float32)]),
    }
    valid = {c: _valid(n, j) for j, c in enumerate(cols)}
    types = {"k": "INT64", "f": "FLOAT64", "i": "INT32", "g": "FLOAT32"}
    jschema = JSchema(tuple(JField(c, JType[types[c]]) for c in cols))
    tschema = TSchema(tuple(TField(c, TType[types[c]]) for c in cols))
    jbatch = JBatch(tuple(JCol(jnp.asarray(cols[c]), jnp.asarray(valid[c]))
                          for c in cols), jnp.asarray(n, jnp.int32))
    tbatch = batch_from_numpy([(cols[c], valid[c]) for c in cols], n, "cpu")
    for keys in ([0], [1], [2, 3], [0, 1, 2, 3]):
        want = np.asarray(JHash(tuple(jir.ColumnRef(i) for i in keys),
                                num_partitions).partition_ids(jbatch,
                                                              jschema))
        got = THash(tuple(tir.ColumnRef(i) for i in keys),
                    num_partitions).partition_ids(tbatch, tschema).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.min() >= 0 and got.max() < num_partitions


# ---------------------------------------------------------------------------
# decimals
# ---------------------------------------------------------------------------

from auron_tpu.columnar.decimal128 import Decimal128Column as JDec
from auron_tpu_torch.columnar import decimal128 as D

_DEC_INTS = [0, 1, -1, 2 ** 63, -(2 ** 63), 2 ** 64 - 1, 2 ** 64,
             10 ** 38 - 1, -(10 ** 38 - 1), 10 ** 18, -(10 ** 18), 12345]


def _dec_limbs(n: int, seed: int):
    rng = np.random.default_rng(seed)
    vals = _DEC_INTS + [int(rng.integers(-10 ** 18, 10 ** 18))
                        * int(rng.integers(1, 10 ** 18))
                        for _ in range(n - len(_DEC_INTS))]
    hi, lo, _v = D.limbs_from_ints(vals, n)
    return hi, lo


def _dec_cols(n, seed):
    hi, lo = _dec_limbs(n, seed)
    v = _valid(n, seed)
    return (JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v)),
            D.Decimal128Column(torch.from_numpy(hi), torch.from_numpy(lo),
                               torch.from_numpy(v)))


@pytest.mark.parametrize("hash_name", ["xxhash64", "murmur3"])
def test_decimal_hashes_match_reference(hash_name):
    """A wide column alone and chained with an int64 (a narrow decimal's
    payload) and a float column."""
    n = 64
    jd, td = _dec_cols(n, 5)
    k, f = EDGE["int64"], EDGE["float64"]
    extra = [(np.resize(k, n), _valid(n, 6)), (np.resize(f, n), _valid(n, 7))]
    jextra = [JCol(jnp.asarray(a), jnp.asarray(v)) for a, v in extra]
    textra = [TCol(torch.from_numpy(a.copy()), torch.from_numpy(v))
              for a, v in extra]
    jfn = getattr(jh, f"{hash_name}_columns")
    tfn = getattr(th, f"{hash_name}_columns")
    for jcols, tcols in (([jd], [td]), ([jextra[0], jd, jextra[1]],
                                        [textra[0], td, textra[1]])):
        want = np.asarray(jfn(jcols, n))
        np.testing.assert_array_equal(tfn(tcols, n).numpy(), want)


def test_decimal_key_equality_matches_reference():
    n = 32
    hi, lo = _dec_limbs(n, 8)
    hi[1::2], lo[1::2] = hi[::2], lo[::2]        # equal neighbours
    lo[3] ^= 1                                   # differ in lo only
    hi[5] += 1                                   # differ in hi only
    v = _valid(n, 9)
    v[6:8] = False                               # null == null
    jd = JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(v))
    td = D.Decimal128Column(torch.from_numpy(hi), torch.from_numpy(lo),
                            torch.from_numpy(v))
    np.testing.assert_array_equal(th.adjacent_eq(td).numpy(),
                                  np.asarray(jh.adjacent_eq(jd)))
    pi = np.random.default_rng(1).integers(0, n, 64)
    bi = np.random.default_rng(2).integers(0, n, 64)
    want = jh.pairwise_eq(jd, jnp.asarray(pi), jd, jnp.asarray(bi))
    got = th.pairwise_eq(td, torch.from_numpy(pi), td, torch.from_numpy(bi))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("num_partitions", [1, 4, 200])
def test_decimal_hash_partition_ids_match_reference(num_partitions):
    """A decimal(30,2) key (limbs) and a decimal(12,2) key (int64),
    alone and together."""
    n = 512
    hi, lo = _dec_limbs(n, num_partitions)
    small = np.random.default_rng(3).integers(-10 ** 12, 10 ** 12, n)
    vw, vn = _valid(n, 11), _valid(n, 12)
    jschema = JSchema((JField("w", JType.DECIMAL, True, 30, 2),
                       JField("n", JType.DECIMAL, True, 12, 2)))
    tschema = TSchema((TField("w", TType.DECIMAL, True, 30, 2),
                       TField("n", TType.DECIMAL, True, 12, 2)))
    jbatch = JBatch((JDec(jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vw)),
                     JCol(jnp.asarray(small), jnp.asarray(vn))),
                    jnp.asarray(n, jnp.int32))
    tbatch = batch_from_numpy([(hi, lo, vw), (small, vn)], n, "cpu")
    for keys in ([0], [1], [0, 1]):
        want = np.asarray(JHash(tuple(jir.ColumnRef(i) for i in keys),
                                num_partitions).partition_ids(jbatch,
                                                              jschema))
        got = THash(tuple(tir.ColumnRef(i) for i in keys),
                    num_partitions).partition_ids(tbatch, tschema).numpy()
        np.testing.assert_array_equal(got, want)
