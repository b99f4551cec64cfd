"""Spark-compatible xxhash64 and murmur3_x86_32 on primitive columns.

The port of ``auron_tpu.ops.hashing``'s primitive arms, bit-identical
to it (and so to Spark's XxHash64 and Murmur3_x86_32): every value
contributes the hash of its little-endian bytes, multi-column hashes
chain the running hash through the seed, and NULL leaves the running
hash unchanged. murmur3 with seed 42 places rows in a hash shuffle.

PyTorch has no unsigned 64-bit shifts or adds, so xxhash64 runs in
int64: ``+`` and ``*`` wrap mod 2^64 exactly as uint64 does, the primes
are written as their signed equivalents, and a logical right shift is
the arithmetic shift masked down to its low ``64 - r`` bits. murmur3's
uint32 words live in int64 lanes as values in [0, 2^32): a product
wraps mod 2^64, whose low 32 bits are the uint32 product, and every
step masks with ``& 0xFFFFFFFF``.
"""

from __future__ import annotations

import torch

from auron_tpu_torch.columnar.batch import PrimitiveColumn


def _s64(u: int) -> int:
    """The int64 with the same 64 bits as the unsigned ``u``."""
    return u - (1 << 64) if u >= 1 << 63 else u


_P1 = _s64(0x9E3779B185EBCA87)
_P2 = _s64(0xC2B2AE3D27D4EB4F)
_P3 = _s64(0x165667B19E3779F9)
_P4 = _s64(0x85EBCA77C2B2AE63)
_P5 = _s64(0x27D4EB2F165667C5)


def _shr(x: torch.Tensor, r: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> r) & ((1 << (64 - r)) - 1)


def _rotl64(x: torch.Tensor, r: int) -> torch.Tensor:
    return (x << r) | _shr(x, 64 - r)


def _xx_avalanche(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _P2
    h = h ^ _shr(h, 29)
    h = h * _P3
    return h ^ _shr(h, 32)


def _xx_round(acc, inp: torch.Tensor) -> torch.Tensor:
    acc = acc + inp * _P2
    acc = _rotl64(acc, 31)
    return acc * _P1


def _seed(seed, values: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(seed, dtype=torch.int64, device=values.device)


def xxhash64_int64(values: torch.Tensor, seed) -> torch.Tensor:
    """xxhash64 of one 8-byte LE value per row; ``seed`` is an int or an
    int64 tensor of running hashes."""
    h = _seed(seed, values) + _P5 + 8
    h = h ^ _xx_round(0, values.to(torch.int64))
    h = _rotl64(h, 27) * _P1 + _P4
    return _xx_avalanche(h)


def xxhash64_int32(values: torch.Tensor, seed) -> torch.Tensor:
    """xxhash64 of one 4-byte LE value per row."""
    v = values.to(torch.int32).to(torch.int64) & 0xFFFFFFFF
    h = _seed(seed, values) + _P5 + 4
    h = h ^ (v * _P1)
    h = _rotl64(h, 23) * _P2 + _P3
    return _xx_avalanche(h)


def canonicalize_float(d: torch.Tensor) -> torch.Tensor:
    """Spark NormalizeNaNAndZero: -0.0 → 0.0 and every NaN payload → the
    canonical quiet NaN, so keys equal under Spark hash alike.

    Subnormals become 0.0 too: the reference compares ``d == 0.0`` on
    XLA backends that flush subnormals to zero, so they hash as zero
    there, and the port keeps its hashes bit-identical."""
    v = torch.where(d.abs() < torch.finfo(d.dtype).tiny, 0.0, d)
    return torch.where(d != d, torch.nan, v)


def nan_aware_eq(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise key equality with Spark semantics: NaN == NaN (floats
    only); -0.0 == 0.0 already holds under IEEE ==."""
    same = a == b
    if a.dtype.is_floating_point:
        same = same | ((a != a) & (b != b))
    return same


def pairwise_eq(pc: PrimitiveColumn, probe_idx: torch.Tensor,
                bc: PrimitiveColumn, build_idx: torch.Tensor) -> torch.Tensor:
    """Value equality of ``pc[probe_idx]`` and ``bc[build_idx]`` under
    Spark key semantics (NaN == NaN, -0.0 == 0.0). Validity is not
    included: equi-join null keys never match, and the caller applies
    that rule."""
    for c in (pc, bc):
        if not isinstance(c, PrimitiveColumn):
            raise NotImplementedError(
                f"join keys of {type(c).__name__}: the port compares "
                "primitive columns only; string keys come with ROADMAP "
                "item 16c, decimal128 with 16d, struct with 16f")
    return nan_aware_eq(pc.data[probe_idx], bc.data[build_idx])


def adjacent_eq(col: PrimitiveColumn) -> torch.Tensor:
    """bool[cap-1]: row i equals row i-1 under Spark key semantics —
    null == null, NaN == NaN."""
    if not isinstance(col, PrimitiveColumn):
        raise NotImplementedError(
            f"grouping on {type(col).__name__} keys: the port groups "
            "primitive columns only")
    both_valid = col.validity[1:] & col.validity[:-1]
    both_null = ~col.validity[1:] & ~col.validity[:-1]
    same = nan_aware_eq(col.data[1:], col.data[:-1])
    return (both_valid & same) | both_null


# ---------------------------------------------------------------------------
# murmur3_x86_32
# ---------------------------------------------------------------------------

SPARK_SHUFFLE_SEED = 42

_M32 = 0xFFFFFFFF
_M3_C1 = 0xCC9E2D51
_M3_C2 = 0x1B873593
_M3_MIX = 0xE6546B64


def _u32(x) -> torch.Tensor:
    """The uint32 bits of an int tensor (or int) as int64 in [0, 2^32)."""
    if not isinstance(x, torch.Tensor):
        return x & _M32
    return x.to(torch.int64) & _M32


def _s32(h: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 → the int32 with the same bits."""
    return torch.where(h >= 1 << 31, h - (1 << 32), h).to(torch.int32)


def _rotl32(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def _mix_k1(k1):
    k1 = (k1 * _M3_C1) & _M32
    k1 = _rotl32(k1, 15)
    return (k1 * _M3_C2) & _M32


def _mix_h1(h1, k1):
    h1 = h1 ^ k1
    h1 = _rotl32(h1, 13)
    return (h1 * 5 + _M3_MIX) & _M32


def _fmix(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = (h1 * 0x85EBCA6B) & _M32
    h1 = h1 ^ (h1 >> 13)
    h1 = (h1 * 0xC2B2AE35) & _M32
    return h1 ^ (h1 >> 16)


def murmur3_int32(values: torch.Tensor, seed) -> torch.Tensor:
    """murmur3 of a 4-byte LE value (int8/16 widen to int32 first, as in
    Spark). values: int32[n]; seed: int32[n] or an int → int32[n]."""
    h1 = _mix_h1(_u32(seed), _mix_k1(_u32(values.to(torch.int32))))
    return _s32(_fmix(h1, 4))


def murmur3_u32_pair(low: torch.Tensor, high: torch.Tensor,
                     seed) -> torch.Tensor:
    """murmur3 of an 8-byte LE value given as (low, high) 32-bit words
    (uint32 values in int64 lanes)."""
    h1 = _mix_h1(_u32(seed), _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _s32(_fmix(h1, 8))


def murmur3_int64(values: torch.Tensor, seed) -> torch.Tensor:
    """murmur3 of an 8-byte LE value: low word then high word."""
    v = values.to(torch.int64)
    return murmur3_u32_pair(v & _M32, (v >> 32) & _M32, seed)


def _f64_bits(d: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Canonicalized bits of f64 as (low, high) 32-bit words."""
    v = canonicalize_float(d).view(torch.int64)
    return v & _M32, (v >> 32) & _M32


def _hash_column_murmur(col: PrimitiveColumn,
                        hashes: torch.Tensor) -> torch.Tensor:
    """One column's contribution to the running murmur3 hash (int32[n])."""
    if not isinstance(col, PrimitiveColumn):
        raise NotImplementedError(
            f"murmur3 of {type(col).__name__}: the port hashes primitive "
            "columns only")
    d = col.data
    if d.dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        new = murmur3_int32(d.to(torch.int32), hashes)
    elif d.dtype == torch.int64:
        new = murmur3_int64(d, hashes)
    elif d.dtype == torch.float32:
        # Java floatToIntBits: -0.0 -> 0.0, NaN payloads canonicalized
        new = murmur3_int32(canonicalize_float(d).view(torch.int32), hashes)
    elif d.dtype == torch.float64:
        lo, hi = _f64_bits(d)
        new = murmur3_u32_pair(lo, hi, hashes)
    else:
        raise NotImplementedError(f"murmur3 for {d.dtype}")
    return torch.where(col.validity, new, hashes)


def _hash_device(cols, device) -> torch.device:
    """Where the hashes live: ``device`` when given, else the first
    column's. Without columns every row hashes to the seed, and only the
    caller knows the device."""
    if device is not None:
        return torch.device(device)
    if not cols:
        raise ValueError("hashing no columns needs its device")
    return cols[0].data.device


def murmur3_columns(cols: list[PrimitiveColumn], capacity: int,
                    seed: int = SPARK_SHUFFLE_SEED,
                    device=None) -> torch.Tensor:
    """Spark create_hashes: running int32 hash chained across columns;
    the seed in every row when there are none."""
    hashes = torch.full((capacity,), seed, dtype=torch.int32,
                        device=_hash_device(cols, device))
    for col in cols:
        hashes = _hash_column_murmur(col, hashes)
    return hashes


def murmur3_batch(batch, key_indices: list[int],
                  seed: int = SPARK_SHUFFLE_SEED) -> torch.Tensor:
    return murmur3_columns([batch.columns[i] for i in key_indices],
                           batch.capacity, seed, device=batch.device)


# ---------------------------------------------------------------------------
# xxhash64
# ---------------------------------------------------------------------------

def _hash_column_xxhash(col: PrimitiveColumn,
                        hashes: torch.Tensor) -> torch.Tensor:
    d = col.data
    if d.dtype in (torch.bool, torch.int8, torch.int16, torch.int32):
        new = xxhash64_int32(d.to(torch.int32), hashes)
    elif d.dtype == torch.int64:
        new = xxhash64_int64(d, hashes)
    elif d.dtype == torch.float32:
        new = xxhash64_int32(canonicalize_float(d).view(torch.int32), hashes)
    elif d.dtype == torch.float64:
        new = xxhash64_int64(canonicalize_float(d).view(torch.int64), hashes)
    else:
        raise NotImplementedError(f"xxhash64 for {d.dtype}")
    return torch.where(col.validity, new, hashes)


def xxhash64_columns(cols: list[PrimitiveColumn], capacity: int,
                     seed: int = 42, device=None) -> torch.Tensor:
    """Running int64 xxhash64 chained across ``cols`` (Spark's
    create_xxhash64_hashes); the seed in every row when there are
    none."""
    hashes = torch.full((capacity,), seed, dtype=torch.int64,
                        device=_hash_device(cols, device))
    for col in cols:
        hashes = _hash_column_xxhash(col, hashes)
    return hashes
