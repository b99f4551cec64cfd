"""Spark-compatible xxhash64 on primitive columns.

The port of the xxhash64 half of ``auron_tpu.ops.hashing``, bit-identical
to it (and so to Spark's XxHash64): every value contributes the hash of
its little-endian bytes, multi-column hashes chain the running hash
through the seed, and NULL leaves the running hash unchanged.

PyTorch has no unsigned 64-bit shifts or adds, so the arithmetic runs in
int64: ``+`` and ``*`` wrap mod 2^64 exactly as uint64 does, the primes
are written as their signed equivalents, and a logical right shift is
the arithmetic shift masked down to its low ``64 - r`` bits.
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
                     seed: int = 42) -> torch.Tensor:
    """Running int64 xxhash64 chained across ``cols`` (Spark's
    create_xxhash64_hashes)."""
    hashes = torch.full((capacity,), seed, dtype=torch.int64,
                        device=cols[0].data.device)
    for col in cols:
        hashes = _hash_column_xxhash(col, hashes)
    return hashes
