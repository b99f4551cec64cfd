"""Spark-compatible xxhash64 and murmur3_x86_32 on primitive, string and
decimal columns.

The port of ``auron_tpu.ops.hashing``'s primitive, string and decimal
arms,
bit-identical to it (and so to Spark's XxHash64 and Murmur3_x86_32):
every value contributes the hash of its little-endian bytes, multi-column
hashes chain the running hash through the seed, and NULL leaves the
running hash unchanged. murmur3 with seed 42 places rows in a hash
shuffle. A string hashes its first ``lens`` bytes of a zero-padded
``[n, width]`` matrix: the phases of the byte-stream algorithms (murmur3's
4-byte blocks then sign-extended tail bytes; xxhash64's 32-byte stripes,
8-byte blocks, one 4-byte block and tail bytes) run for every row in
lock-step, each step applied where the row's length reaches it. No byte
at or past a row's length is read, so the hash does not depend on the
width. A decimal of precision <= 18 hashes its unscaled int64; a wider
one its low limb, then its high limb, as two int64 words (the
reference's departure from Spark, which hashes the minimal big-endian
bytes).

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

from auron_tpu_torch.columnar.batch import (Decimal128Column,
                                            PrimitiveColumn, StringColumn,
                                            unify_column_widths)
from auron_tpu_torch.ops.strings import le_words


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


def _require_key(c) -> None:
    if not isinstance(c, (PrimitiveColumn, StringColumn, Decimal128Column)):
        raise NotImplementedError(
            f"keys of {type(c).__name__}: the port compares and hashes "
            "primitive, string and decimal columns only; struct, list and "
            "map keys come with ROADMAP item 16f")


def pairwise_eq(pc, probe_idx: torch.Tensor, bc,
                build_idx: torch.Tensor) -> torch.Tensor:
    """Value equality of ``pc[probe_idx]`` and ``bc[build_idx]`` under
    Spark key semantics (NaN == NaN, -0.0 == 0.0; strings byte for byte
    and by length, at either side's width). Validity is not included:
    equi-join null keys never match, and the caller applies that rule."""
    for c in (pc, bc):
        _require_key(c)
    if isinstance(pc, StringColumn):
        pc, bc = unify_column_widths([pc, bc])
        return (pc.chars[probe_idx] == bc.chars[build_idx]).all(dim=1) \
            & (pc.lens[probe_idx] == bc.lens[build_idx])
    if isinstance(pc, Decimal128Column):
        return (pc.hi[probe_idx] == bc.hi[build_idx]) \
            & (pc.lo[probe_idx] == bc.lo[build_idx])
    return nan_aware_eq(pc.data[probe_idx], bc.data[build_idx])


def adjacent_eq(col) -> torch.Tensor:
    """bool[cap-1]: row i equals row i-1 under Spark key semantics —
    null == null, NaN == NaN, strings byte for byte and by length."""
    _require_key(col)
    both_valid = col.validity[1:] & col.validity[:-1]
    both_null = ~col.validity[1:] & ~col.validity[:-1]
    if isinstance(col, StringColumn):
        same = (col.chars[1:] == col.chars[:-1]).all(dim=1) \
            & (col.lens[1:] == col.lens[:-1])
    elif isinstance(col, Decimal128Column):
        same = (col.hi[1:] == col.hi[:-1]) & (col.lo[1:] == col.lo[:-1])
    else:
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


def _byte_at(chars: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """chars[i, pos[i]] (pos clipped into the row) as int64."""
    idx = pos.clamp(0, chars.shape[1] - 1).to(torch.int64)[:, None]
    return torch.gather(chars, 1, idx)[:, 0].to(torch.int64)


def murmur3_string(chars: torch.Tensor, lens: torch.Tensor,
                   seed) -> torch.Tensor:
    """murmur3 over variable-length bytes held in a fixed-width matrix:
    full 4-byte LE blocks mix in order, then each trailing byte mixes
    alone, sign-extended, as Spark's ``hashUnsafeBytes`` does. ``seed``
    is an int or the int32 running hashes → int32[n]."""
    n = chars.shape[0]
    words = le_words(chars, 4)
    nfull = lens.to(torch.int64) // 4
    h1 = _u32(seed if isinstance(seed, torch.Tensor)
              else torch.full((n,), seed, dtype=torch.int64,
                              device=chars.device))
    for i in range(words.shape[1]):
        mixed = _mix_h1(h1, _mix_k1(words[:, i]))
        h1 = torch.where(i < nfull, mixed, h1)
    ln = lens.to(torch.int64)
    for j in range(3):
        pos = nfull * 4 + j
        byte = _byte_at(chars, pos)
        # the byte as a Java byte (sign-extended), then its uint32 bits
        half = ((byte ^ 0x80) - 0x80) & _M32
        mixed = _mix_h1(h1, _mix_k1(half))
        h1 = torch.where(pos < ln, mixed, h1)
    return _s32(_fmix(h1, ln & _M32))


def _hash_column_murmur(col, hashes: torch.Tensor) -> torch.Tensor:
    """One column's contribution to the running murmur3 hash (int32[n])."""
    _require_key(col)
    if isinstance(col, Decimal128Column):
        # the limb pair, low then high, as two int64 words: the
        # reference's departure from Spark, which hashes a wide decimal's
        # minimal big-endian bytes; partition ids stay the reference's
        new = murmur3_int64(col.hi, murmur3_int64(col.lo, hashes))
        return torch.where(col.validity, new, hashes)
    if isinstance(col, StringColumn):
        new = murmur3_string(col.chars, col.lens, hashes)
        return torch.where(col.validity, new, hashes)
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
    return cols[0].validity.device


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

def xxhash64_string(chars: torch.Tensor, lens: torch.Tensor,
                    seed) -> torch.Tensor:
    """xxhash64 over variable-length bytes held in a fixed-width matrix:
    32-byte stripes into four accumulators (when the row has one), the
    length, then 8-byte blocks, one 4-byte block and the tail bytes,
    each step applied where the row's length reaches it. ``seed`` is an
    int or the int64 running hashes → int64[n]."""
    n, width = chars.shape
    dev = chars.device
    words64 = le_words(chars, 8)
    words32 = le_words(chars, 4)
    n64 = words64.shape[1]
    ln = lens.to(torch.int64)
    seed_arr = seed.to(torch.int64) if isinstance(seed, torch.Tensor) \
        else torch.full((n,), seed, dtype=torch.int64, device=dev)

    nstripes = ln // 32
    acc1 = seed_arr + _P1 + _P2
    acc2 = seed_arr + _P2
    acc3 = seed_arr
    acc4 = seed_arr - _P1
    for s in range(width // 32 + (1 if width % 32 else 0)):
        active = s < nstripes
        base = s * 4
        accs = []
        for k, acc in enumerate((acc1, acc2, acc3, acc4)):
            w = words64[:, min(base + k, n64 - 1)]
            accs.append(torch.where(active, _xx_round(acc, w), acc))
        acc1, acc2, acc3, acc4 = accs
    merged = (_rotl64(acc1, 1) + _rotl64(acc2, 7) + _rotl64(acc3, 12)
              + _rotl64(acc4, 18))
    for acc in (acc1, acc2, acc3, acc4):
        merged = (merged ^ _xx_round(0, acc)) * _P1 + _P4
    h = torch.where(ln >= 32, merged, seed_arr + _P5) + ln

    consumed8 = nstripes * 4        # in 8-byte words
    n8 = (ln % 32) // 8
    for j in range(4):
        idx = (consumed8 + j).clamp(0, n64 - 1)[:, None]
        w = torch.gather(words64, 1, idx)[:, 0]
        nh = _rotl64(h ^ _xx_round(0, w), 27) * _P1 + _P4
        h = torch.where(j < n8, nh, h)

    idx4 = (ln // 8 * 2).clamp(0, words32.shape[1] - 1)[:, None]
    w4 = torch.gather(words32, 1, idx4)[:, 0]
    h4 = _rotl64(h ^ (w4 * _P1), 23) * _P2 + _P3
    h = torch.where((ln % 8) >= 4, h4, h)

    tail_start = ln // 4 * 4
    for j in range(3):
        pos = tail_start + j
        byte = _byte_at(chars, pos)
        nh = _rotl64(h ^ (byte * _P5), 11) * _P1
        h = torch.where(pos < ln, nh, h)
    return _xx_avalanche(h)


def _hash_column_xxhash(col, hashes: torch.Tensor) -> torch.Tensor:
    _require_key(col)
    if isinstance(col, Decimal128Column):
        # the limb pair, low then high (see _hash_column_murmur)
        new = xxhash64_int64(col.hi, xxhash64_int64(col.lo, hashes))
        return torch.where(col.validity, new, hashes)
    if isinstance(col, StringColumn):
        new = xxhash64_string(col.chars, col.lens, hashes)
        return torch.where(col.validity, new, hashes)
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
