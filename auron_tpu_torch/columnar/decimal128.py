"""128-bit decimal columns as two 64-bit limbs: precision 19..38.

The port of ``auron_tpu.columnar.decimal128``. A decimal(p > 18) column
is a pair of int64 tensors: ``hi`` (the signed high limb) and ``lo``
(the bit pattern of the unsigned low limb). Every operation is
branch-free, elementwise limb arithmetic on the tensors' device:

  - add/sub: unsigned-compare carry propagation;
  - mul: a 32-bit half-limb schoolbook multiply keeping the low 128 bits;
  - scale by 10^k: a constant multiply, or a chunked long division in
    base 2^32 with divisor chunks <= 10^9, so partial remainders fit
    int63;
  - compare: signed hi, then unsigned lo.

Values are two's-complement 128-bit integers. Precision 38 bounds
|value| < 10^38 < 2^127, so no operation here overflows the
representation itself; overflow past the DECLARED precision is detected
against 10^p bounds and nulled (Spark's non-ANSI semantics).

**No uint64.** Most torch ops do not take ``torch.uint64``, so unsigned
values stay int64 bit patterns, as in the reference: an unsigned compare
flips the sign bit of both sides, and a logical ``>> 32`` masks the
arithmetic shift with ``0xFFFFFFFF``. int64 ``*``, ``+`` and ``<<`` wrap
in two's complement on the CPU and on CUDA, which the 32 x 32 partial
products rely on.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

#: 1 << 63 as an int64 bit pattern
_SIGN = -0x8000000000000000
_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
MAX_PRECISION = 38


@dataclass(frozen=True)
class Decimal128Column:
    """Two-limb decimal column: value = hi * 2^64 + u64(lo)."""

    hi: torch.Tensor        # int64[capacity], signed high limb
    lo: torch.Tensor        # int64[capacity], bits of the unsigned low limb
    validity: torch.Tensor  # bool[capacity]

    @property
    def capacity(self) -> int:
        return self.hi.shape[0]

    def with_validity(self, validity: torch.Tensor) -> "Decimal128Column":
        return Decimal128Column(self.hi, self.lo, validity)


# ---------------------------------------------------------------------------
# unsigned-64 helpers on int64 bit patterns
# ---------------------------------------------------------------------------

def _ult(a, b):
    """Unsigned a < b over int64 bit patterns (flip the sign bit)."""
    return (a ^ _SIGN) < (b ^ _SIGN)


def _lsr32(x):
    """Logical right shift by 32 of an int64 bit pattern: 32 x 32 partial
    products pass 2^63, and an arithmetic shift would sign-extend garbage
    into the carries."""
    return (x >> 32) & _M32


def _mul_u64(a, b):
    """Full 64 x 64 → 128 unsigned multiply of int64 bit patterns;
    returns the (hi64, lo64) bit patterns."""
    ah, al = _lsr32(a), a & _M32
    bh, bl = _lsr32(b), b & _M32
    ll = al * bl          # may pass 2^63: a u64 bit pattern
    lh = al * bh
    hl = ah * bl
    hh = ah * bh
    mid = _lsr32(ll) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | (mid << 32)
    hi = hh + _lsr32(lh) + _lsr32(hl) + _lsr32(mid)
    return hi, lo


# ---------------------------------------------------------------------------
# core 128-bit ops (elementwise over (hi, lo) pairs)
# ---------------------------------------------------------------------------

def add128(ah, al, bh, bl):
    lo = al + bl
    return ah + bh + _ult(lo, al).to(torch.int64), lo


def neg128(h, l):
    nl = (~l) + 1
    return (~h) + (nl == 0).to(torch.int64), nl


def sub128(ah, al, bh, bl):
    nh, nl = neg128(bh, bl)
    return add128(ah, al, nh, nl)


def mul128(ah, al, bh, bl):
    """Low 128 bits of a*b (two's complement: the low bits are
    sign-correct)."""
    hi, lo = _mul_u64(al, bl)
    return hi + al * bh + ah * bl, lo


def cmp128(ah, al, bh, bl):
    """(lt, eq) for the signed 128-bit comparison."""
    eq = (ah == bh) & (al == bl)
    lt = (ah < bh) | ((ah == bh) & _ult(al, bl))
    return lt, eq


def abs128(h, l):
    neg = h < 0
    nh, nl = neg128(h, l)
    return torch.where(neg, nh, h), torch.where(neg, nl, l)


def from_int64(x):
    """Sign-extend an int64 (a scaled decimal(<= 18)) into limbs."""
    return torch.where(x < 0, -1, 0), x


def to_int64(h, l):
    """(value as int64, fits flag): exact when the 128-bit value lies in
    the int64 range (hi is the pure sign extension of lo)."""
    return l, h == torch.where(l < 0, -1, 0)


# ---------------------------------------------------------------------------
# powers of ten
# ---------------------------------------------------------------------------

def _signed64(u: int) -> int:
    return u - (1 << 64) if u >= 1 << 63 else u


def int_limbs(v: int) -> tuple[int, int]:
    """(hi, lo) int64 bit patterns of a python int, two's complement mod
    2^128."""
    u = v & ((1 << 128) - 1)
    return _signed64(u >> 64), _signed64(u & _M64)


def _pow10_limbs(k: int) -> tuple[int, int]:
    return int_limbs(10 ** k)


def mul_pow10(h, l, k: int):
    """value * 10^k (k in [0, 38])."""
    if k == 0:
        return h, l
    ph, pl = _pow10_limbs(k)
    return mul128(h, l, ph, pl)


def _divmod_u32_limbs(h, l, d):
    """Unsigned (h, l) // d and the remainder, by base-2^32 long
    division; ``d`` (a python int or a tensor) must keep every partial
    value r * 2^32 + limb below 2^63, i.e. d < 2^31."""
    q = []
    r = torch.zeros_like(h)
    for limb in (_lsr32(h), h & _M32, _lsr32(l), l & _M32):
        cur = (r << 32) | limb
        q.append(cur // d)
        r = cur % d
    return (q[0] << 32) | q[1], (q[2] << 32) | q[3], r


def _divmod_small(h, l, d: int):
    """Unsigned (h, l) // d and the remainder for 1 <= d <= 10^9."""
    assert 1 <= d <= 10 ** 9
    return _divmod_u32_limbs(h, l, d)


def avg_pow10_div_half_up(h, l, count, k: int):
    """(value * 10^k) / count with HALF_UP, for the avg finalizers: the
    sum accumulates unshifted, and the result-scale shift composes with
    the division as q * 10^k + round(r * 10^k / count), which never
    widens past the result. Returns (hi, lo, fits); fits is False when
    |q| >= 10^(38 - k) (the scaled average cannot fit decimal(38), and
    Spark nulls it) or when count >= 2^31 (the long division's bound:
    a group of more than 2.1e9 rows nulls rather than mis-divides)."""
    assert 0 <= k <= 9   # frac term: 2 * r * 10^k < 2^32 * 10^9 < 2^63
    neg = h < 0
    ah, al = abs128(h, l)
    qh, ql, r = _divmod_u32_limbs(ah, al, count)
    fits = fits_precision(qh, ql, 38 - k) & (count < (1 << 31))
    qh, ql = mul_pow10(qh, ql, k)
    frac = (2 * r * (10 ** k) + count) // (2 * count)
    qh, ql = add128(qh, ql, torch.zeros_like(h), frac)
    nh, nl = neg128(qh, ql)
    return torch.where(neg, nh, qh), torch.where(neg, nl, ql), fits


def div_pow10_half_up(h, l, k: int):
    """value / 10^k with HALF_UP rounding (Spark's rescale down)."""
    if k == 0:
        return h, l
    if k >= 39:
        # |value| < 10^38 < 0.5 * 10^k: always rounds to zero
        return torch.zeros_like(h), torch.zeros_like(l)
    neg = h < 0
    ah, al = abs128(h, l)
    # q, r = divmod(value, 10^k) in <= 9-digit chunks: dividing by d1
    # then d2, value = q2*d1*d2 + r2*d1 + r1, so the remainder rebuilds
    # as r1 + r2*d1 + r3*d1*d2 + ...
    rem_h = torch.zeros_like(h)
    rem_l = torch.zeros_like(l)
    rem_exp = 0
    kk = k
    while kk > 0:
        step = min(kk, 9)
        ah, al, r = _divmod_small(ah, al, 10 ** step)
        sh, sl = _pow10_limbs(rem_exp)
        rh_, rl_ = mul128(torch.zeros_like(r), r, sh, sl)
        rem_h, rem_l = add128(rem_h, rem_l, rh_, rl_)
        rem_exp += step
        kk -= step
    # HALF_UP: away from zero when the remainder >= 5 * 10^(k-1)
    # (comparing 2 * remainder with 10^k would wrap for k = 38)
    th, tl = int_limbs(5 * 10 ** (k - 1))
    lt, _eq = cmp128(rem_h, rem_l, th, tl)
    ah, al = add128(ah, al, torch.zeros_like(h), (~lt).to(torch.int64))
    nh, nl = neg128(ah, al)
    return torch.where(neg, nh, ah), torch.where(neg, nl, al)


def div_pow10_trunc(h, l, k: int):
    """value / 10^k truncated toward zero (decimal → integer casts)."""
    if k == 0:
        return h, l
    neg = h < 0
    ah, al = abs128(h, l)
    kk = k
    while kk > 0:
        step = min(kk, 9)
        ah, al, _r = _divmod_small(ah, al, 10 ** step)
        kk -= step
    nh, nl = neg128(ah, al)
    return torch.where(neg, nh, ah), torch.where(neg, nl, al)


def fits_precision(h, l, precision: int):
    """|value| < 10^precision: the declared-precision overflow check."""
    ah, al = abs128(h, l)
    bh, bl = _pow10_limbs(min(precision, MAX_PRECISION))
    lt, _ = cmp128(ah, al, bh, bl)
    return lt


# ---------------------------------------------------------------------------
# host conversion
# ---------------------------------------------------------------------------

def limbs_from_ints(values: list, cap: int) -> tuple[np.ndarray, np.ndarray,
                                                     np.ndarray]:
    """Python ints (unscaled values; None is null) → numpy limb arrays of
    ``cap`` rows."""
    hi = np.zeros(cap, np.int64)
    lo = np.zeros(cap, np.int64)
    valid = np.zeros(cap, bool)
    for i, v in enumerate(values):
        if v is not None:
            hi[i], lo[i] = int_limbs(v)
            valid[i] = True
    return hi, lo, valid


def ints_from_limbs(hi: np.ndarray, lo: np.ndarray,
                    valid: np.ndarray) -> list:
    """Limb arrays → python ints (None for nulls)."""
    out = []
    for h, l, ok in zip(hi.tolist(), lo.tolist(), valid.tolist()):
        if not ok:
            out.append(None)
            continue
        u = ((h & _M64) << 64) | (l & _M64)
        out.append(u - (1 << 128) if u >= 1 << 127 else u)
    return out


def to_float64(h, l):
    """The approximate float64 value of the 128-bit integer, as the
    reference computes it: |hi| * 2^64 + u64(|lo|) in float64, then the
    sign (for float-context arithmetic and casts)."""
    neg = h < 0
    ah, al = abs128(h, l)
    lo_f = al.to(torch.float64)
    lo_u = torch.where(al < 0, lo_f + 2.0 ** 64, lo_f)
    mag = ah.to(torch.float64) * (2.0 ** 64) + lo_u
    return torch.where(neg, -mag, mag)
