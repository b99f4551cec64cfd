"""Device string kernels over fixed-width byte matrices.

The port of ``auron_tpu.ops.strings``: a literal's padded row, the
three-way compare, the two word packers every string path shares
(big-endian words in sort order for ``ops.sort`` and the compare;
little-endian words for the hashes and the hash table's key codec), the
predicates ``starts_with`` / ``ends_with`` / ``contains``, and
``substring``, ``concat``, ``upper``, ``lower`` and ``trim``. Every
kernel takes the padded layout of ``columnar.batch.StringColumn`` (chars
uint8 [n, w], lens int32 [n]). Zero padding makes plain byte-wise
comparison coincide with lexicographic order (0 sorts below every byte,
so a proper prefix sorts first), so a compare is a compare of integer
words.

Where the reference loops over every start position of a window
(``contains``) or scatters bytes with a ``max`` (``concat``), the port
compares all windows at once through ``Tensor.unfold`` and builds an
output by one gather per part over the output width, so a call makes a
few launches whatever the width, and no byte depends on the order of a
scatter.
"""

from __future__ import annotations

import numpy as np
import torch

from auron_tpu_torch.columnar.batch import StringColumn


def literal_to_device(s: bytes | str, width: int) -> tuple[np.ndarray, int]:
    """A literal as a zero-padded row of ``width`` bytes, and its length.
    A literal longer than ``width`` gives a row of zeros and its true
    length, which no value of the column can match."""
    b = s.encode() if isinstance(s, str) else s
    out = np.zeros(width, np.uint8)
    if len(b) <= width:
        out[:len(b)] = np.frombuffer(b, np.uint8)
    return out, len(b)


#: flips the sign bit: int64 order of ``u ^ SIGN`` is uint64 order of u
SIGN = torch.iinfo(torch.int64).min


def string_be_words(chars: torch.Tensor) -> torch.Tensor:
    """[n, w] uint8 → [n, ceil(w/8)] big-endian 64-bit words whose
    uint64 order is byte-lexicographic order (zero padding sorts a
    prefix first; SQL strings hold no NUL), as int64 words
    ``u ^ 2^63`` in that order."""
    n, w = chars.shape
    pad = (-w) % 8
    if pad:
        chars = torch.nn.functional.pad(chars, (0, pad))
    b = chars.to(torch.int64).reshape(n, -1, 8)
    u = b[:, :, 0] << 56
    for k in range(1, 8):
        u = u | (b[:, :, k] << (56 - 8 * k))
    return u ^ SIGN


def le_words(chars: torch.Tensor, size: int) -> torch.Tensor:
    """[n, w] bytes → [n, ceil(w/size)] little-endian words of ``size``
    bytes (4 or 8) in int64 lanes; an 8-byte word keeps its top byte's
    bit 63 as the sign bit, so its bits are the uint64 word's."""
    n, w = chars.shape
    pad = (-w) % size
    if pad:
        chars = torch.nn.functional.pad(chars, (0, pad))
    b = chars.to(torch.int64).reshape(n, -1, size)
    out = b[:, :, 0]
    for k in range(1, size):
        out = out | (b[:, :, k] << (8 * k))
    return out


def compare(a_chars, a_lens, b_chars, b_lens):
    """Three-way compare in lexicographic byte order: (lt, eq) bool[n].
    Either side may be one row (a literal), broadcast over the other."""
    w = max(a_chars.shape[1], b_chars.shape[1])
    wa = string_be_words(
        torch.nn.functional.pad(a_chars, (0, w - a_chars.shape[1])))
    wb = string_be_words(
        torch.nn.functional.pad(b_chars, (0, w - b_chars.shape[1])))
    k, n = wa.shape[1], max(wa.shape[0], wb.shape[0])
    lt = torch.zeros(n, dtype=torch.bool, device=wa.device)
    eq = torch.ones(n, dtype=torch.bool, device=wa.device)
    for i in range(k):
        lt = lt | (eq & (wa[:, i] < wb[:, i]))
        eq = eq & (wa[:, i] == wb[:, i])
    # equal padded bytes with different lengths only where a value holds
    # NUL bytes, which SQL strings here do not
    return lt, eq & (a_lens == b_lens)


def positions(w: int, device) -> torch.Tensor:
    """int32 [1, w]: the byte positions of a row."""
    return torch.arange(w, dtype=torch.int32, device=device)[None, :]


def literal_tensor(b: bytes, device) -> torch.Tensor:
    """The bytes of a literal as a uint8 tensor on ``device``."""
    return torch.tensor(list(b), dtype=torch.uint8, device=device)


def starts_with(chars, lens, prefix: bytes) -> torch.Tensor:
    n, w = chars.shape
    m = len(prefix)
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=chars.device)
    if m > w:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    lit = literal_tensor(prefix, chars.device)
    return (chars[:, :m] == lit).all(dim=1) & (lens >= m)


def ends_with(chars, lens, suffix: bytes) -> torch.Tensor:
    n, w = chars.shape
    m = len(suffix)
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=chars.device)
    if m > w:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    lit = literal_tensor(suffix, chars.device)
    # the last m bytes of each row
    idx = (lens - m).clamp(min=0)[:, None] + positions(m, chars.device)
    tail = torch.gather(chars, 1, idx.clamp(0, w - 1).long())
    return (tail == lit).all(dim=1) & (lens >= m)


def window_hits(chars, lens, needle: bytes) -> torch.Tensor:
    """bool [n, w - m + 1]: the needle starts at byte s of the row and
    ends within its length; every start compared at once."""
    m = len(needle)
    lit = literal_tensor(needle, chars.device)
    wins = chars.unfold(1, m, 1)                       # [n, w - m + 1, m]
    ends = positions(wins.shape[1], chars.device) + m
    return (wins == lit).all(dim=2) & (ends <= lens[:, None])


def contains(chars, lens, infix: bytes) -> torch.Tensor:
    n, w = chars.shape
    m = len(infix)
    if m == 0:
        return torch.ones(n, dtype=torch.bool, device=chars.device)
    if m > w:
        return torch.zeros(n, dtype=torch.bool, device=chars.device)
    return window_hits(chars, lens, infix).any(dim=1)


def shift_gather(chars, start, out_w: int) -> torch.Tensor:
    """uint8 [n, out_w]: row i's bytes from ``start[i]`` on (positions
    past the row's width read its last byte; callers mask by length)."""
    w = chars.shape[1]
    idx = start.to(torch.int64)[:, None] + positions(out_w, chars.device)
    return torch.gather(chars, 1, idx.clamp(0, w - 1))


def masked(chars, out_len) -> torch.Tensor:
    """``chars`` with every byte at or past ``out_len`` zeroed."""
    keep = positions(chars.shape[1], chars.device) < out_len[:, None]
    return torch.where(keep, chars, 0).to(torch.uint8)


def substring(col: StringColumn, start, length) -> StringColumn:
    """1-based SQL substring with Spark's semantics (UTF8String.
    substringSQL): start > 0 → start - 1; start == 0 → 0; start < 0 →
    len + start, unclamped, so the window [start, start + length) is
    taken before it is clipped to the string: substring('hello', -10, 2)
    is ''. The end is computed in int64, since the two-argument form
    passes a length of 2^30 and the three-argument form may pass
    Int.MaxValue."""
    chars, lens = col.chars, col.lens
    start = start.to(torch.int32)
    length = length.to(torch.int64).clamp(min=0)
    raw = torch.where(start > 0, start - 1,
                      torch.where(start == 0, 0, lens + start))
    end = torch.minimum(torch.clamp(raw.to(torch.int64) + length, min=0),
                        lens.to(torch.int64)).to(torch.int32)
    zero_based = torch.minimum(raw.clamp(min=0), lens)
    out_len = (end - zero_based).clamp(min=0).to(torch.int32)
    out = shift_gather(chars, zero_based, chars.shape[1])
    return StringColumn(masked(out, out_len), out_len, col.validity)


def place(out, pos, chars, lens, include):
    """``out`` with row i's first ``lens[i]`` bytes of ``chars`` written
    at ``pos[i]`` where ``include[i]``: one gather over the output width
    (the source byte of output position j is j - pos). Returns (out,
    pos advanced by the written length)."""
    out_w = out.shape[1]
    src = positions(out_w, out.device) - pos[:, None]
    take = (src >= 0) & (src < lens[:, None]) & include[:, None]
    got = torch.gather(chars, 1,
                       src.clamp(0, chars.shape[1] - 1).to(torch.int64))
    return (torch.where(take, got, out),
            pos + torch.where(include, lens, 0))


def concat(cols: list, out_width: int) -> StringColumn:
    """Concatenate string columns row-wise (null if any is null, as
    Spark's concat)."""
    n = cols[0].capacity
    dev = cols[0].chars.device
    out = torch.zeros((n, out_width), dtype=torch.uint8, device=dev)
    pos = torch.zeros(n, dtype=torch.int32, device=dev)
    every = torch.ones(n, dtype=torch.bool, device=dev)
    validity = cols[0].validity
    for c in cols:
        out, pos = place(out, pos, c.chars, c.lens, every)
    for c in cols[1:]:
        validity = validity & c.validity
    return StringColumn(out, torch.where(validity, pos, 0), validity)


def upper(col: StringColumn) -> StringColumn:
    c = col.chars
    is_lower = (c >= ord("a")) & (c <= ord("z"))
    return StringColumn(torch.where(is_lower, c - 32, c), col.lens,
                        col.validity)


def lower(col: StringColumn) -> StringColumn:
    c = col.chars
    is_upper = (c >= ord("A")) & (c <= ord("Z"))
    return StringColumn(torch.where(is_upper, c + 32, c), col.lens,
                        col.validity)


def trim(col: StringColumn, left: bool = True,
         right: bool = True) -> StringColumn:
    """Strip ASCII spaces from either end."""
    chars, lens = col.chars, col.lens
    n, w = chars.shape
    pos = positions(w, chars.device)
    in_str = pos < lens[:, None]
    solid = (chars != ord(" ")) & in_str
    if right:
        new_len = torch.where(solid, pos, -1).amax(dim=1) + 1
    else:
        new_len = lens
    if left:
        first = torch.minimum(torch.where(solid, pos, w).amin(dim=1),
                              new_len)
        chars = shift_gather(chars, first, w)
        new_len = new_len - first
    new_len = new_len.clamp(min=0).to(torch.int32)
    return StringColumn(masked(chars, new_len), new_len, col.validity)
