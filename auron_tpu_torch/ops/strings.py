"""Device string kernels over fixed-width byte matrices, in part.

The port of the first part of ``auron_tpu.ops.strings``: a literal's
padded row and the three-way compare, and the two word packers every
string path shares: big-endian words in sort order (``ops.sort``, the
compare) and little-endian words (the hashes, the hash table's key
codec). Every kernel takes the padded layout of
``columnar.batch.StringColumn`` (chars uint8 [n, w], lens int32 [n]). Zero padding makes plain byte-wise comparison
coincide with lexicographic order (0 sorts below every byte, so a proper
prefix sorts first), so a compare is a compare of integer words. The
string functions and predicates (``like``, ``startswith``, ``substr``,
...) come with ROADMAP item 17.
"""

from __future__ import annotations

import numpy as np
import torch


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
