"""Power-of-two sizing and string width buckets, a copy of
``auron_tpu.utils.shapes``.

The hash table's slot capacities are powers of two: double hashing with
an odd step visits every slot of a 2^k table. Group tables and exchange
slices round their row counts up to a power of two the same way, so the
port's capacities are the reference's. A string column's char matrix is
as wide as the bucket of its longest value, so a column's words and
hashes are the reference's at the same width.
"""

from __future__ import annotations

DEFAULT_BATCH_CAPACITY = 8192

#: width buckets for fixed-width device string columns (bytes per slot)
STRING_WIDTH_BUCKETS = (8, 16, 32, 64, 128, 256)


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_rows(n: int, minimum: int = 16) -> int:
    """Round a row count up to a power of two (>= minimum)."""
    return max(minimum, next_pow2(n))


def bucket_string_width(max_len: int) -> int:
    """Round a max string byte-length up to a width bucket; past the
    last bucket, to the next multiple of 256."""
    for w in STRING_WIDTH_BUCKETS:
        if max_len <= w:
            return w
    return ((max_len + 255) // 256) * 256
