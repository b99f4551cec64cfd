"""Power-of-two sizing, a copy of ``auron_tpu.utils.shapes``.

The hash table's slot capacities are powers of two: double hashing with
an odd step visits every slot of a 2^k table. Group tables and exchange
slices round their row counts up to a power of two the same way, so the
port's capacities are the reference's.
"""

from __future__ import annotations

DEFAULT_BATCH_CAPACITY = 8192


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def bucket_rows(n: int, minimum: int = 16) -> int:
    """Round a row count up to a power of two (>= minimum)."""
    return max(minimum, next_pow2(n))
