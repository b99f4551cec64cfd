"""Power-of-two sizing, a copy of ``auron_tpu.utils.shapes.next_pow2``.

The hash table's slot capacities are powers of two: double hashing with
an odd step visits every slot of a 2^k table.
"""

from __future__ import annotations


def next_pow2(n: int) -> int:
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()
