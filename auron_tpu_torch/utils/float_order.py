"""Order-preserving integer images of floats, for min and max.

A float's IEEE-754 bits, read as a signed integer, order the
non-negative floats; the negative ones come out backwards. Flipping
every bit but the sign of a negative float's bits mends that: the image
is an int64 whose signed order is the float order, with ``-0.0`` below
``0.0`` and ±inf at the ends. (Sort order words use the same map as
uint64, its sign bit flipped; see ``ops/sort.py``.)

The reference's float min and max (XLA's ``segment_min``, ``.at[].min``,
``jnp.minimum``) order ``-0.0`` below ``0.0`` and return NaN for a group
that holds one. PyTorch's ``scatter_reduce_`` and ``torch.minimum`` keep
whichever zero comes first, and on a CUDA device atomics decide which
that is. So the port reduces floats through the image: an integer
``amin``/``amax``, whose result no order of atomics changes, mapped back,
and NaN wherever a group saw a NaN.
"""

from __future__ import annotations

import torch

_INT_OF = {torch.float32: torch.int32, torch.float64: torch.int64}


def ordered_int(x: torch.Tensor) -> torch.Tensor:
    """int64 image of a float tensor: signed order = float order,
    ``-0.0 < 0.0``. NaNs land at either end by their sign bit."""
    bits = torch.finfo(x.dtype).bits
    b = x.view(_INT_OF[x.dtype]).to(torch.int64)    # sign-extended
    return b ^ ((b >> (bits - 1)) & ((1 << (bits - 1)) - 1))


def from_ordered_int(i: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The floats of ``dtype`` whose images are ``i`` (the map is its own
    inverse on the bits)."""
    bits = torch.finfo(dtype).bits
    b = i ^ ((i >> (bits - 1)) & ((1 << (bits - 1)) - 1))
    return b.to(_INT_OF[dtype]).view(dtype)


def _reduce(kind: str) -> str:
    if kind not in ("min", "max"):
        raise ValueError(f"not a min/max reduction: {kind!r}")
    return "amin" if kind == "min" else "amax"


def scatter_min_max(acc: torch.Tensor, index: torch.Tensor,
                    vals: torch.Tensor, kind: str) -> torch.Tensor:
    """``acc.clone().scatter_reduce_(0, index, vals, "a" + kind)``, with
    floats ordered ``-0.0 < 0.0`` and NaN in every slot that holds or
    receives one. ``acc`` is not changed."""
    reduce = _reduce(kind)
    if not acc.dtype.is_floating_point:
        return acc.clone().scatter_reduce_(0, index, vals, reduce)
    img = ordered_int(acc).scatter_reduce_(0, index, ordered_int(vals),
                                           reduce)
    nans = torch.zeros(acc.shape, dtype=torch.int32,
                       device=acc.device).index_add_(
        0, index, torch.isnan(vals).to(torch.int32))
    return torch.where(torch.isnan(acc) | (nans > 0), torch.nan,
                       from_ordered_int(img, acc.dtype))


def min_max(a: torch.Tensor, b: torch.Tensor, kind: str) -> torch.Tensor:
    """Elementwise min or max in the same order: ``-0.0 < 0.0``, NaN if
    either side is NaN."""
    _reduce(kind)
    op = torch.minimum if kind == "min" else torch.maximum
    if not a.dtype.is_floating_point:
        return op(a, b)
    out = from_ordered_int(op(ordered_int(a), ordered_int(b)), a.dtype)
    return torch.where(torch.isnan(a) | torch.isnan(b), torch.nan, out)
