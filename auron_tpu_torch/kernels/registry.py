"""Kernel registry + per-kernel counters.

The port's kernels register here with their capability envelope, and the
dispatch policy (kernels/dispatch.py) counts every decision against them:
a process-global ``KernelStats`` per kernel (selected / fallback /
interpret counts, bytes-moved estimate), readable via ``snapshot()``.
These count decisions; the number of times a CUDA kernel actually
launched is the ``launches`` attribute of its wrapper.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class KernelInfo:
    """One registered kernel implementation.

    ``name`` is the dispatch identifier; ``reductions`` the reduce kinds
    it computes; ``max_key_domain`` the dense key-domain ceiling (0 =
    unbounded); ``platforms`` the device types it runs natively on
    ('*' = any); ``interpretable`` whether a plain PyTorch version stands
    in for it elsewhere.
    """

    name: str
    description: str
    reductions: tuple
    max_key_domain: int
    platforms: tuple
    interpretable: bool = False


class KernelStats:
    """Monotonic per-kernel counters (thread-safe adds)."""

    __slots__ = ("selected", "fallback", "interpret", "bytes_moved_est",
                 "_lock")

    def __init__(self):
        self.selected = 0
        self.fallback = 0
        self.interpret = 0
        self.bytes_moved_est = 0
        self._lock = threading.Lock()

    def add(self, name: str, v: int = 1) -> None:
        with self._lock:
            setattr(self, name, getattr(self, name) + v)

    def snapshot(self) -> dict:
        with self._lock:
            return {"selected": self.selected, "fallback": self.fallback,
                    "interpret": self.interpret,
                    "bytes_moved_est": self.bytes_moved_est}


_REGISTRY: dict[str, KernelInfo] = {}
_STATS: dict[str, KernelStats] = {}
_LOCK = threading.Lock()


def register(info: KernelInfo) -> KernelInfo:
    with _LOCK:
        if info.name in _REGISTRY:
            raise ValueError(f"duplicate kernel {info.name}")
        _REGISTRY[info.name] = info
        _STATS[info.name] = KernelStats()
    return info


def lookup(name: str) -> Optional[KernelInfo]:
    return _REGISTRY.get(name)


def kernels() -> list[KernelInfo]:
    return sorted(_REGISTRY.values(), key=lambda k: k.name)


def stats(name: str) -> KernelStats:
    with _LOCK:
        if name not in _STATS:
            _STATS[name] = KernelStats()
        return _STATS[name]


def snapshot() -> dict:
    """{kernel name: counter dict} — the process-global view."""
    with _LOCK:
        items = list(_STATS.items())
    return {k: s.snapshot() for k, s in items}


# ---------------------------------------------------------------------------
# built-in kernels
# ---------------------------------------------------------------------------

CUDA_DENSE = register(KernelInfo(
    name="cuda_dense",
    description=(
        "CUDA grouped sum/count over a bounded key domain "
        "(kernels/csrc/grouped_agg.cu): one pass over the ~12 B/row "
        "inputs, float atomics into L2-resident [key_domain] grids. The "
        "port of the Pallas VMEM-accumulate kernel."),
    reductions=("sum", "count"),
    max_key_domain=1 << 16,
    platforms=("cuda",),
    interpretable=True,
))

DENSE_MATMUL = register(KernelInfo(
    name="dense_matmul",
    description=(
        "One-hot matmul grouped sum/count (hi-byte one-hot x values, "
        "transposed, times the lo-byte one-hot), tiled over 2^16-row "
        "blocks; full-f32 products."),
    reductions=("sum", "count"),
    max_key_domain=1 << 16,
    platforms=("*",),
))

HASHTABLE = register(KernelInfo(
    name="hashtable",
    description=(
        "Device-resident open-addressing hash table "
        "(auron_tpu_torch/hashtable): claim-owner probe rounds (one "
        "scatter-min + gathers per round, compacted tail) in PyTorch ops "
        "build the group table; accumulators scatter into their slots. "
        "Unbounded key domains, primitive and string keys, "
        "reassociation-exact "
        "reduce kinds (sum/min/max/or/first); the general-agg "
        "replacement for sort + segment-reduce."),
    reductions=("sum", "count", "min", "max", "or", "first"),
    max_key_domain=0,            # unbounded
    platforms=("*",),
))

SORT_GENERAL = register(KernelInfo(
    name="sort",
    description=(
        "General sort-based grouping (xxhash64 -> stable sort -> segment "
        "reduce): unbounded key domains. The dispatch fallback."),
    reductions=("sum", "count", "min", "max", "or", "first"),
    max_key_domain=0,            # unbounded
    platforms=("*",),
))
