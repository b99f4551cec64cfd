"""Kernel-selection policy for grouped aggregation.

The port of ``auron_tpu.kernels.dispatch``: given what the plan knows
about an aggregation (key-domain bound, key/value dtypes, aggregate set)
and the device it runs on, pick one of

- ``cuda_dense``    — the CUDA kernel (kernels/grouped_agg.cuda_sum_count)
                      on a CUDA device, and its plain PyTorch version
                      (``interpret=True``) elsewhere, as the reference
                      runs its Pallas kernel through the interpreter off
                      the TPU;
- ``dense_matmul``  — the one-hot matmul formulation;
- ``sort``          — the general sort-based path: the fallback.

The reason strings are the reference's, so the same plans take the same
paths for the same reasons. Every decision is counted in
kernels/registry.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from auron_tpu_torch import config as cfg
from auron_tpu_torch.columnar.schema import DataType
from auron_tpu_torch.kernels import grouped_agg, registry

#: aggregate functions the dense-domain path finalizes
DENSE_AGG_FNS = frozenset(
    {"count", "count_star", "sum", "avg", "min", "max"})

#: integer-class key dtypes the dense grids accept
DENSE_KEY_DTYPES = frozenset(
    {DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64})

#: value dtypes with a dense accumulator formulation
DENSE_VALUE_DTYPES = frozenset(
    {DataType.INT8, DataType.INT16, DataType.INT32, DataType.INT64,
     DataType.FLOAT32, DataType.FLOAT64, DataType.DATE32})

#: device-memory traffic estimates, bytes per input row: the CUDA kernel
#: reads k/v/c once (12 B/row); the matmul path materializes one-hot and
#: lhs operands (~(3*gh + gl)*4 at the full 256x256 grid); the sort path
#: re-reads rows across hash/sort/segment passes
BYTES_PER_ROW = {"cuda_dense": 12, "dense_matmul": 4096, "sort": 48}


@dataclass(frozen=True)
class KernelDecision:
    kernel: str              # cuda_dense | dense_matmul | sort
    interpret: bool          # plain PyTorch version instead of the kernel
    reason: str              # why this kernel (or why the fallback)
    bytes_per_row: int       # memory-traffic estimate for metrics

    @property
    def is_dense(self) -> bool:
        return self.kernel != "sort"


def _platform(platform: Optional[str]) -> str:
    if platform is not None:
        return platform
    return "cuda" if torch.cuda.is_available() else "cpu"


def backend_for_platform(conf=None, platform: Optional[str] = None
                         ) -> tuple[str, bool]:
    """(backend, interpret) honoring ``auron.kernels.backend``.

    ``platform`` is a device type (``cuda``, ``cpu``). ``auto`` and
    ``cuda`` both pick the CUDA kernel, natively on ``cuda`` and as its
    plain version elsewhere."""
    conf = conf or cfg.get_config()
    choice = conf.get(cfg.KERNELS_BACKEND)
    plat = _platform(platform)
    if choice in ("auto", "cuda"):
        return "cuda_dense", plat != "cuda"
    if choice == "dense":
        return "dense_matmul", False
    if choice == "sort":
        return "sort", False
    raise ValueError(
        f"auron.kernels.backend: unknown backend {choice!r} "
        "(auto|cuda|dense|sort)")


def record_rows(decision: KernelDecision, rows: int) -> None:
    """Accumulate the bytes-moved estimate for ``rows`` input rows
    against the decision's kernel."""
    registry.stats(decision.kernel).add(
        "bytes_moved_est", rows * decision.bytes_per_row)


def select_grouped_agg(*, key_domain: Optional[int], key_dtypes,
                       agg_fns, value_dtypes, conf=None,
                       platform: Optional[str] = None,
                       record: bool = True) -> KernelDecision:
    """The grouped-agg kernel decision.

    key_domain: exclusive upper bound on the (non-negative) group keys,
    or None when unbounded. key_dtypes/value_dtypes: DataType per group
    key / aggregate argument. agg_fns: aggregate function names.
    ``record=False`` returns the decision without touching any counter,
    for callers that count the kernel they actually run themselves."""
    conf = conf or cfg.get_config()

    def fallback(reason: str) -> KernelDecision:
        if record:
            registry.stats("sort").add("selected")
            registry.stats("sort").add("fallback")
        return KernelDecision("sort", False, reason, BYTES_PER_ROW["sort"])

    if not conf.get(cfg.KERNELS_ENABLED):
        return fallback("disabled")
    if key_domain is None:
        return fallback("unbounded_key_domain")
    if key_domain <= 0:
        return fallback("empty_key_domain")
    if key_domain > min(conf.get(cfg.KERNELS_MAX_KEY_DOMAIN),
                        grouped_agg.MAX_KEY_DOMAIN):
        return fallback("key_domain_too_large")
    kds = tuple(key_dtypes)
    if len(kds) != 1:
        # the dense grids take ONE integer key; composite keys sort
        return fallback("multi_key" if kds else "no_key")
    bad = [d for d in kds if d not in DENSE_KEY_DTYPES]
    if bad:
        return fallback(f"key_dtype:{bad[0].value}")
    for fn in agg_fns:
        if fn not in DENSE_AGG_FNS:
            return fallback(f"agg_fn:{fn}")
    for d in value_dtypes:
        if d not in DENSE_VALUE_DTYPES:
            return fallback(f"value_dtype:{d.value}")

    backend, interpret = backend_for_platform(conf, platform)
    if backend == "sort":
        return fallback("backend_config")
    if record:
        registry.stats(backend).add("selected")
        if interpret:
            registry.stats(backend).add("interpret")
    return KernelDecision(backend, interpret, "eligible",
                          BYTES_PER_ROW[backend])
