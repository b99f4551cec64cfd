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

On the general (unbounded-key) path, ``select_hash_agg`` picks the
device hash table (hashtable/) or the sort path.

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
from auron_tpu_torch.hashtable.core import SUPPORTED_KINDS
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


def record_rows(decision: KernelDecision, rows: int,
                metrics=None) -> None:
    """Accumulate the bytes-moved estimate for ``rows`` input rows
    against the decision's kernel (registry, and the task's metrics when
    given)."""
    est = rows * decision.bytes_per_row
    registry.stats(decision.kernel).add("bytes_moved_est", est)
    _count(metrics, "bytes_moved_est", est)


def _count(metrics, name: str, v: int = 1) -> None:
    if metrics is not None:
        metrics.counter(name).add(v)


@dataclass(frozen=True)
class HashAggDecision:
    """The general-path grouping decision: hashtable vs sort."""
    backend: str             # hashtable | sort
    reason: str
    load_factor: float = 0.5
    max_probe_rounds: int = 64

    @property
    def is_hash(self) -> bool:
        return self.backend == "hashtable"


#: key column dtypes with a hashtable word encoding; nested types
#: (STRUCT/LIST/MAP) stay on the sort path. hashtable/core.key_meta
#: encodes primitive, string and decimal (narrow or two-limb) columns.
HASH_KEY_DTYPES = frozenset(
    {DataType.BOOL, DataType.INT8, DataType.INT16, DataType.INT32,
     DataType.INT64, DataType.FLOAT32, DataType.FLOAT64,
     DataType.DATE32, DataType.TIMESTAMP_US, DataType.STRING,
     DataType.DECIMAL})


def record_operator_choice(metrics, backend: str) -> None:
    """Mirror the chosen grouping backend into the operator's metrics
    (not just the shared kernel counters), so the finalize snapshot
    shows which backend each operator actually ran."""
    _count(metrics, f"dispatch_{backend}")


def select_hash_agg(*, key_dtypes, acc_kinds, has_float_sum: bool,
                    conf=None, metrics=None,
                    record: bool = True) -> HashAggDecision:
    """The general (unbounded-key) grouping decision: the device hash
    table (hashtable/) or the sort + segment-reduce path.

    key_dtypes: DataType per group key (nested types fall back).
    acc_kinds: flat device reduce kinds.
    has_float_sum: any float-dtype 'sum' accumulator. Scatter-adds
    reassociate, so 'auto' keeps those on the sort path and only
    auron.hashtable.backend=hash forces them through the table.
    ``metrics``: an object with ``counter(name).add(v)``, or None.
    """
    conf = conf or cfg.get_config()

    def decide(backend: str, reason: str) -> HashAggDecision:
        if record:
            event = "selected" if backend == "hashtable" else "fallback"
            registry.stats("hashtable").add(event)
            _count(metrics, f"hashtable_{event}")
        return HashAggDecision(
            backend, reason,
            load_factor=conf.get(cfg.HASHTABLE_LOAD_FACTOR),
            max_probe_rounds=max(1, conf.get(
                cfg.HASHTABLE_MAX_PROBE_ROUNDS)))

    if not conf.get(cfg.HASHTABLE_ENABLED):
        return decide("sort", "disabled")
    choice = conf.get(cfg.HASHTABLE_BACKEND)
    if choice == "sort":
        return decide("sort", "backend_config")
    if choice not in ("auto", "hash"):
        raise ValueError(
            f"auron.hashtable.backend: unknown backend {choice!r} "
            "(auto|hash|sort)")
    kds = tuple(key_dtypes)
    if not kds:
        return decide("sort", "no_keys")
    bad = [d for d in kds if d not in HASH_KEY_DTYPES]
    if bad:
        return decide("sort", f"key_dtype:{bad[0].value}")
    for kind in acc_kinds:
        if kind not in SUPPORTED_KINDS:
            return decide("sort", f"acc_kind:{kind}")
    if has_float_sum and choice != "hash":
        # scatter-add reassociates float sums; 'auto' keeps results
        # bit-identical to the sort path by falling back
        return decide("sort", "float_sum_inexact")
    return decide("hashtable", "eligible")


def select_grouped_agg(*, key_domain: Optional[int], key_dtypes,
                       agg_fns, value_dtypes, conf=None,
                       platform: Optional[str] = None, metrics=None,
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
            _count(metrics, "sort_selected")
            _count(metrics, "fallback")
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
        _count(metrics, f"{backend}_selected")
        if interpret:
            registry.stats(backend).add("interpret")
            _count(metrics, "interpret")
    return KernelDecision(backend, interpret, "eligible",
                          BYTES_PER_ROW[backend])
