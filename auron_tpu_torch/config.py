"""Typed configuration registry of the port.

The same shape as ``auron_tpu.config``: declared options with defaults and
docs, resolved at use-site through ``AuronConfig.get`` with precedence

    programmatic override  >  env var  >  default

The port keeps its own registry (the JAX package's is pinned to its
generated ``CONFIG.md``) and declares only the knobs its code reads,
under the JAX package's key names so one setting means the same thing
to both. Env binding: ``auron.kernels.backend`` ←
``AURON_CONF_KERNELS_BACKEND``.
"""

from __future__ import annotations

import os
import threading
from dataclasses import dataclass
from typing import Any, Optional


@dataclass(frozen=True)
class ConfigOption:
    key: str
    dtype: type           # int | float | bool | str
    default: Any
    doc: str

    @property
    def env_var(self) -> str:
        return "AURON_CONF_" + self.key.replace("auron.", "", 1) \
            .replace(".", "_").upper()

    def parse(self, raw: str) -> Any:
        if self.dtype is bool:
            v = raw.strip().lower()
            if v in ("1", "true", "yes", "on"):
                return True
            if v in ("0", "false", "no", "off"):
                return False
            raise ValueError(f"{self.key}: invalid bool {raw!r}")
        return self.dtype(raw)


_REGISTRY: dict[str, ConfigOption] = {}


def _opt(key: str, dtype: type, default, doc: str) -> str:
    if key in _REGISTRY:
        raise ValueError(f"duplicate config option {key}")
    _REGISTRY[key] = ConfigOption(key, dtype, default, doc)
    return key


KERNELS_ENABLED = _opt(
    "auron.kernels.enabled", bool, True,
    "Allow the dense grouped-aggregation kernels when the key domain is "
    "bounded; off forces the sort-based path (kernels/dispatch.py).")
KERNELS_MAX_KEY_DOMAIN = _opt(
    "auron.kernels.max_key_domain", int, 1 << 16,
    "Largest bounded key domain eligible for the dense grouped-agg "
    "kernels. Hard-capped at 2^16 (kernels/grouped_agg.MAX_KEY_DOMAIN).")
KERNELS_BACKEND = _opt(
    "auron.kernels.backend", str, "auto",
    "Dense grouped-agg backend: 'auto' launches the CUDA kernel on a CUDA "
    "device and runs its plain PyTorch version elsewhere; 'cuda' forces "
    "the same choice; 'dense' forces the one-hot matmul formulation; "
    "'sort' disables the dense path.")
# device-resident hash table (hashtable/)
HASHTABLE_ENABLED = _opt(
    "auron.hashtable.enabled", bool, True,
    "Allow the device-resident open-addressing hash table "
    "(auron_tpu_torch/hashtable) on the general (unbounded-key) "
    "aggregation path, distinct dedup, and the hash-join candidate "
    "search; off forces the sort-based formulations everywhere "
    "(kernels/dispatch.select_hash_agg).")
HASHTABLE_BACKEND = _opt(
    "auron.hashtable.backend", str, "auto",
    "General-agg grouping backend: 'auto' routes aggregations whose "
    "accumulators are reassociation-exact (integer/decimal sums, "
    "min/max, first, count) through the hash table and keeps float "
    "sums on the sort path so results stay bit-identical either way; "
    "'hash' forces the hash table wherever its kinds are structurally "
    "supported (float scatter-adds may differ from the sort path in "
    "the last ulp); 'sort' disables the hash path entirely.")
HASHTABLE_LOAD_FACTOR = _opt(
    "auron.hashtable.load_factor", float, 0.5,
    "Maximum occupancy of the device hash table before a power-of-two "
    "growth re-bucket (the auron.agg.initial_capacity growth "
    "discipline). Lower values buy shorter probe chains with more "
    "device memory.")
HASHTABLE_MAX_PROBE_ROUNDS = _opt(
    "auron.hashtable.max_probe_rounds", int, 64,
    "Probe rounds (double-hashed open addressing) the vectorized "
    "insert/probe loop runs before declaring overflow; an overflowing "
    "insert grows the table and retries, and pathological repeat "
    "overflow falls back to the sort path for the rest of the stream.")


# batching / shapes
BATCH_CAPACITY = _opt(
    "auron.batch.capacity", int, 1 << 16,
    "Default rows per device batch (scan batch size and the planner's "
    "capacity bucketing target). Larger batches amortize kernel launches; "
    "smaller ones reduce padding waste on ragged inputs.")
PARQUET_BATCH_ROWS = _opt(
    "auron.io.parquet.batch_rows", int, 1 << 16,
    "Row-group read granularity for the parquet/ORC scans when the plan "
    "does not pin batch_rows explicitly and auron.scan.batch_rows is 0 "
    "on a non-CPU platform (legacy knob; auron.scan.batch_rows wins "
    "when set).")
SCAN_BATCH_ROWS = _opt(
    "auron.scan.batch_rows", int, 0,
    "Rows per file-scan device batch (parquet/ORC). 0 (default) = auto: "
    "2^17 on the CPU, where larger batches amortize the per-batch host "
    "glue, and auron.io.parquet.batch_rows (2^16) on a CUDA device. The "
    "scan clamps the conversion capacity to the partition's actual row "
    "count bucket, so small files never pad to the full batch size.")
# aggregation
AGG_INITIAL_CAPACITY = _opt(
    "auron.agg.initial_capacity", int, 4096,
    "Initial group-state capacity of the agg merge kernel; grows by "
    "power-of-two re-bucketing when exceeded.")
AGG_PARTIAL_SKIP_ENABLED = _opt(
    "auron.agg.partial_skip.enabled", bool, True,
    "Adaptive partial-agg skipping: when the observed group/input "
    "cardinality ratio stays high, the partial stage stops merging and "
    "passes rows through in state layout (the reference's "
    "spark.auron.partialAggSkipping.*, agg_ctx.rs:63-196).")
AGG_PARTIAL_SKIP_RATIO = _opt(
    "auron.agg.partial_skip.ratio", float, 0.8,
    "Cardinality ratio (distinct groups / input rows) at or above which "
    "the partial agg switches to pass-through.")
AGG_PARTIAL_SKIP_MIN_ROWS = _opt(
    "auron.agg.partial_skip.min_rows", int, 1 << 16,
    "Input rows to observe before the skip decision is made.")
# whole-stage fusion (ir/planner.fuse_stages, ops/fused.py)
FUSION_ENABLED = _opt(
    "auron.fusion.enabled", bool, True,
    "Whole-stage fusion: the planner chains maximal runs of row-local "
    "operators (filter, project, limit-within-batch, rename) into one "
    "FusedStageOp per stage, which runs its members' per-batch steps in "
    "order with one carry per member. Off runs every operator on its "
    "own. The plan NORMALIZATION half of the pass (pre-agg key/value "
    "projection, pure-projection elision under aggs) applies under BOTH "
    "settings, so on and off give the same rows; 'off' restores the "
    "per-operator layout, not the exact pre-fusion plan shape.")
FUSION_MAX_STAGE_OPS = _opt(
    "auron.fusion.max_stage_ops", int, 8,
    "Longest operator chain a single fused stage may contain. Longer "
    "chains split into multiple stages.")
MAP_KEY_DEDUP_POLICY = _opt(
    "auron.map.key_dedup_policy", str, "LAST_WIN",
    "Duplicate-key policy of the map constructors (map, create_map, "
    "map_from_arrays, map_from_entries, map_concat): 'LAST_WIN' keeps "
    "the last entry per key (Spark's legacy policy, the default); "
    "'EXCEPTION' (Spark's default) raises a ValueError when a live row "
    "builds a map with a duplicate key. The port evaluates eagerly, so "
    "it always raises where the reference, inside a fused stage, nulls "
    "the offending rows instead.")


def file_scan_batch_rows(conf: "AuronConfig", device) -> int:
    """File-scan batch sizing: ``auron.scan.batch_rows`` when set; 0
    resolves per device type: 2^17 on the CPU, else
    ``auron.io.parquet.batch_rows``."""
    explicit = int(conf.get(SCAN_BATCH_ROWS))
    if explicit > 0:
        return explicit
    if str(getattr(device, "type", device)) == "cpu":
        return 1 << 17
    return conf.get(PARQUET_BATCH_ROWS)


class AuronConfig:
    """One resolved configuration: programmatic overrides > env > default."""

    def __init__(self, overrides: Optional[dict] = None):
        self._overrides: dict[str, Any] = {}
        self._lock = threading.Lock()
        for k, v in (overrides or {}).items():
            self.set(k, v)

    def set(self, key: str, value) -> "AuronConfig":
        opt = _REGISTRY.get(key)
        if opt is None:
            raise KeyError(f"unknown config option {key!r}; "
                           f"known: {sorted(_REGISTRY)}")
        if isinstance(value, str) and opt.dtype is not str:
            value = opt.parse(value)
        if opt.dtype is float and isinstance(value, int):
            value = float(value)
        if not isinstance(value, opt.dtype):
            raise TypeError(f"{key} expects {opt.dtype.__name__}, "
                            f"got {type(value).__name__}")
        with self._lock:
            self._overrides[key] = value
        return self

    def unset(self, key: str) -> None:
        with self._lock:
            self._overrides.pop(key, None)

    def get(self, key: str):
        opt = _REGISTRY.get(key)
        if opt is None:
            raise KeyError(f"unknown config option {key!r}")
        with self._lock:
            if key in self._overrides:
                return self._overrides[key]
        raw = os.environ.get(opt.env_var)
        if raw is not None:
            return opt.parse(raw)
        return opt.default


#: process-wide default config
_GLOBAL = AuronConfig()


def get_config() -> AuronConfig:
    return _GLOBAL


def options() -> list[ConfigOption]:
    return sorted(_REGISTRY.values(), key=lambda o: o.key)
