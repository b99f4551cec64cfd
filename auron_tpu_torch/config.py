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
    dtype: type           # int | bool | str
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
