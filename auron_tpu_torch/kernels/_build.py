"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library
with a plain C interface, loaded with ``ctypes``. The library's file name
carries a hash of its source, the headers and the flags, so an edited
source rebuilds and an unchanged one is loaded from ``kernels/build/``.
Nothing is built on import: the first call that needs a library builds
it, and ``build_all()`` builds every source at once, one ``nvcc`` each,
in parallel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD = Path(__file__).parent / "build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_LOADED: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _target(src: Path) -> Path:
    """The library of ``src``, named by a hash of the source, the shared
    headers in ``csrc/`` and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [src, *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.read_bytes())
    digest = h.hexdigest()
    return BUILD / f"lib{src.stem}-{digest[:16]}.so"


def _start(src: Path) -> tuple[Path, Path, subprocess.Popen] | None:
    """Start nvcc for ``src`` unless its library is already built."""
    out = _target(src)
    if out.exists():
        return None
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.Popen(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    return out, tmp, proc


def _finish(started) -> None:
    out, tmp, proc = started
    _, err = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {out.name} "
                           f"(exit {proc.returncode}):\n{err}")
    os.replace(tmp, out)


def build_all() -> list[Path]:
    """Build every ``csrc/*.cu`` not yet built, all nvcc runs at once;
    returns the libraries' paths."""
    sources = sorted(CSRC.glob("*.cu"))
    started = [s for s in (_start(src) for src in sources) if s]
    try:
        for s in started:
            _finish(s)
    finally:
        for _, tmp, proc in started:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    return [_target(src) for src in sources]


def library(stem: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu``, built on first use."""
    with _LOCK:
        lib = _LOADED.get(stem)
        if lib is None:
            src = CSRC / f"{stem}.cu"
            started = _start(src)
            if started:
                _finish(started)
            lib = ctypes.CDLL(str(_target(src)))
            _LOADED[stem] = lib
        return lib
