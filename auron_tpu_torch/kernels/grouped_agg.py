"""Grouped aggregation over a bounded key domain — the dense kernels.

The port of ``auron_tpu.kernels.grouped_agg``:

``cuda_sum_count``
    The hand-written CUDA kernel (``csrc/grouped_agg.cu``) that replaces
    the Pallas VMEM-accumulate kernel: one pass over the ~12 B/row
    inputs in 16-byte loads; equal keys are combined within a thread and
    across the warp, and each remaining (sum, count) goes in with one
    8-byte vector atomic, into an interleaved (key_domain, 2)
    accumulator that stays in L2, or, for small domains, into a block's
    private copy in shared memory first. ``_plan`` picks the path and the
    grid from the card's SM count and occupancy. On a CPU tensor the
    wrapper runs ``sum_count_reference``, its plain version; on a CUDA
    tensor it launches the kernel or raises.

``dense_matmul_sum_count``
    The one-hot matmul formulation, in full f32, tiled over row blocks.

``scatter_reduce``
    Exact dense-domain scatter (sum/count/min/max), for integer sums and
    the reductions a matmul cannot express.

Accuracy contract (the reference's): counts are exact below 2^24; sums
accumulate in f32 and are exact whenever inputs are integer-valued and
per-key totals stay below 2^24. Float sums are otherwise summed in
another order than the reference's, so they agree within f32 rounding of
the per-key sum of magnitudes.

Key contract: rows whose key lies outside [0, key_domain) contribute
nothing to ``cuda_sum_count``, ``sum_count_reference`` and
``dense_matmul_sum_count``; callers that want them counted clip first.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from auron_tpu_torch.utils.float_order import scatter_min_max

#: lane width of the reference's dense grids (keys decompose as
#: (k >> 8, k & 255)); kept so grid_dims and its errors match
_LANES = 256

#: the reference rounds the hi grid dimension up to the TPU's f32
#: sublane tile; kept so grid_dims returns the same shapes
_SUBLANES = 8

#: the hi/lo byte decomposition caps the supported domain
MAX_KEY_DOMAIN = _LANES * _LANES


def grid_dims(key_domain: int) -> tuple[int, int]:
    """(gh, gl) grid shape covering ``key_domain`` keys; raises
    ValueError outside (0, MAX_KEY_DOMAIN]."""
    if not 0 < key_domain <= MAX_KEY_DOMAIN:
        raise ValueError(
            f"key_domain {key_domain} outside (0, {MAX_KEY_DOMAIN}]")
    gh = -(-key_domain // _LANES)
    gh = -(-gh // _SUBLANES) * _SUBLANES
    return gh, _LANES


def _in_domain(k: torch.Tensor, key_domain: int) -> torch.Tensor:
    """int64 indices into a [key_domain + 1] accumulator: the key itself
    when it lies in [0, key_domain), else the spare last slot."""
    ok = (k >= 0) & (k < key_domain)
    return torch.where(ok, k, key_domain).to(torch.int64)


def sum_count_reference(k: torch.Tensor, v: torch.Tensor, c: torch.Tensor,
                        key_domain: int
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of ``cuda_sum_count``: ``index_add_``
    of the in-range rows."""
    idx = _in_domain(k, key_domain)
    out = []
    for x in (v, c):
        acc = torch.zeros(key_domain + 1, dtype=torch.float32,
                          device=k.device)
        out.append(acc.index_add_(0, idx, x)[:key_domain])
    return out[0], out[1]


def _validate(k, v, c, key_domain: int, blk: int) -> None:
    """The operand checks shared by the kernel and its plain version."""
    for name, t, dt in (("k", k, torch.int32), ("v", v, torch.float32),
                        ("c", c, torch.float32)):
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if t.dim() != 1:
            raise ValueError(f"{name} must be 1-D, got shape "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != k.device:
            raise ValueError(f"{name} is on {t.device}, k on {k.device}")
        if t.shape[0] != k.shape[0]:
            raise ValueError(f"{name} has {t.shape[0]} rows, k has "
                             f"{k.shape[0]}")
    n = k.shape[0]
    if n and n % min(blk, n):
        raise ValueError(f"rows {n} not a multiple of block {min(blk, n)}")
    grid_dims(key_domain)


#: rows a thread loads per pass (one int4 and two float4)
_ROWS_PER_THREAD = 4
#: launch paths: rows go straight to the global accumulators, or through
#: a block's private copy in shared memory
PATH_GLOBAL, PATH_SHARED = 0, 1
#: ``_launch``'s kernels: the redesign, which ``cuda_sum_count`` runs, and
#: the first design's loop, reached only for chip_smoke.py's comparison
_VARIANTS = ("redesign", "pr1")


class DeviceProps(NamedTuple):
    """What ``_plan`` needs of a card, for one domain
    (``cuda_dense_sum_count_props`` in csrc/grouped_agg.cu)."""
    sms: int               # streaming multiprocessors
    smem_optin: int        # dynamic shared memory a block may opt in to, B
    global_occupancy: int  # resident blocks per SM, global path
    shared_occupancy: int  # resident blocks per SM, shared path (0: no fit)
    threads: int           # threads per block, global path
    shared_threads: int    # threads per block, shared path


def _blocks(n: int, threads: int, resident: int) -> int:
    """Blocks that fill the card (``resident``) without one that has no
    4-row vector for each of its threads; never 0."""
    busy = -(-n // (threads * _ROWS_PER_THREAD))
    return max(1, min(resident, busy))


def _plan(n: int, key_domain: int, props: DeviceProps,
          path: int | None = None) -> tuple[int, int, int]:
    """(path, blocks, smem_bytes) of a launch over ``n`` rows.

    The shared-memory path keeps one float2 per key in each block, so it
    needs 8 * key_domain bytes to fit, and rows enough that each block
    sees a row per key, so that a block's flush of up to key_domain
    atomics stays small beside its rows; otherwise rows go straight to
    the global accumulators. ``path`` forces one of the two. Blocks fill
    the card: SMs x resident blocks per SM."""
    smem = 8 * key_domain
    fits = props.shared_occupancy > 0 and smem <= props.smem_optin
    shared_blocks = _blocks(n, props.shared_threads,
                            props.sms * props.shared_occupancy)
    if path is None:
        path = PATH_SHARED if fits and n >= key_domain * shared_blocks \
            else PATH_GLOBAL
    if path == PATH_SHARED:
        if not fits:
            raise ValueError(f"key_domain {key_domain} needs {smem} B of "
                             f"shared memory; a block may have "
                             f"{props.smem_optin} B")
        return PATH_SHARED, shared_blocks, smem
    if path != PATH_GLOBAL:
        raise ValueError(f"unknown path {path}")
    return PATH_GLOBAL, _blocks(n, props.threads,
                                props.sms * props.global_occupancy), 0


@functools.cache
def _kernel():
    """The built kernel's C entry points, typed for ctypes: (launch,
    launch of the first design, props)."""
    from auron_tpu_torch.kernels import _build

    lib = _build.library("grouped_agg")
    operands = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_void_p]
    launch = lib.cuda_dense_sum_count
    launch.argtypes = operands + [ctypes.c_int, ctypes.c_int,
                                  ctypes.c_void_p]
    pr1 = lib.cuda_dense_sum_count_pr1
    pr1.argtypes = operands + [ctypes.c_void_p]
    props = lib.cuda_dense_sum_count_props
    props.argtypes = [ctypes.c_int, ctypes.c_int,
                      ctypes.POINTER(ctypes.c_int)]
    for fn in (launch, pr1, props):
        fn.restype = ctypes.c_int
    return launch, pr1, props


@functools.cache
def _device_props(index: int, smem_bytes: int) -> DeviceProps:
    """The card's launch inputs, read once per (device, domain)."""
    out = (ctypes.c_int * len(DeviceProps._fields))()
    err = _kernel()[2](index, smem_bytes, out)
    if err != 0:
        raise RuntimeError(f"cuda_dense_sum_count_props failed: CUDA "
                           f"error {err}")
    return DeviceProps(*out)


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, n: int, key_domain: int,
                 path: int | None) -> tuple[int, int, int]:
    return _plan(n, key_domain, _device_props(index, 8 * key_domain), path)


def _launch(k, v, c, key_domain: int, variant: str = "redesign",
            path: int | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Zero a (key_domain, 2) accumulator and launch ``variant`` on it on
    the current stream; returns (sums, counts) views of it. Operands are
    checked by the caller; ``variant`` and ``path`` other than the
    defaults serve chip_smoke.py's comparisons only."""
    if variant not in _VARIANTS:
        raise ValueError(f"unknown variant {variant!r}")
    index = k.get_device()
    n = k.shape[0]
    acc = torch.empty((key_domain, 2), dtype=torch.float32, device=k.device)
    # the raw handle of torch.cuda.current_stream(index), without the
    # Stream object around it
    stream = torch._C._cuda_getCurrentRawStream(index)
    operands = (index, k.data_ptr(), v.data_ptr(), c.data_ptr(), n,
                key_domain, acc.data_ptr())
    if variant == "pr1":
        err = _kernel()[1](*operands, stream)
    else:
        _, blocks, smem = _device_plan(index, n, key_domain, path)
        err = _kernel()[0](*operands, blocks, smem, stream)
    if err != 0:
        raise RuntimeError(f"cuda_dense_sum_count launch failed: CUDA "
                           f"error {err}")
    if variant == "pr1":
        return acc.view(2, key_domain).unbind(0)
    return acc.unbind(1)


def cuda_sum_count(k: torch.Tensor, v: torch.Tensor, c: torch.Tensor,
                   key_domain: int, blk: int = 2048
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense grouped (sum, count) over ``key_domain`` keys.

    k: int32[n]; v: f32[n] with nulls zeroed; c: f32[n] 0/1 valid mask.
    n must be a multiple of ``min(blk, n)`` (the reference's block
    contract). Returns (sums f32[key_domain], counts f32[key_domain]).
    On a CUDA tensor this launches ``csrc/grouped_agg.cu`` on the
    current stream without synchronising and adds one to
    ``cuda_sum_count.launches``; the two results are then strided views
    (stride 2) of one interleaved (key_domain, 2) accumulator. On a CPU
    tensor it runs ``sum_count_reference``.
    """
    _validate(k, v, c, key_domain, blk)
    if not k.is_cuda:
        if k.device.type == "cpu":
            return sum_count_reference(k, v, c, key_domain)
        raise ValueError(f"cuda_sum_count runs on cuda or cpu tensors, "
                         f"got {k.device}")
    if k.shape[0] == 0:
        return k.new_zeros((key_domain, 2), dtype=torch.float32).unbind(1)
    out = _launch(k, v, c, key_domain)
    cuda_sum_count.launches += 1
    return out


cuda_sum_count.launches = 0


def dense_matmul_sum_count(k: torch.Tensor, v: torch.Tensor,
                           c: torch.Tensor, key_domain: int,
                           block: int = 1 << 16
                           ) -> tuple[torch.Tensor, torch.Tensor]:
    """Same contract as ``cuda_sum_count`` via one-hot matmuls: per row
    block, [hi one-hot * v | hi one-hot * c]^T @ lo one-hot gives the
    [gh, 256] sum and count grids. The reference splits v into three
    bf16-exact terms for the TPU's bf16 matrix unit; here the product
    runs in full f32, which holds only while TF32 is off."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dense_matmul_sum_count needs full-f32 matmuls; "
                           "torch.backends.cuda.matmul.allow_tf32 is on")
    n = k.shape[0]
    block = min(block, n)
    if n and n % block:
        raise ValueError(f"rows {n} not a multiple of block {block}")
    gh, gl = grid_dims(key_domain)
    dev = k.device
    iota_h = torch.arange(gh, dtype=torch.int32, device=dev)
    iota_l = torch.arange(gl, dtype=torch.int32, device=dev)
    sums = torch.zeros(gh, gl, dtype=torch.float32, device=dev)
    cnts = torch.zeros(gh, gl, dtype=torch.float32, device=dev)
    for s in range(0, n, block):
        kk = k[s:s + block, None]
        # comparisons, not F.one_hot: keys outside the grid match nothing
        hi = ((kk >> 8) == iota_h).to(torch.float32)
        lo = ((kk & 255) == iota_l).to(torch.float32)
        lhs = torch.cat([hi * v[s:s + block, None],
                         hi * c[s:s + block, None]], dim=1)
        out = lhs.T @ lo
        sums += out[:gh]
        cnts += out[gh:]
    return sums.reshape(-1)[:key_domain], cnts.reshape(-1)[:key_domain]


def sum_count(k, v, c, key_domain: int, backend: str = "dense_matmul",
              interpret: bool = False, blk: int = 2048):
    """Backend-dispatched dense grouped (sum, count) — the single entry
    the flagship stage calls with a ``kernels.dispatch`` decision.
    ``interpret`` runs the CUDA kernel's plain version instead, as the
    dispatch policy asks off CUDA."""
    if backend == "cuda_dense":
        if interpret:
            _validate(k, v, c, key_domain, blk)
            return sum_count_reference(k, v, c, key_domain)
        return cuda_sum_count(k, v, c, key_domain, blk=blk)
    if backend == "dense_matmul":
        return dense_matmul_sum_count(k, v, c, key_domain)
    raise ValueError(f"unknown dense grouped-agg backend {backend!r}")


def scatter_reduce(kind: str, k: torch.Tensor, v, valid: torch.Tensor,
                   key_domain: int, dtype: torch.dtype) -> torch.Tensor:
    """Exact dense reduction by scatter. Invalid rows contribute the
    reduction's neutral; the caller masks group existence separately.

    Index rule of the reference's ``.at[k]`` with ``mode="drop"``: a key
    in [-key_domain, 0) counts from the end (k + key_domain), and any
    other key outside [0, key_domain) is dropped."""
    k = torch.where(k < 0, k + key_domain, k)
    idx = _in_domain(k, key_domain)
    if kind == "sum":
        vals = torch.where(valid, v.to(dtype), 0)
        acc = torch.zeros(key_domain + 1, dtype=dtype, device=k.device)
        return acc.index_add_(0, idx, vals)[:key_domain]
    if kind == "count":
        acc = torch.zeros(key_domain + 1, dtype=torch.int64, device=k.device)
        return acc.index_add_(0, idx, valid.to(torch.int64))[:key_domain]
    if kind in ("min", "max"):
        if dtype.is_floating_point:
            neutral = float("inf") if kind == "min" else float("-inf")
        else:
            info = torch.iinfo(dtype)
            neutral = info.max if kind == "min" else info.min
        vals = torch.where(valid, v.to(dtype),
                           torch.tensor(neutral, dtype=dtype,
                                        device=k.device))
        acc = torch.full((key_domain + 1,), neutral, dtype=dtype,
                         device=k.device)
        return scatter_min_max(acc, idx, vals, kind)[:key_domain]
    raise ValueError(f"unknown scatter reduction {kind!r}")
