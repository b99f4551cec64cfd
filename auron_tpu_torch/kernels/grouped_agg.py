"""Grouped aggregation over a bounded key domain — the dense kernels.

The port of ``auron_tpu.kernels.grouped_agg``:

``cuda_sum_count``
    The hand-written CUDA kernel (``csrc/grouped_agg.cu``) that replaces
    the Pallas VMEM-accumulate kernel: one pass over the ~12 B/row
    inputs, float atomics into [key_domain] grids that stay in L2. On a
    CPU tensor the wrapper runs ``sum_count_reference``, its plain
    version; on a CUDA tensor it launches the kernel or raises.

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

import torch

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


@functools.cache
def _kernel():
    """The built kernel's C entry point, typed for ctypes."""
    from auron_tpu_torch.kernels import _build

    fn = _build.library("grouped_agg").cuda_dense_sum_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(k, v, c, key_domain, sums, counts) -> None:
    stream = torch.cuda.current_stream(k.device).cuda_stream
    err = _kernel()(k.data_ptr(), v.data_ptr(), c.data_ptr(), k.shape[0],
                    key_domain, sums.data_ptr(), counts.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"cuda_dense_sum_count launch failed: CUDA "
                           f"error {err}")


def cuda_sum_count(k: torch.Tensor, v: torch.Tensor, c: torch.Tensor,
                   key_domain: int, blk: int = 2048
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense grouped (sum, count) over ``key_domain`` keys.

    k: int32[n]; v: f32[n] with nulls zeroed; c: f32[n] 0/1 valid mask.
    n must be a multiple of ``min(blk, n)`` (the reference's block
    contract). Returns (sums f32[key_domain], counts f32[key_domain]).
    On a CUDA tensor this launches ``csrc/grouped_agg.cu`` on the
    current stream without synchronising and adds one to
    ``cuda_sum_count.launches``; on a CPU tensor it runs
    ``sum_count_reference``.
    """
    _validate(k, v, c, key_domain, blk)
    if k.device.type == "cpu":
        return sum_count_reference(k, v, c, key_domain)
    if k.device.type != "cuda":
        raise ValueError(f"cuda_sum_count runs on cuda or cpu tensors, "
                         f"got {k.device}")
    sums = torch.zeros(key_domain, dtype=torch.float32, device=k.device)
    counts = torch.zeros(key_domain, dtype=torch.float32, device=k.device)
    if k.shape[0] == 0:
        return sums, counts
    _launch(k, v, c, key_domain, sums, counts)
    cuda_sum_count.launches += 1
    return sums, counts


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
        return acc.scatter_reduce_(0, idx, vals, reduce="a" + kind,
                                   include_self=True)[:key_domain]
    raise ValueError(f"unknown scatter reduction {kind!r}")
