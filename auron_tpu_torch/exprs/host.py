"""Host functions over device columns: one readback, one upload.

The reference runs its string parses, casts to and from strings, the
general ``LIKE`` regex, ``split(...)[i]`` and timestamp parsing as
``jax.pure_callback`` inside its programs. The port runs the same
Python on the host, eagerly: ``host_map`` packs the batch's row count
and every input tensor into one byte buffer and copies it to the host
once (``ops.base.host_copy``, counted in ``host_readback.syncs``), runs
the function over the live rows, then packs every output into one
staging buffer (pinned when it feeds a CUDA copy) and uploads it with
one copy. Rows past the row count come back zero. Nothing is read row
by row from the device.
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from auron_tpu_torch.ops.base import host_copy


def _align(n: int) -> int:
    return (n + 7) // 8 * 8


def _pack(tensors: Sequence[torch.Tensor]):
    """One uint8 tensor holding every tensor's bytes at an 8-byte aligned
    offset, and each part's (offset, dtype, shape)."""
    parts, layout, off = [], [], 0
    for t in tensors:
        t = t.contiguous()
        nbytes = t.numel() * t.element_size()
        flat = t.reshape(-1).view(torch.uint8)
        pad = _align(nbytes) - nbytes
        parts.append(flat)
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8,
                                     device=t.device))
        layout.append((off, t.dtype, tuple(t.shape)))
        off += _align(nbytes)
    return torch.cat(parts), layout


def np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


def host_map(fn: Callable, inputs: Sequence[torch.Tensor],
             num_rows: torch.Tensor, outputs: Sequence[tuple],
             device: torch.device) -> list[torch.Tensor]:
    """``fn(n, *host_inputs)`` on the host over one batch.

    ``inputs`` are device tensors of ``cap`` rows; ``fn`` receives them as
    numpy arrays (all ``cap`` rows) with ``n``, the live row count, and
    returns one numpy array per entry of ``outputs``, each ``(numpy
    dtype, trailing shape)``, of ``cap`` rows. The results come back as
    tensors on ``device``."""
    cap = inputs[0].shape[0]
    buf, layout = _pack([num_rows.reshape(1).to(torch.int64), *inputs])
    host = host_copy(buf).numpy()
    arrays = []
    for off, dtype, shape in layout:
        nd = np_dtype(dtype)
        nbytes = int(np.prod(shape, dtype=np.int64)) * nd.itemsize
        arrays.append(host[off:off + nbytes].view(nd).reshape(shape))
    n = int(arrays[0][0])
    results = fn(n, *arrays[1:])
    specs = [(np.dtype(dt), tuple(tail)) for dt, tail in outputs]
    sizes = [_align(cap * int(np.prod(tail, dtype=np.int64)) * dt.itemsize)
             for dt, tail in specs]
    staging = torch.zeros(sum(sizes), dtype=torch.uint8,
                          pin_memory=device.type == "cuda")
    flat = staging.numpy()
    off = 0
    for (dt, tail), size, r in zip(specs, sizes, results):
        a = np.ascontiguousarray(r, dtype=dt).reshape((cap,) + tail)
        flat[off:off + a.nbytes] = a.reshape(-1).view(np.uint8)
        off += size
    dev = staging if device.type == "cpu" else \
        staging.to(device, non_blocking=True)
    out, off = [], 0
    for (dt, tail), size in zip(specs, sizes):
        tdt = torch.from_numpy(np.empty(0, dt)).dtype
        nbytes = cap * int(np.prod(tail, dtype=np.int64)) * dt.itemsize
        out.append(dev[off:off + nbytes].view(tdt).reshape((cap,) + tail))
        off += size
    return out


def decode(chars: np.ndarray, lens: np.ndarray, i: int) -> str:
    """Row ``i`` of a fetched string column as text (invalid UTF-8
    replaced, as the reference's callbacks decode)."""
    return bytes(chars[i, :lens[i]]).decode("utf-8", "replace")
