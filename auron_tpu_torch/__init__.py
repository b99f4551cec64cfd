"""PyTorch/CUDA port of the auron-tpu query engine for NVIDIA Hopper.

The package mirrors ``auron_tpu``'s layout (``config``, ``columnar``,
``exprs``, ``kernels``, ``ops``, and ``entry`` for ``__graft_entry__``)
but imports only ``torch`` and ``numpy``: the JAX package is the
reference it is tested against, never a dependency.

Entry points run on the card. A caller who wants the CPU says so with
``device="cpu"`` (the tests do); without CUDA and without an explicit
device they raise instead of quietly running on the host.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    names another. Raises when CUDA was implied and is not available."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "auron_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)
