"""Device resolution shared by every public entry point of the port.

The reference package keeps a resources handle (``raft_tpu/core/
resources.py``); on PyTorch the device is the only resource an entry point
needs to be told about — streams are PyTorch's current stream.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` when given, else the
    first CUDA card. Raises when no card is present and none was asked for
    — the port never falls back to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "raft_tpu_torch runs on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions")
    return torch.device("cuda")


def as_tensor(x, device: torch.device, dtype=None) -> torch.Tensor:
    """``x`` (tensor or array-like) as a tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype or x.dtype)
    arr = np.ascontiguousarray(np.asarray(x))
    if not arr.flags.writeable:     # torch.from_numpy needs a writable array
        arr = arr.copy()
    t = torch.from_numpy(arr)
    return t.to(device=device, dtype=dtype or t.dtype)
