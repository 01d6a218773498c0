"""Fused L2 distance + argmin 1-nearest-neighbour.

Counterpart of ``raft_tpu/distance/fused_l2_nn.py`` ``_fused_l2_nn`` :47,
the kmeans argmin. The reference is XLA (a tiled matmul plus an argmin
epilogue), so this is plain PyTorch: one f32 matmul per row tile of ``y``
with a running (min, argmin); ties go to the lower index.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.utils.precision import dist_dot

# rows x tile elements of one distance block (~256 MiB f32)
_TILE_ELEMS = (256 * 1024 * 1024) // 4


def fused_l2_nn_argmin(x, y, sqrt: bool = False,
                       tile_n: Optional[int] = None,
                       device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of x, the L2 distance and index of its nearest row of
    y: ``(min_dist [m] f32, argmin [m] int32)``."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    n = y.shape[0]
    if tile_n is None:
        tile_n = n if n * x.shape[0] <= _TILE_ELEMS else 4096
    return _fused_l2_nn(x, y, bool(sqrt), int(min(tile_n, n)))


def _fused_l2_nn(x: torch.Tensor, y: torch.Tensor, sqrt: bool, tile_n: int):
    x = x.float()
    y = y.float()
    m = x.shape[0]
    n = y.shape[0]
    xn = (x * x).sum(1)
    best_val = torch.full((m,), float("inf"), device=x.device)
    best_idx = torch.zeros((m,), dtype=torch.int32, device=x.device)
    for t0 in range(0, n, tile_n):
        yt = y[t0:t0 + tile_n]
        dot = dist_dot(x, yt.T)
        yn = (yt * yt).sum(1)
        d2 = torch.clamp_min(xn[:, None] + yn[None, :] - 2.0 * dot, 0.0)
        tile_idx = d2.argmin(dim=1)        # first minimum on ties
        tile_val = d2.gather(1, tile_idx[:, None])[:, 0]
        take = tile_val < best_val
        best_val = torch.where(take, tile_val, best_val)
        best_idx = torch.where(take, (tile_idx + t0).to(torch.int32),
                               best_idx)
    return (torch.sqrt(best_val) if sqrt else best_val), best_idx
