"""Pairwise distances — the dense metrics of the reference.

Counterpart of ``raft_tpu/distance/pairwise.py``. The expanded metrics
(L2, cosine, correlation, inner product, hellinger, russelrao, jaccard,
dice) are one f32 matmul plus an elementwise epilogue; the unexpanded ones
(L1, Linf, Canberra, Lp, ...) reduce over the feature axis in row blocks
(``_block_distance``) so the broadcast intermediate stays bounded. Both are
XLA in the reference, so both are plain PyTorch here. Epilogues follow the
reference formulas exactly.
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.utils.precision import dist_dot

# metrics computable as matmul + epilogue
_EXPANDED = {
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.CosineExpanded,
    DistanceType.InnerProduct,
    DistanceType.CorrelationExpanded,
    DistanceType.HellingerExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.JaccardExpanded,
    DistanceType.DiceExpanded,
}

# elements of the [tm, tn, d] broadcast intermediate per block (~32 MiB f32)
_BLOCK_ELEMS = (32 * 1024 * 1024) // 4


def pairwise_distance(x, y, metric="euclidean", metric_arg: float = 2.0,
                      tile_m: Optional[int] = None,
                      tile_n: Optional[int] = None,
                      device=None) -> torch.Tensor:
    """The full [m, n] distance matrix between rows of x and y (f32).
    ``tile_m`` / ``tile_n`` are accepted for the reference's signature;
    the row blocks size themselves (``_BLOCK_ELEMS``)."""
    metric = resolve_metric(metric)
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    y = as_tensor(y, dev)
    if x.dim() != 2 or y.dim() != 2 or x.shape[1] != y.shape[1]:
        raise ValueError(f"bad shapes {tuple(x.shape)} vs {tuple(y.shape)}")
    if metric == DistanceType.Precomputed:
        raise ValueError("Precomputed is not a computable metric")
    if metric == DistanceType.Haversine and x.shape[1] != 2:
        raise ValueError("haversine requires d=2 (lat, lon in radians)")
    x = x.float()
    y = y.float()
    if metric in _EXPANDED:
        return _expanded_path(x, y, metric)
    return _elementwise_path(x, y, metric, float(metric_arg))


def _expanded_path(x: torch.Tensor, y: torch.Tensor,
                   metric: DistanceType) -> torch.Tensor:
    d = x.shape[1]
    tiny = torch.finfo(x.dtype).tiny
    if metric == DistanceType.HellingerExpanded:
        x = torch.sqrt(x)
        y = torch.sqrt(y)
    dot = dist_dot(x, y.T)
    if metric == DistanceType.InnerProduct:
        return dot
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        xn = (x * x).sum(1)
        yn = (y * y).sum(1)
        d2 = torch.clamp_min(xn[:, None] + yn[None, :] - 2.0 * dot, 0.0)
        return torch.sqrt(d2) if metric == DistanceType.L2SqrtExpanded else d2
    if metric == DistanceType.CosineExpanded:
        xn = torch.sqrt((x * x).sum(1))
        yn = torch.sqrt((y * y).sum(1))
        return 1.0 - dot / torch.clamp_min(xn[:, None] * yn[None, :], tiny)
    if metric == DistanceType.CorrelationExpanded:
        xm = x.mean(1, keepdim=True)
        ym = y.mean(1, keepdim=True)
        xc_n = torch.sqrt(((x - xm) ** 2).sum(1))
        yc_n = torch.sqrt(((y - ym) ** 2).sum(1))
        num = dot - d * xm[:, 0][:, None] * ym[:, 0][None, :]
        return 1.0 - num / torch.clamp_min(xc_n[:, None] * yc_n[None, :],
                                           tiny)
    if metric == DistanceType.HellingerExpanded:
        return torch.sqrt(torch.clamp_min(1.0 - dot, 0.0))
    if metric == DistanceType.RusselRaoExpanded:
        return (d - dot) / d
    if metric == DistanceType.JaccardExpanded:
        union = x.sum(1)[:, None] + y.sum(1)[None, :] - dot
        return 1.0 - dot / torch.where(union == 0, 1.0, union)
    if metric == DistanceType.DiceExpanded:
        denom = x.sum(1)[:, None] + y.sum(1)[None, :]
        return 1.0 - 2.0 * dot / torch.where(denom == 0, 1.0, denom)
    raise ValueError(f"{metric!r} is not an expanded metric")


def _safe_log(v: torch.Tensor) -> torch.Tensor:
    return torch.where(v == 0, 0.0, torch.log(torch.where(v == 0, 1.0, v)))


def _block_distance(xb: torch.Tensor, yb: torch.Tensor,
                    metric: DistanceType, p: float) -> torch.Tensor:
    """Distance between row blocks: xb [tm, d], yb [tn, d] -> [tm, tn]."""
    d = xb.shape[-1]
    xi = xb[:, None, :]
    yi = yb[None, :, :]
    if metric == DistanceType.L1:
        return (xi - yi).abs().sum(-1)
    if metric in (DistanceType.L2Unexpanded, DistanceType.L2SqrtUnexpanded):
        acc = ((xi - yi) ** 2).sum(-1)
        return (torch.sqrt(acc) if metric == DistanceType.L2SqrtUnexpanded
                else acc)
    if metric == DistanceType.Linf:
        return (xi - yi).abs().amax(-1)
    if metric == DistanceType.Canberra:
        diff = (xi - yi).abs()
        add = xi.abs() + yi.abs()
        return torch.where(add == 0, 0.0,
                           diff / torch.where(add == 0, 1.0, add)).sum(-1)
    if metric == DistanceType.LpUnexpanded:
        return ((xi - yi).abs() ** p).sum(-1) ** (1.0 / p)
    if metric == DistanceType.BrayCurtis:
        num = (xi - yi).abs().sum(-1)
        den = (xi + yi).abs().sum(-1)
        return torch.where(den == 0, 0.0, num / torch.where(den == 0, 1.0, den))
    if metric == DistanceType.JensenShannon:
        m = 0.5 * (xi + yi)
        logm = _safe_log(m)
        acc = (xi * (_safe_log(xi) - logm) + yi * (_safe_log(yi) - logm)).sum(-1)
        return torch.sqrt(torch.clamp_min(0.5 * acc, 0.0))
    if metric == DistanceType.HammingUnexpanded:
        return (xi != yi).to(xb.dtype).sum(-1) / d
    if metric == DistanceType.KLDivergence:
        return 0.5 * (xi * (_safe_log(xi) - _safe_log(yi))).sum(-1)
    if metric == DistanceType.Haversine:
        lat1, lon1 = xi[..., 0], xi[..., 1]
        lat2, lon2 = yi[..., 0], yi[..., 1]
        sdlat = torch.sin(0.5 * (lat1 - lat2))
        sdlon = torch.sin(0.5 * (lon1 - lon2))
        a = sdlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sdlon ** 2
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(a, 0.0, 1.0)))
    raise ValueError(f"{metric!r} has no elementwise form")


def _elementwise_path(x: torch.Tensor, y: torch.Tensor,
                      metric: DistanceType, p: float) -> torch.Tensor:
    """Row blocks of x against all of y, each block's broadcast
    intermediate bounded by ``_BLOCK_ELEMS``."""
    n, d = y.shape
    tm = max(1, _BLOCK_ELEMS // max(n * d, 1))
    return torch.cat([_block_distance(x[i:i + tm], y, metric, p)
                      for i in range(0, x.shape[0], tm)])
