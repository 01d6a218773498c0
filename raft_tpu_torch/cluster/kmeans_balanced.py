"""Hierarchical balanced k-means — the IVF coarse-quantizer trainer.

Counterpart of ``raft_tpu/cluster/kmeans_balanced.py``: fit sqrt(C)
mesoclusters on a subsample, split the C fine clusters among them by size,
initialise each mesocluster's share from a fixed-size subsample, then run
balancing EM over the whole trainset with starved-cluster adjustment. The
reference is XLA throughout (matmul + argmin predict, one-hot-matmul
update), so this module is plain PyTorch: predict is an f32 matmul plus
argmin, and the update is an ``index_add_`` of rows into their cluster
sums. ``torch.Generator`` takes the place of ``jax.random`` keys, so the
centers differ from the reference's bit for bit but not in quality.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans import _centers_and_sizes, _row_batches
from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import DistanceType
from raft_tpu_torch.utils.precision import dist_dot, round_bf16


@dataclasses.dataclass
class KMeansBalancedParams:
    """``compute_dtype``: "f32" runs the predict/update products in full
    f32; "bf16" rounds their operands to bf16 (f32 accumulation)."""

    n_clusters: int = 8
    n_iters: int = 20
    metric: DistanceType = DistanceType.L2Expanded
    seed: int = 0
    compute_dtype: str = "f32"


# reference constants (detail/kmeans_balanced.cuh)
_ADJUST_CENTERS_WEIGHT = 7.0   # kAdjustCentersWeight
_BALANCING_THRESHOLD = 0.25    # build_clusters default

_BATCH_ROWS = 1 << 16


def _ip_like(metric: int) -> bool:
    return int(metric) in (int(DistanceType.InnerProduct),
                           int(DistanceType.CosineExpanded))


def _operand(x: torch.Tensor, compute_dtype: str) -> torch.Tensor:
    x = x.float()
    return round_bf16(x) if compute_dtype == "bf16" else x


def _normalize_rows(c: torch.Tensor) -> torch.Tensor:
    return c / torch.clamp_min(torch.linalg.norm(c, dim=1, keepdim=True),
                               1e-30)


def _predict_metric(x: torch.Tensor, centers: torch.Tensor, metric: int,
                    batch_rows: int = _BATCH_ROWS,
                    compute_dtype: str = "bf16") -> torch.Tensor:
    """Nearest-center labels [n] int32 under L2, inner product or cosine.
    L2 drops the per-row ||x||^2 term (it never changes the argmin):
    ``argmin(||c||^2 - 2 x.c)``; IP and cosine take the max dot against
    (normalised, for cosine) centers."""
    c32 = centers.float()
    if int(metric) == int(DistanceType.CosineExpanded):
        c32 = _normalize_rows(c32)
    cT = _operand(c32, compute_dtype).T
    ip_like = _ip_like(metric)
    cn2 = None if ip_like else (c32 * c32).sum(1)
    out = []
    for batch in _row_batches(x, batch_rows):
        dots = dist_dot(_operand(batch, compute_dtype), cT)
        if ip_like:
            out.append(dots.argmax(dim=1))
        else:
            out.append((cn2[None, :] - 2.0 * dots).argmin(dim=1))
    return torch.cat(out).to(torch.int32)


def _update_centers(x: torch.Tensor, labels: torch.Tensor, n_clusters: int,
                    batch_rows: int, compute_dtype: str = "bf16"):
    """Per-cluster sums and sizes of the (operand-rounded) rows."""
    return _centers_and_sizes(_operand(x, compute_dtype), labels, None,
                              n_clusters, batch_rows)


def _adjust_centers(x: torch.Tensor, labels: torch.Tensor,
                    sizes: torch.Tensor, centers: torch.Tensor,
                    gen: torch.Generator, n_clusters: int):
    """Every starved cluster (size <= threshold x average) moves to a
    weighted blend of a large cluster's center and one of its points; the
    point is the best of 4 uniform row samples by cluster size."""
    n = x.shape[0]
    average = float(n) / float(n_clusters)
    starved = sizes <= _BALANCING_THRESHOLD * average
    cand = torch.randint(0, n, (n_clusters, 4), generator=gen,
                         device=x.device)
    cand_sizes = sizes[labels.long()[cand]]
    pick = cand_sizes.argmax(dim=1)
    i = cand.gather(1, pick[:, None])[:, 0]
    li = labels.long()[i]
    wc = torch.clamp_max(sizes, _ADJUST_CENTERS_WEIGHT)[:, None]
    blend = (wc * centers[li] + x[i].float()) / (wc + 1.0)
    centers = torch.where(starved[:, None], blend, centers)
    return centers, starved.sum()


def _em_loop(x: torch.Tensor, centers: torch.Tensor, gen: torch.Generator,
             n_iters: int, n_clusters: int, metric: int, compute_dtype: str):
    """A seed predict + update, then ``n_iters`` rounds of adjust,
    normalise (IP/cosine), predict, update."""
    br = min(x.shape[0], _BATCH_ROWS)
    ip_like = _ip_like(metric)

    def normalize(c):
        return _normalize_rows(c) if ip_like else c

    def em_update(c):
        labels = _predict_metric(x, c, metric, br, compute_dtype)
        sums, sizes = _update_centers(x, labels, n_clusters, br,
                                      compute_dtype)
        c = torch.where(sizes[:, None] > 0,
                        sums / torch.clamp_min(sizes, 1.0)[:, None], c)
        return c, labels, sizes

    centers, labels, sizes = em_update(normalize(centers))
    for _ in range(n_iters):
        centers, _ = _adjust_centers(x, labels, sizes, centers, gen,
                                     n_clusters)
        centers, labels, sizes = em_update(normalize(centers))
    return centers, labels, sizes


def balancing_em_iters(x, centers, n_iters: int, n_clusters: int,
                       gen: torch.Generator,
                       metric: DistanceType = DistanceType.L2Expanded,
                       compute_dtype: str = "bf16"):
    """The balancing EM loop at a fixed ``n_iters + n_iters//2`` rounds
    (the reference's budget; the extra half plays the pullback's role).
    Returns (centers [C, d] f32, sizes [C] f32)."""
    rounds = max(int(n_iters) + int(n_iters) // 2, 1)
    centers, _, sizes = _em_loop(x, centers.float(), gen, rounds,
                                 int(n_clusters), int(metric), compute_dtype)
    return centers, sizes


def build_clusters(x: torch.Tensor, n_clusters: int, n_iters: int,
                   gen: torch.Generator,
                   metric: DistanceType = DistanceType.L2Expanded,
                   init_centers=None, compute_dtype: str = "bf16"):
    """EM-balanced clustering of one dataset. Returns (centers, sizes)."""
    n = x.shape[0]
    if init_centers is None:
        if n < n_clusters:
            idx = torch.randint(0, n, (n_clusters,), generator=gen,
                                device=x.device)
        else:
            idx = torch.randperm(n, generator=gen,
                                 device=x.device)[:n_clusters]
        centers = x[idx].float()
    else:
        centers = init_centers.float()
    return balancing_em_iters(x, centers, n_iters, n_clusters, gen, metric,
                              compute_dtype)


def _arrange_fine_clusters(n_clusters: int, n_mesoclusters: int,
                           meso_sizes: np.ndarray) -> np.ndarray:
    """Split C fine clusters among mesoclusters in proportion to size;
    every nonempty mesocluster gets >= 1 and the counts sum to C."""
    meso_sizes = meso_sizes.astype(np.float64)
    counts = np.zeros(n_mesoclusters, np.int64)
    remaining_c, remaining_n = n_clusters, max(meso_sizes.sum(), 1.0)
    order = np.argsort(-meso_sizes)  # largest first, like the reference
    for i in order:
        if remaining_c <= 0:
            break
        c = int(round(remaining_c * meso_sizes[i] / max(remaining_n, 1.0)))
        c = max(1 if meso_sizes[i] > 0 else 0, min(c, remaining_c))
        counts[i] = c
        remaining_c -= c
        remaining_n -= meso_sizes[i]
    if remaining_c > 0:
        counts[order[0]] += remaining_c
    return counts


def build_clusters_batched(xs: torch.Tensor, n_clusters: int, n_iters: int,
                           gen: torch.Generator,
                           metric: int = int(DistanceType.L2Expanded)):
    """Train B independent codebooks at once: ``xs`` [B, n, d] -> centers
    [B, K, d]. Each book runs ``n_iters`` Lloyd iterations, reseeding empty
    clusters from random rows; IP/cosine assign by max dot against
    normalised centers."""
    B, n, d = xs.shape
    xs = xs.float()
    ip_like = _ip_like(metric)
    dev = xs.device
    book = torch.arange(B, device=dev)[:, None]
    idx = torch.randint(0, n, (B, n_clusters), generator=gen, device=dev)
    centers = xs[book, idx]
    for _ in range(n_iters):
        if ip_like:
            centers = centers / torch.clamp_min(
                torch.linalg.norm(centers, dim=2, keepdim=True), 1e-30)
        dots = torch.bmm(xs, centers.transpose(1, 2))           # [B, n, K]
        if ip_like:
            labels = dots.argmax(dim=2)
        else:
            cn2 = (centers * centers).sum(2)
            labels = (cn2[:, None, :] - 2.0 * dots).argmin(dim=2)
        flat = (labels + book * n_clusters).reshape(-1)
        sums = torch.zeros((B * n_clusters, d), device=dev)
        sums.index_add_(0, flat, xs.reshape(-1, d))
        sizes = torch.bincount(flat, minlength=B * n_clusters).float()
        sums = sums.reshape(B, n_clusters, d)
        sizes = sizes.reshape(B, n_clusters)
        reseed = xs[book, torch.randint(0, n, (B, n_clusters), generator=gen,
                                        device=dev)]
        centers = torch.where(sizes[..., None] > 0,
                              sums / torch.clamp_min(sizes, 1.0)[..., None],
                              reseed)
    return centers


def build_hierarchical(x: torch.Tensor, n_clusters: int, n_iters: int = 20,
                       metric: DistanceType = DistanceType.L2Expanded,
                       seed: int = 0, compute_dtype: str = "bf16"):
    """Two-level balanced training. The hierarchy only initialises the
    centers — the meso fit and per-meso fine fits run on fixed-size
    subsamples — and the real work is the full-trainset balancing EM.
    Returns centers [C, d] f32 on x's device."""
    x = x.float()
    n, d = x.shape
    dev = x.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    rng = np.random.default_rng(seed)

    n_meso = int(math.ceil(math.sqrt(n_clusters)))
    if n_clusters <= n_meso or n <= 4 * n_clusters:
        centers, _ = build_clusters(x, n_clusters, n_iters, gen, metric,
                                    compute_dtype=compute_dtype)
        return centers

    # meso pass on a bounded subsample
    meso_sample = min(n, max(64 * n_meso, 1 << 14))
    sel = rng.choice(n, meso_sample, replace=False)
    x_meso = x[torch.from_numpy(sel).to(dev)]
    meso_centers, _ = build_clusters(x_meso, n_meso, max(n_iters // 2, 4),
                                     gen, metric,
                                     compute_dtype=compute_dtype)
    meso_labels = _predict_metric(
        x_meso, meso_centers, int(metric), min(meso_sample, _BATCH_ROWS),
        compute_dtype).cpu().numpy()
    meso_sizes = np.bincount(meso_labels, minlength=n_meso)
    fine_counts = _arrange_fine_clusters(n_clusters, n_meso, meso_sizes)

    # fine init: one fixed-size subsample per mesocluster, all fine fits
    # batched into one call
    c_max = int(fine_counts.max())
    S = max(32 * c_max, 256)
    active = [m for m in range(n_meso) if fine_counts[m] > 0]
    pick = np.empty((len(active), S), np.int64)
    for bi, m in enumerate(active):
        members = np.nonzero(meso_labels == m)[0]
        if members.size == 0:
            pick[bi] = rng.choice(n, S, replace=n < S)
        else:
            pick[bi] = sel[rng.choice(members, S, replace=members.size < S)]
    rows_all = x[torch.from_numpy(pick.reshape(-1)).to(dev)].reshape(
        len(active), S, d)
    books = build_clusters_batched(rows_all, c_max, 4, gen, int(metric))
    centers = torch.cat(
        [books[bi, :int(fine_counts[m])] for bi, m in enumerate(active)])
    if centers.shape[0] != n_clusters:
        raise RuntimeError(
            f"fine split gave {centers.shape[0]} centers, want {n_clusters}")

    # full-trainset balancing EM (the real training)
    centers, _ = balancing_em_iters(x, centers, max(n_iters // 2, 2),
                                    n_clusters, gen, metric, compute_dtype)
    return centers


def fit(params: KMeansBalancedParams, x, device=None) -> torch.Tensor:
    """Train balanced centers. Returns [C, d] f32 on ``device``."""
    x = as_tensor(x, resolve_device(device))
    return build_hierarchical(x, params.n_clusters, params.n_iters,
                              params.metric, params.seed,
                              params.compute_dtype)


def predict(params: KMeansBalancedParams, centers, x,
            device=None) -> torch.Tensor:
    """Nearest-center labels [n] int32."""
    dev = resolve_device(device)
    x = as_tensor(x, dev)
    return _predict_metric(x, as_tensor(centers, dev).float(),
                           int(params.metric), min(x.shape[0], _BATCH_ROWS),
                           params.compute_dtype)


def calc_centers_and_sizes(x, labels, n_clusters: int,
                           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-cluster means and sizes. Returns (centers, sizes)."""
    dev = resolve_device(device)
    x = as_tensor(x, dev).float()
    sums, sizes = _centers_and_sizes(x, as_tensor(labels, dev), None,
                                     int(n_clusters),
                                     min(x.shape[0], _BATCH_ROWS))
    return sums / torch.clamp_min(sizes, 1.0)[:, None], sizes
