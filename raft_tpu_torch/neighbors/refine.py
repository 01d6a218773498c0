"""Exact re-ranking of ANN candidate lists.

Counterpart of ``raft_tpu/neighbors/refine.py`` (``refine`` :27,
``score_gathered`` :58, ``refine_host`` :103). Given candidate neighbour
ids per query, gather the candidates' rows, score them exactly with one
batched product (the expanded form for L2 and cosine), and keep the best
k. The reference has no Pallas kernel here (a gather, an einsum and
``select_k``), so plain PyTorch is the port. Negative candidate ids are
invalid: they score the metric's sentinel.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import DistanceType, is_min_close, \
    resolve_metric
from raft_tpu_torch.neighbors.common import merge_topk, sentinel_for


def refine(dataset, queries, candidates, k: int, metric="sqeuclidean",
           device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Re-rank ``candidates`` [m, n_cand] exactly on ``device`` (default:
    the CUDA card); returns (distances [m, k], ids [m, k] int32),
    best-first."""
    metric = resolve_metric(metric)
    dev = resolve_device(device)
    dataset = as_tensor(dataset, dev)
    queries = as_tensor(queries, dev)
    candidates = as_tensor(candidates, dev)
    if k > candidates.shape[1]:
        raise ValueError(f"k={k} > n_candidates={candidates.shape[1]}")
    compute = torch.promote_types(queries.dtype, torch.float32)
    q = queries.to(compute)
    safe = torch.where(candidates >= 0, candidates, 0).long()
    cand_vecs = dataset[safe].to(compute)                  # [m, c, d]
    return score_gathered(q, cand_vecs, candidates, int(k), metric)


def score_gathered(q: torch.Tensor, cand_vecs: torch.Tensor,
                   candidates: torch.Tensor, k: int, metric: DistanceType
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact scoring of gathered candidates: ``q`` [m, d] and
    ``cand_vecs`` [m, c, d] at the compute type, ``candidates`` [m, c]
    with < 0 marking invalid slots."""
    valid = candidates >= 0
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                  DistanceType.InnerProduct, DistanceType.CosineExpanded):
        dots = torch.bmm(cand_vecs, q[:, :, None])[:, :, 0]     # [m, c]
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        qn = (q * q).sum(1, keepdim=True)
        vn = (cand_vecs * cand_vecs).sum(2)
        d = torch.clamp_min(qn + vn - 2.0 * dots, 0.0)
        if metric == DistanceType.L2SqrtExpanded:
            d = torch.sqrt(d)
    elif metric == DistanceType.InnerProduct:
        d = dots
    elif metric == DistanceType.CosineExpanded:
        qn = torch.sqrt((q * q).sum(1, keepdim=True))
        vn = torch.sqrt((cand_vecs * cand_vecs).sum(2))
        d = 1.0 - dots / torch.clamp_min(qn * vn, torch.finfo(q.dtype).tiny)
    else:
        diff = q[:, None, :] - cand_vecs
        d = (diff.abs() if metric == DistanceType.L1 else diff * diff).sum(2)
    d = torch.where(valid, d, sentinel_for(metric))
    return merge_topk(d, candidates.to(torch.int32), k, is_min_close(metric))


def refine_host(dataset, queries, candidates, k: int, metric="sqeuclidean",
                n_threads: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Re-ranking over host data: :func:`refine` on CPU tensors (``dataset``
    may be a numpy array or memmap, read only at the candidates' rows).
    L2 and inner product, as the reference's; slots without a valid
    candidate come back with id -1. ``n_threads`` > 0 bounds torch's
    threads for the call."""
    metric = resolve_metric(metric)
    if metric not in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                      DistanceType.InnerProduct):
        raise ValueError(f"refine_host supports L2/IP metrics, got {metric!r}")
    cand = np.asarray(candidates)
    if k > cand.shape[1]:
        raise ValueError(f"k={k} > n_candidates={cand.shape[1]}")
    # gather only the referenced rows, so a memmap is read row-wise
    uniq, inv = np.unique(np.where(cand >= 0, cand, 0), return_inverse=True)
    rows = np.asarray(dataset[uniq.astype(np.int64)], dtype=np.float32)
    local = np.where(cand >= 0, inv.reshape(cand.shape), -1)
    old = torch.get_num_threads()
    if n_threads > 0:
        torch.set_num_threads(int(n_threads))
    try:
        q = torch.from_numpy(np.asarray(queries, dtype=np.float32))
        lc = torch.from_numpy(local.astype(np.int64))
        cand_vecs = torch.from_numpy(rows)[lc.clamp_min(0)]
        # score by column position, then map positions back to ids
        col = torch.arange(cand.shape[1]).expand(cand.shape[0], -1)
        col = torch.where(lc >= 0, col, -1)
        out_d, pos = score_gathered(q, cand_vecs, col, int(k), metric)
    finally:
        torch.set_num_threads(old)
    out_d = out_d.numpy()
    ids = np.take_along_axis(cand, pos.long().clamp_min(0).numpy(), axis=1)
    ids = np.where(np.isfinite(out_d) & (pos.numpy() >= 0), ids, -1)
    return out_d, ids.astype(np.int32)
