"""The pieces of ``raft_tpu/cluster/kmeans.py`` that balanced kmeans uses:
``_row_batches`` :55 and ``_centers_and_sizes`` :126. The rest of Lloyd's
kmeans is still to be ported (ROADMAP.md)."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def _row_batches(x: torch.Tensor, batch_rows: int) -> List[torch.Tensor]:
    """x cut into row blocks of at most ``batch_rows`` rows (views; the
    reference pads to a [nb, B, d] stack for its scan, an eager loop needs
    no padding)."""
    b = max(1, min(int(batch_rows), x.shape[0]))
    return [x[i:i + b] for i in range(0, x.shape[0], b)]


def _centers_and_sizes(x: torch.Tensor, labels: torch.Tensor,
                       weights: Optional[torch.Tensor], n_clusters: int,
                       batch_rows: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Weighted per-cluster sums [C, d] and sizes [C], both f32. Rows whose
    label lies outside [0, n_clusters) are dropped (the reference's one-hot
    product drops them the same way)."""
    x = x.float()
    d = x.shape[1]
    sums = torch.zeros((n_clusters, d), dtype=torch.float32, device=x.device)
    sizes = torch.zeros((n_clusters,), dtype=torch.float32, device=x.device)
    b = max(1, min(int(batch_rows), x.shape[0]))
    for i in range(0, x.shape[0], b):
        lab = labels[i:i + b].long()
        ok = (lab >= 0) & (lab < n_clusters)
        w = ok.float()
        if weights is not None:
            w = w * weights[i:i + b].float()
        lab = torch.where(ok, lab, torch.zeros_like(lab))
        sums.index_add_(0, lab, x[i:i + b] * w[:, None])
        sizes.index_add_(0, lab, w)
    return sums, sizes
