"""Distance metric types (counterpart of ``raft_tpu/distance/types.py``:
the same enum values, names and ``is_min_close``)."""

from __future__ import annotations

import enum


class DistanceType(enum.IntEnum):
    L2Expanded = 0
    L2SqrtExpanded = 1
    CosineExpanded = 2
    L1 = 3
    L2Unexpanded = 4
    L2SqrtUnexpanded = 5
    InnerProduct = 6
    Linf = 7
    Canberra = 8
    LpUnexpanded = 9
    CorrelationExpanded = 10
    JaccardExpanded = 11
    HellingerExpanded = 12
    Haversine = 13
    BrayCurtis = 14
    JensenShannon = 15
    HammingUnexpanded = 16
    KLDivergence = 17
    RusselRaoExpanded = 18
    DiceExpanded = 19
    Precomputed = 100


# pylibraft-compatible metric name aliases
METRIC_NAMES: dict[str, DistanceType] = {
    "sqeuclidean": DistanceType.L2Expanded,
    "l2": DistanceType.L2SqrtExpanded,
    "euclidean": DistanceType.L2SqrtExpanded,
    "l2_expanded": DistanceType.L2Expanded,
    "l2_sqrt_expanded": DistanceType.L2SqrtExpanded,
    "cosine": DistanceType.CosineExpanded,
    "l1": DistanceType.L1,
    "cityblock": DistanceType.L1,
    "manhattan": DistanceType.L1,
    "l2_unexpanded": DistanceType.L2Unexpanded,
    "l2_sqrt_unexpanded": DistanceType.L2SqrtUnexpanded,
    "inner_product": DistanceType.InnerProduct,
    "dot": DistanceType.InnerProduct,
    "chebyshev": DistanceType.Linf,
    "linf": DistanceType.Linf,
    "canberra": DistanceType.Canberra,
    "minkowski": DistanceType.LpUnexpanded,
    "lp": DistanceType.LpUnexpanded,
    "correlation": DistanceType.CorrelationExpanded,
    "jaccard": DistanceType.JaccardExpanded,
    "hellinger": DistanceType.HellingerExpanded,
    "haversine": DistanceType.Haversine,
    "braycurtis": DistanceType.BrayCurtis,
    "jensenshannon": DistanceType.JensenShannon,
    "hamming": DistanceType.HammingUnexpanded,
    "kl_divergence": DistanceType.KLDivergence,
    "russellrao": DistanceType.RusselRaoExpanded,
    "dice": DistanceType.DiceExpanded,
}


def resolve_metric(metric) -> DistanceType:
    if isinstance(metric, DistanceType):
        return metric
    if isinstance(metric, int):
        return DistanceType(metric)
    name = str(metric).lower()
    if name not in METRIC_NAMES:
        raise ValueError(
            f"unknown metric {metric!r}; known: {sorted(METRIC_NAMES)}")
    return METRIC_NAMES[name]


def is_min_close(metric: DistanceType) -> bool:
    """True if smaller distance = more similar."""
    return metric != DistanceType.InnerProduct
