"""Brute-force (exact) KNN.

Counterpart of ``raft_tpu/neighbors/brute_force.py``: ``build`` :68,
``search`` :80, ``knn`` :360, ``save`` / ``load``. The expanded metrics (L2,
L2-sqrt, inner product, cosine) run through the fused distance + top-k
kernel (``ops.fused_topk``), prefilter included; the other metrics compute
distance blocks in plain PyTorch (``distance.pairwise._block_distance``,
XLA in the reference) merged into a running top-k. ``fast=True`` is the
reference's two-phase path: bf16 candidates (k_cand = 4k, at least k + 32)
from the kernel, then an exact f32 ``refine``.

``impl`` takes the reference's names: "auto" and "fused_exact[:tile]" run
the kernel's exact arm, "fused_fold[:tile]" its fold arm (the row tile of
the name, else the analytic ``ops.fused_topk.tile_geometry``'s), each on
the card (its plain version on CPU tensors); "scan", and any name ending
in ":interpret", the plain version (of the named arm). The fast path
resolves "auto" as the reference does (:func:`_resolve_bf_impl`, through
the ``fused_topk_tile`` dispatch table): on the card, unfiltered, the fold
arm at ``tile_geometry``'s tile while k_cand <= 256 — "fused_fold:2048" at
d = 128 and k = 10 — and the exact search otherwise, which the port runs
through its exact arm. ``tile_n`` is accepted for the reference's
signature; the exact kernel and the plain blocks choose their own tiles.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.core.serialize import read_index_file, write_index_file
from raft_tpu_torch.distance.pairwise import _EXPANDED, _block_distance, \
    _expanded_path
from raft_tpu_torch.distance.types import DistanceType, is_min_close, \
    resolve_metric
from raft_tpu_torch.neighbors.common import as_filter, blocked_topk, \
    filter_keep, sentinel_for
from raft_tpu_torch.ops import fused_topk

_SERIAL_VERSION = 1

_FUSED_KIND = {
    DistanceType.L2Expanded: fused_topk.L2,
    DistanceType.L2SqrtExpanded: fused_topk.L2,
    DistanceType.CosineExpanded: fused_topk.COSINE,
    DistanceType.InnerProduct: fused_topk.IP,
}


@dataclasses.dataclass
class Index:
    """The dataset plus precomputed squared norms for the expanded L2 and
    cosine metrics."""

    dataset: torch.Tensor
    metric: DistanceType
    metric_arg: float = 2.0
    norms: Optional[torch.Tensor] = None

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]


def _needs_norms(metric: DistanceType) -> bool:
    return metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                      DistanceType.CosineExpanded)


def build(dataset, metric="sqeuclidean", metric_arg: float = 2.0,
          device=None) -> Index:
    """Build a brute-force index on ``device`` (default: the CUDA card)."""
    metric = resolve_metric(metric)
    dataset = as_tensor(dataset, resolve_device(device))
    norms = None
    if _needs_norms(metric):
        ds32 = dataset.float()
        norms = (ds32 * ds32).sum(1)
    return Index(dataset=dataset, metric=metric, metric_arg=metric_arg,
                 norms=norms)


def _impl_route(impl: str) -> Tuple[str, str, Optional[int]]:
    """(route, variant, row tile) for the reference's ``impl`` names: the
    route "kernel" or "plain", the kernel's arm "exact" or "fold", and the
    tile the name carries (None)."""
    parts = str(impl).split(":")
    head, rest = parts[0], parts[1:]
    if head not in ("auto", "scan", "fused_exact", "fused_fold") or \
            (head in ("auto", "scan") and rest) or \
            not all(p.isdigit() or p == "interpret" for p in rest):
        raise ValueError(f"impl must be auto|scan|fused_exact[:tile_n]"
                         f"[:interpret]|fused_fold[:tile_n][:interpret], "
                         f"got {impl!r}")
    route = "plain" if head == "scan" or "interpret" in rest else "kernel"
    variant = "fold" if head == "fused_fold" else "exact"
    tile = next((int(p) for p in rest if p.isdigit()), None)
    return route, variant, tile


def _resolve_bf_impl(requested: str, m: int, n: int, d: int, k: int,
                     metric: DistanceType, filtered: bool, approx_ok: bool,
                     device) -> str:
    """The reference's brute-force backend choice (``brute_force.py:
    178-225``) for a search on ``device``: the fused kernel's arms are
    candidates only on the card, unfiltered, for the expanded metrics,
    within their budgets (``tuning.fused_topk_candidate_impls``: exact
    k <= 128, fold k <= 256 for callers that accept approximate
    candidates); the analytic pick is ``fused_<variant>:<tile_geometry's
    tile_n>`` (fold where ``approx_ok`` and k <= 256), or "scan" where that
    is no candidate; the table (``fused_topk_tile``) may pick another."""
    if requested != "auto":
        return requested
    from raft_tpu_torch import tuning

    fused_ok = (torch.device(device).type == "cuda" and
                metric in _FUSED_KIND and not filtered)
    candidates = ["scan"]
    if fused_ok:
        candidates += tuning.fused_topk_candidate_impls(k, approx_ok)
    if len(candidates) == 1:
        return "scan"
    variant = "fold" if approx_ok and k <= 256 else "exact"
    geo_tn = fused_topk.tile_geometry(m, n, d, k, variant,
                                      itemsize=2 if approx_ok else 4)
    analytic = f"fused_{variant}:{geo_tn['tile_n']}"
    if analytic not in candidates:
        analytic = "scan"
    return tuning.choose(
        "fused_topk_tile", {"m": int(m), "n": int(n), "d": int(d),
                            "k": int(k)},
        candidates, analytic, device=device)


def search(index: Index, queries, k: int, prefilter=None,
           tile_n: Optional[int] = None, fast: bool = False,
           impl: str = "auto") -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN search on the index's device: (distances [m, k], indices
    [m, k] int32), best-first. ``prefilter``: a Bitset or BitsetFilter
    over dataset row ids. Slots without a valid candidate hold the metric's
    sentinel distance and id -1. ``tile_n``, ``fast`` and ``impl`` as in
    the module docstring."""
    dev = index.dataset.device
    queries = as_tensor(queries, dev)
    n = index.size
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for dataset size {n}")
    route, variant, tile = _impl_route(impl)
    if fast and index.metric in _FUSED_KIND:
        return _search_fast(index, queries, int(k), prefilter, str(impl))
    filt = as_filter(prefilter)
    keep = None
    bits = getattr(filt, "bitset", None)
    if bits is not None:
        keep = filter_keep(bits.bits.to(dev), bits.n_bits,
                           torch.arange(n, device=dev),
                           out_of_range=getattr(filt, "out_of_range", "drop"))
    metric = index.metric
    sentinel = sentinel_for(metric)
    if metric in _FUSED_KIND and (k <= fused_topk.K_MAX or
                                  variant == "fold"):
        kind = _FUSED_KIND[metric]
        fused = (fused_topk.fused_knn_topk if route == "kernel"
                 else fused_topk.fused_knn_topk_plain)
        out_d, out_i = fused(
            queries, index.dataset, int(k), metric_kind=kind,
            norms=index.norms if kind != fused_topk.IP else None, keep=keep,
            variant=variant, tile_n=tile)
        if metric == DistanceType.InnerProduct:
            out_d = -out_d
        elif metric == DistanceType.L2SqrtExpanded:
            out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
        return torch.where(out_i < 0, sentinel, out_d), out_i
    return _search_blocks(index, queries, int(k), keep, sentinel)


def _search_fast(index: Index, queries: torch.Tensor, k: int, prefilter,
                 impl: str):
    """The reference's two-phase search: bf16 candidates at ~4x k through
    the resolved ``impl``, then an exact f32 refine of them."""
    from raft_tpu_torch.neighbors.refine import refine

    n = index.size
    k_cand = min(n, max(4 * k, k + 32))
    filtered = getattr(as_filter(prefilter), "bitset", None) is not None
    name = _resolve_bf_impl(impl, queries.shape[0], n, index.dim, k_cand,
                            index.metric, filtered, True,
                            index.dataset.device)
    if name == "scan" and impl == "auto":
        # the reference's exact scan: the port's exact search (its kernel's
        # exact arm on the card)
        name = "auto"
    bf = Index(dataset=index.dataset.to(torch.bfloat16), metric=index.metric,
               metric_arg=index.metric_arg, norms=index.norms)
    cand_d, cand = search(bf, queries.to(torch.bfloat16), k_cand,
                          prefilter=prefilter, impl=name)
    cand = torch.where(cand_d == sentinel_for(index.metric), -1, cand)
    return refine(index.dataset, queries, cand, k, index.metric,
                  device=index.dataset.device)


def _search_blocks(index: Index, queries: torch.Tensor, k: int,
                   keep: Optional[torch.Tensor], sentinel: float):
    """Plain distance blocks merged into a running top-k."""
    metric = index.metric
    q = queries.float()

    def block(c0: int, c1: int) -> torch.Tensor:
        xb = index.dataset[c0:c1].float()
        if metric in _EXPANDED:
            return _expanded_path(q, xb, metric)
        return _block_distance(q, xb, metric, float(index.metric_arg))

    return blocked_topk(block, index.size, k,
                        select_min=is_min_close(metric), sentinel=sentinel,
                        keep=keep)


def knn(queries, dataset, k: int, metric="sqeuclidean",
        metric_arg: float = 2.0, prefilter=None,
        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One-shot exact KNN on ``device`` (default: the CUDA card)."""
    return search(build(dataset, metric, metric_arg, device=device), queries,
                  k, prefilter=prefilter)


def save(path: str, index: Index) -> None:
    arrays = {"dataset": index.dataset.cpu().numpy()}
    if index.norms is not None:
        arrays["norms"] = index.norms.cpu().numpy()
    write_index_file(path, "brute_force", _SERIAL_VERSION,
                     {"metric": int(index.metric),
                      "metric_arg": index.metric_arg}, arrays)


def load(path: str, device=None) -> Index:
    dev = resolve_device(device)
    _, meta, arrays = read_index_file(path, "brute_force")
    return Index(
        dataset=as_tensor(arrays["dataset"], dev),
        metric=DistanceType(meta["metric"]),
        metric_arg=meta["metric_arg"],
        norms=(as_tensor(arrays["norms"], dev) if "norms" in arrays
               else None),
    )
