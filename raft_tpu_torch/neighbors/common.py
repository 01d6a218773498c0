"""Shared ANN scaffolding: sample filters, sentinels, top-k merge.

Counterpart of ``raft_tpu/neighbors/common.py`` (``as_filter`` :82,
``filter_keep`` :90, ``resolve_filter_bits`` :109, ``sentinel_for`` :160,
``merge_topk`` :165), plus :func:`blocked_topk`, the running block merge
that the plain exact searches share. The reference's approximate merge
(``lax.approx_min_k``, ``merge_recall_target < 1``) is a TPU
partial-reduce op with no counterpart here; every merge is exact — as the
reference's is off the TPU, where ``approx_min_k`` returns the exact
top-k. :func:`backend_route` maps the reference's backend names
(``join_impl``) onto the port's two routes; :func:`scan_route` does so for
the IVF list scans.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.types import DistanceType, is_min_close
from raft_tpu_torch.matrix.select_k import dispatch_select_impl, select_k

#: valid ``out_of_range`` modes for bitset filters: ``"drop"`` rejects a
#: sample id beyond the filter's n_bits (allow-list semantics); ``"keep"``
#: accepts it (tombstone keep-masks over an index extended after the
#: filter was built).
OUT_OF_RANGE_MODES = ("drop", "keep")


class NoneSampleFilter:
    """Accept everything."""

    def mask(self, sample_ids: torch.Tensor) -> torch.Tensor:
        return torch.ones(sample_ids.shape, dtype=torch.bool,
                          device=sample_ids.device)


class BitsetFilter:
    """Keep samples whose bit is set; ``out_of_range`` picks the fate of
    ids ``>= bitset.n_bits``. Negative ids are always rejected."""

    def __init__(self, bitset: Bitset, out_of_range: str = "drop"):
        if out_of_range not in OUT_OF_RANGE_MODES:
            raise ValueError(
                f"out_of_range must be one of {OUT_OF_RANGE_MODES}, "
                f"got {out_of_range!r}")
        self.bitset = bitset
        self.out_of_range = out_of_range

    def mask(self, sample_ids: torch.Tensor) -> torch.Tensor:
        return filter_keep(self.bitset.bits, self.bitset.n_bits, sample_ids,
                           out_of_range=self.out_of_range)


def as_filter(f) -> NoneSampleFilter | BitsetFilter:
    if f is None:
        return NoneSampleFilter()
    if isinstance(f, Bitset):
        return BitsetFilter(f)
    return f


def filter_keep(filter_bits: torch.Tensor, filter_nbits: int,
                sample_ids: torch.Tensor,
                out_of_range: str = "drop") -> torch.Tensor:
    """Keep-mask for a raw bitset: True where the sample id's bit is set.
    ``out_of_range`` decides ids ``>= filter_nbits``; negative ids are
    always rejected."""
    safe = sample_ids.clamp(0, filter_nbits - 1)
    tested = Bitset.test_bits(filter_bits, safe)
    in_range = sample_ids < filter_nbits
    if out_of_range == "keep":
        return (tested | ~in_range) & (sample_ids >= 0)
    return tested & in_range & (sample_ids >= 0)


def resolve_filter_bits(filt, id_bound):
    """The bitset to hand a drop-semantics scan kernel, or None.

    A ``"keep"``-mode filter narrower than ``id_bound`` is materialized —
    resized on a copy with the new bits set — and cached on the filter,
    keyed by ``(id_bound, bitset._version)``. ``id_bound`` may be a
    callable, evaluated only for keep-mode filters."""
    bits = getattr(filt, "bitset", None)
    if bits is None:
        return None
    if getattr(filt, "out_of_range", "drop") != "keep":
        return bits
    bound = int(id_bound() if callable(id_bound) else id_bound)
    if bits.n_bits >= bound:
        return bits
    key = (bound, getattr(bits, "_version", 0))
    cached = getattr(filt, "_materialized_keep", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    resized = bits.copy().resize(bound, default=True)
    try:
        filt._materialized_keep = (key, resized)
    except AttributeError:      # slotted/frozen filter: correct, uncached
        pass
    return resized


def backend_name(requested: str, what: str = "scan_impl") -> str:
    """A reference backend name (``scan_impl``, ``join_impl``) without its
    ``":<tile>"`` suffix (``"pallas:16"`` -> ``"pallas"``); raises for a
    name the reference does not take."""
    name = str(requested).split(":")[0]
    if name not in ("auto", "pallas", "pallas_interpret", "xla"):
        raise ValueError(f"{what} must be auto|pallas|pallas_interpret|xla, "
                         f"got {requested!r}")
    return name


def backend_route(requested: str, what: str = "join_impl") -> str:
    """The route a reference backend name takes here: ``"kernel"`` for
    ``"auto"`` and ``"pallas"`` (the CUDA kernel's wrapper, which runs its
    plain version on CPU tensors), ``"plain"`` for ``"xla"`` and
    ``"pallas_interpret"`` (the plain PyTorch version on any device). The
    list scans take :func:`scan_route` instead."""
    name = backend_name(requested, what)
    return "plain" if name in ("xla", "pallas_interpret") else "kernel"


def scan_route(requested: str, kl: int, cap: int,
               device) -> Tuple[str, Optional[str]]:
    """(route, extraction arm) of an IVF list scan, as the reference routes
    ``scan_impl`` (``ivf_flat._resolve_scan_impl``) for ``kl`` = min(k,
    cap) candidates a list of capacity ``cap`` on an index on ``device``.
    The route is ``"kernel"`` (the CUDA kernel) or ``"plain"`` (its plain
    version); the arm is "exact", or None where the reference runs its
    kernel, which picks the arm itself once the query group is known
    (``ops.ivf_scan.resolve_extract``: the dispatch table, else the
    analytic pick at the search's ``local_recall_target``):

    * "xla": plain, exact;
    * "pallas_interpret": plain, the kernel's arm;
    * "pallas[:tile]": the kernel with its arm on a CUDA index, plain with
      it on the CPU; past the kernel's ``K_MAX`` (256) it raises;
    * "auto": on a CUDA index the kernel, with its arm where ``kl`` <= 64
      and the cap is a multiple of 128 (where the reference's accelerator
      takes its kernel), exact up to ``K_MAX``, and the exact plain scan
      past it; on the CPU plain, exact (the reference's CPU route)."""
    from raft_tpu_torch.ops.ivf_scan import K_MAX

    name = backend_name(requested)
    cuda = torch.device(device).type == "cuda"
    if name == "xla":
        return "plain", "exact"
    if name == "pallas_interpret":
        return "plain", None
    if name == "pallas":
        if kl > K_MAX:
            raise ValueError(
                f"scan_impl={requested!r} keeps at most {K_MAX} candidates "
                f"per list, fewer than min(k, cap)={kl}; use scan_impl="
                "'auto' or 'xla' for the exact scan")
        return ("kernel" if cuda else "plain"), None
    if not cuda or kl > K_MAX:
        return "plain", "exact"
    if kl <= 64 and cap % 128 == 0:
        return "kernel", None
    return "kernel", "exact"


def sentinel_for(metric: DistanceType) -> float:
    """Worst-possible distance for masking invalid candidates."""
    return float("inf") if is_min_close(metric) else float("-inf")


def merge_topk(dists: torch.Tensor, idxs: torch.Tensor, k: int,
               select_min: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge candidate lists along the last axis into a top-k, best-first
    (ties to the earlier candidate). The selection's arm is the
    reference's (``common.py:202-219``): the ``merge_topk`` table section,
    else select_k's own dispatch ("auto")."""
    shape = dists.shape
    d2 = dists.reshape(-1, shape[-1])
    i2 = idxs.reshape(-1, shape[-1])
    impl = dispatch_select_impl(d2.shape[0], d2.shape[1], int(k), d2.dtype,
                                op="merge_topk", fallback="auto",
                                device=d2.device)
    vals, out_i = select_k(d2, k, in_idx=i2, select_min=select_min,
                           impl=impl, device=d2.device)
    return (vals.reshape(*shape[:-1], k), out_i.reshape(*shape[:-1], k))


# candidate columns per distance block in blocked_topk
BLOCK_ROWS = 1 << 14


def blocked_topk(distances: Callable[[int, int], torch.Tensor], n: int,
                 k: int, *, select_min: bool = True,
                 sentinel: float = float("inf"),
                 keep: Optional[torch.Tensor] = None,
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact top-k over ``n`` candidate columns, ``BLOCK_ROWS`` at a time:
    ``distances(c0, c1)`` gives the [m, c1 - c0] block, which is merged
    into a running top-k (stable, so ties go to the lower column).
    ``keep`` [n] (nonzero = eligible) masks columns to ``sentinel``; slots
    left at ``sentinel`` get id -1. Returns (dist [m, k], idx [m, k]
    int32)."""
    best_d = best_i = None
    for c0 in range(0, n, BLOCK_ROWS):
        c1 = min(n, c0 + BLOCK_ROWS)
        dist = distances(c0, c1)
        if keep is not None:
            dist = torch.where(keep[c0:c1].to(dist.device)[None, :] > 0,
                               dist, sentinel)
        col = torch.arange(c0, c1, dtype=torch.int32,
                           device=dist.device).expand(dist.shape[0], -1)
        if best_d is not None:
            dist = torch.cat([best_d, dist], dim=1)
            col = torch.cat([best_i, col], dim=1)
        best_d, best_i = merge_topk(dist, col, min(k, dist.shape[1]),
                                    select_min)
    return best_d, torch.where(best_d == sentinel, -1, best_i).int()
