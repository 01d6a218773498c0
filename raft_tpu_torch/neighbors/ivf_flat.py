"""IVF-Flat: inverted-file index with uncompressed vectors.

Counterpart of ``raft_tpu/neighbors/ivf_flat.py``. Lists live in a dense
padded block ``storage`` [n_lists, cap, dim] built by sort-by-label and
scatter; ``indices`` [n_lists, cap] holds the source row ids (-1 in
padding). Search is the reference's five steps:

1. the coarse queries x centers product (plain f32 matmul, XLA in the
   reference) and ``select_k`` of the probed lists;
2. ``bucketize_pairs``: (query, probed list) pairs grouped by list into
   fixed-size buckets;
3. the list scan — one (query group x list) step per bucket — through the
   ``ops.ivf_scan`` kernel on CUDA (its plain version on the CPU);
4. ``unbucketize_merge``: candidates back to query order, exact merge;
5. the IP negation, the sentinel and -1 mapping, the L2-sqrt root.

Scan routes (``SearchParams.scan_impl``, the reference's names, through
``neighbors.common.scan_route``): each list keeps ``min(k, cap)``
candidates, as the reference's does, and where the reference runs its
kernel the scan takes the kernel's extraction arm
(``ops.ivf_scan.resolve_extract``): the dispatch table's
``ivf_scan_extract`` winner (the only way to the "fold" arm, whose
128 R-wide candidate rows the merge takes at their width), else below a
``local_recall_target`` of 1 the analytic pick ("binned" to k = 13 at the
default 0.95, else "binned_deep" to k = 256, on caps that are multiples of
128 over 128). "xla" runs the plain version, exact; "pallas_interpret" the
plain version with that arm; "pallas" the kernel with that arm (the plain
version on the CPU), raising past the kernel's 256; "auto" on the card the
kernel, with the arm where ``min(k, cap)`` <= 64 and the cap is
128-aligned (the reference's accelerator route), exact up to 256 and the
exact plain version beyond, and on the CPU the exact plain version (the
reference's CPU route). ``merge_recall_target`` is accepted at any value
and the merge is exact: off the TPU the reference's ``lax.approx_min_k``
returns the exact top-k too. The tracing spans have no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans_balanced import KMeansBalancedParams
from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.core.serialize import read_index_file, write_index_file
from raft_tpu_torch.distance.types import DistanceType, is_min_close, \
    resolve_metric
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors.common import as_filter, filter_keep, \
    merge_topk, resolve_filter_bits, scan_route, sentinel_for
from raft_tpu_torch.ops import ivf_scan
from raft_tpu_torch.utils.math import cdiv, round_up_to_multiple
from raft_tpu_torch.utils.precision import dist_dot

_SERIAL_VERSION = 1

# metrics the list-scan kernel implements
_SUPPORTED_METRICS = frozenset({
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.InnerProduct,
    DistanceType.CosineExpanded,
})

_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@dataclasses.dataclass
class IndexParams:
    """Build params. ``storage_dtype`` "bf16" halves the stored bytes (norms
    are computed from the rounded storage); ``kmeans_compute_dtype`` is the
    coarse trainer's product operand type."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    adaptive_centers: bool = False
    add_data_on_build: bool = True
    conservative_memory_allocation: bool = False  # the reference's; no-op
    kmeans_compute_dtype: str = "f32"
    storage_dtype: str = "f32"

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in _SUPPORTED_METRICS:
            raise ValueError(
                f"ivf_flat supports "
                f"{sorted(m.name for m in _SUPPORTED_METRICS)}, "
                f"got {self.metric!r}")


@dataclasses.dataclass
class SearchParams:
    """Search params. ``query_group``: queries per bucket (the base of
    :func:`adaptive_query_group`); ``bucket_batch``: the bucket count is
    padded to a multiple of it (kept for shape parity with the reference);
    ``compute_dtype``: "bf16" rounds both scan operands to bf16 (f32
    accumulation), "f32" scans f32 queries against the stored rows
    unrounded (bf16 rows widen exactly). ``local_recall_target``: the
    per-list recall budget that picks the scan's extraction arm;
    ``merge_recall_target``: accepted at any value, the merge is exact.
    ``scan_impl``: "auto" | "pallas" | "pallas_interpret" | "xla" (module
    docstring)."""

    n_probes: int = 20
    query_group: int = 256
    bucket_batch: int = 32
    compute_dtype: str = "bf16"
    local_recall_target: float = 0.95
    merge_recall_target: float = 1.0
    scan_impl: str = "auto"


@dataclasses.dataclass
class Index:
    """``storage`` [n_lists, cap, dim]; ``indices`` [n_lists, cap] int32
    (-1 in padding); ``list_sizes`` [n_lists] int32; ``centers``
    [n_lists, dim] f32; ``data_norms`` [n_lists, cap] f32 squared norms for
    the L2 and cosine metrics."""

    centers: torch.Tensor
    storage: torch.Tensor
    indices: torch.Tensor
    list_sizes: torch.Tensor
    metric: DistanceType
    metric_arg: float = 2.0
    adaptive_centers: bool = False
    data_norms: Optional[torch.Tensor] = None

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.centers.shape[1]

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())


def _aligned_cap(max_count: int) -> int:
    """List capacity: 128-aligned for real lists, 8-aligned for tiny ones
    (the reference's rule, so indexes carried across keep their shape)."""
    if max_count >= 64:
        return round_up_to_multiple(max_count, 128)
    return max(8, round_up_to_multiple(max_count, 8))


def _coarse_metric(metric: DistanceType) -> DistanceType:
    """IP and cosine train the coarse quantizer with the index metric; the
    L2 variants all train as L2."""
    if metric in (DistanceType.InnerProduct, DistanceType.CosineExpanded):
        return metric
    return DistanceType.L2Expanded


def _needs_norms(metric: DistanceType) -> bool:
    return metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                      DistanceType.L2Unexpanded, DistanceType.CosineExpanded)


def _pack_lists(data: torch.Tensor, labels: torch.Tensor,
                row_ids: torch.Tensor, n_lists: int, cap: int):
    """Scatter rows into padded list blocks (stable sort by label).

    Rows labelled >= n_lists are dropped; lists over ``cap`` rows keep their
    first ``cap`` rows in row order. Returns (storage, indices, sizes)."""
    n, d = data.shape
    if n_lists * cap >= 2**31:
        raise ValueError(
            f"padded list storage n_lists*cap = {n_lists}*{cap} overflows "
            "int32 row indexing — the coarse lists are badly skewed")
    dev = data.device
    labels = labels.long()
    order = torch.sort(labels, stable=True).indices
    sorted_labels = labels[order]
    counts = torch.bincount(labels.clamp_max(n_lists), minlength=n_lists + 1)
    counts = counts[:n_lists]
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(n, device=dev) - starts[
        sorted_labels.clamp_max(n_lists - 1)]
    keep = (sorted_labels < n_lists) & (pos < cap)
    slot = (sorted_labels * cap + pos)[keep]
    storage = torch.zeros((n_lists * cap, d), dtype=data.dtype, device=dev)
    storage[slot] = data[order[keep]]
    indices = torch.full((n_lists * cap,), -1, dtype=torch.int32, device=dev)
    indices[slot] = row_ids[order[keep]].to(torch.int32)
    return (storage.reshape(n_lists, cap, d), indices.reshape(n_lists, cap),
            counts.clamp_max(cap).to(torch.int32))


def build(params: IndexParams, dataset, row_ids=None, device=None) -> Index:
    """Build the index on ``device`` (default: the CUDA card): subsample a
    trainset, balanced-kmeans the coarse centers, label every row, and
    scatter rows into padded lists."""
    dev = resolve_device(device)
    dataset = as_tensor(dataset, dev)
    n, d = dataset.shape
    n_lists = int(params.n_lists)
    frac = float(params.kmeans_trainset_fraction)
    if 0 < frac < 1.0 and int(n * frac) >= n_lists:
        trainset = dataset[::max(int(1.0 / frac), 1)]
    else:
        trainset = dataset
    kb = KMeansBalancedParams(
        n_clusters=n_lists, n_iters=int(params.kmeans_n_iters),
        metric=_coarse_metric(params.metric),
        compute_dtype=str(params.kmeans_compute_dtype))
    centers = kmeans_balanced.fit(kb, trainset, device=dev)

    st_dtype = _DTYPES.get(str(params.storage_dtype))
    if st_dtype is None:
        raise ValueError(
            f"storage_dtype must be f32|bf16, got {params.storage_dtype!r}")
    if st_dtype == torch.bfloat16 and dataset.dtype not in (torch.float32,
                                                            torch.bfloat16):
        raise ValueError(
            f"storage_dtype='bf16' requires a float32 dataset, got "
            f"{dataset.dtype}")
    index = Index(
        centers=centers,
        storage=torch.zeros((n_lists, 0, d),
                            dtype=st_dtype if dataset.dtype == torch.float32
                            else dataset.dtype, device=dev),
        indices=torch.full((n_lists, 0), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros((n_lists,), dtype=torch.int32, device=dev),
        metric=params.metric,
        metric_arg=params.metric_arg,
        adaptive_centers=bool(params.adaptive_centers),
    )
    if not params.add_data_on_build:
        return index
    if row_ids is None:
        row_ids = torch.arange(n, dtype=torch.int32, device=dev)
    return extend(index, dataset, as_tensor(row_ids, dev))


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Add vectors on the index's device: label the new rows, repack all
    lists at the new capacity, optionally re-centre."""
    dev = index.centers.device
    new_vectors = as_tensor(new_vectors, dev)
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(index.size, index.size + n_new,
                               dtype=torch.int32, device=dev)
    new_ids = as_tensor(new_ids, dev).to(torch.int32)

    kb = KMeansBalancedParams(n_clusters=index.n_lists,
                              metric=_coarse_metric(index.metric))
    new_labels = kmeans_balanced.predict(kb, index.centers, new_vectors,
                                         device=dev)

    # existing lists flattened + the new rows appended; padding rows get the
    # out-of-range label C so _pack_lists drops them
    C = index.n_lists
    old_cap = index.storage.shape[1]
    if old_cap > 0 and index.size > 0:
        flat = index.storage.reshape(-1, index.dim)
        flat_ids = index.indices.reshape(-1)
        flat_labels = torch.where(
            flat_ids >= 0,
            torch.arange(C, dtype=torch.int32, device=dev).repeat_interleave(
                old_cap),
            torch.tensor(C, dtype=torch.int32, device=dev))
        data = torch.cat([flat, new_vectors.to(flat.dtype)])
        labels = torch.cat([flat_labels, new_labels])
        ids = torch.cat([flat_ids, new_ids])
    else:
        data = new_vectors.to(index.storage.dtype)
        labels, ids = new_labels, new_ids

    # only the per-list counts come to the host (they size cap)
    counts = index.list_sizes.cpu().numpy() + np.bincount(
        new_labels.cpu().numpy(), minlength=C)
    cap = _aligned_cap(int(counts.max()))
    storage, indices, list_sizes = _pack_lists(data, labels, ids, C, cap)

    centers = index.centers
    if index.adaptive_centers:
        centers, _ = kmeans_balanced.calc_centers_and_sizes(
            data, labels, C, device=dev)

    norms = None
    if _needs_norms(index.metric):
        s32 = storage.float()
        norms = (s32 * s32).sum(2)
    return dataclasses.replace(index, centers=centers, storage=storage,
                               indices=indices, list_sizes=list_sizes,
                               data_norms=norms)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def coarse_distances(q32: torch.Tensor, centers: torch.Tensor,
                     metric: DistanceType) -> torch.Tensor:
    """The coarse phase's queries x centers distances [m, C] in the
    metric's own space: inner products for IP, ``1 - cos`` for cosine,
    expanded squared L2 otherwise (shared by IVF-Flat and IVF-PQ)."""
    cdot = dist_dot(q32, centers.T)
    if metric == DistanceType.InnerProduct:
        return cdot
    if metric == DistanceType.CosineExpanded:
        qn = torch.linalg.norm(q32, dim=1, keepdim=True)
        cn = torch.linalg.norm(centers, dim=1)
        return 1.0 - cdot / torch.clamp_min(qn * cn[None, :], 1e-30)
    qn2 = (q32 * q32).sum(1, keepdim=True)
    cn2 = (centers * centers).sum(1)
    return qn2 + cn2[None, :] - 2.0 * cdot


def coarse_margins(index, queries, p: int = 2) -> torch.Tensor:
    """Per-query difficulty margin [m] in [0, 1] from the coarse quantizer
    (reference ``ivf_flat.py:380-421``): the gap between the best and the
    ``p``-th best center distance in min-close space, over the sum of
    their magnitudes. ~0 means the best ``p`` lists are indistinguishable
    (a hard query), large means the query sits in one list's basin.
    Shared by IVF-Flat and IVF-PQ indexes (any index with ``centers`` and
    ``metric``)."""
    centers = index.centers
    queries = as_tensor(queries, centers.device)
    C = int(centers.shape[0])
    if C < 2:
        return torch.ones((queries.shape[0],), dtype=torch.float32,
                          device=centers.device)
    p = int(max(2, min(int(p), C)))
    metric = DistanceType(int(index.metric))
    coarse = coarse_distances(queries.float(), centers, metric)
    if metric == DistanceType.InnerProduct:
        coarse = -coarse                        # min-close space
    vals, _ = select_k(coarse, p, select_min=True, device=centers.device)
    d1, dp = vals[:, 0], vals[:, p - 1]
    return torch.clamp((dp - d1) / (d1.abs() + dp.abs() + 1e-12), 0.0, 1.0)


def adaptive_query_group(m: int, n_probes: int, n_lists: int,
                         base: int) -> int:
    """Queries per bucket for a batch: ``base``, shrinking toward 128 for
    small batches so mostly-empty buckets waste less."""
    need = round_up_to_multiple(cdiv(m * n_probes, max(n_lists, 1)), 8)
    return min(int(base), max(128, need))


def bucketize_pairs(probes: torch.Tensor, m: int, n_probes: int, C: int,
                    group: int, bucket_batch: int):
    """Group (query, probed list) pairs into fixed-size per-list buckets:
    sort pairs by list id, split each list's run into buckets of ``group``
    queries, and gather the [n_buckets, group] tables from the sorted pairs.
    ``n_buckets`` is bounded by total/group + C + 1, padded to a multiple of
    ``bucket_batch``.

    Returns (bucket_list [nb], bucket_q [nb, group] (-1 = empty slot),
    pair_bucket [total], pair_pos [total], order [total], total, nb)."""
    dev = probes.device
    total = m * n_probes
    pair_q = torch.arange(m, dtype=torch.int32,
                          device=dev).repeat_interleave(n_probes)
    pair_l = probes.reshape(-1).to(torch.int32)
    order = torch.sort(pair_l, stable=True).indices
    sl = pair_l[order]
    sq = pair_q[order]
    bounds = torch.searchsorted(
        sl, torch.arange(C + 1, dtype=torch.int32, device=dev))
    counts = torch.diff(bounds)
    starts = bounds[:-1]
    sl_l = sl.long()
    rank_in_list = torch.arange(total, device=dev) - starts[sl_l]
    nb_per_list = -(-counts // group)
    bucket_start = torch.cumsum(nb_per_list, 0) - nb_per_list
    pair_bucket = bucket_start[sl_l] + rank_in_list // group
    pair_pos = rank_in_list % group

    n_buckets = total // group + C + 1
    nb_pad = round_up_to_multiple(n_buckets, bucket_batch)
    b_idx = torch.arange(nb_pad, device=dev)
    bl = torch.searchsorted(bucket_start, b_idx, right=True) - 1
    bl = bl.clamp(0, C - 1)
    rel_b = b_idx - bucket_start[bl]
    src = (starts[bl] + rel_b * group)[:, None] + torch.arange(
        group, device=dev)[None, :]
    valid = src < (starts[bl] + counts[bl])[:, None]
    bucket_q = torch.where(valid, sq[src.clamp(0, total - 1)],
                           torch.tensor(-1, dtype=torch.int32, device=dev))
    return (bl.to(torch.int32), bucket_q.to(torch.int32),
            pair_bucket.to(torch.int32), pair_pos.to(torch.int32),
            order.to(torch.int32), total, nb_pad)


def unbucketize_merge(cand_d: torch.Tensor, cand_i: torch.Tensor,
                      pair_bucket: torch.Tensor, pair_pos: torch.Tensor,
                      order: torch.Tensor, total: int, m: int, n_probes: int,
                      kl: int, k: int, select_min: bool):
    """Map per-bucket candidates back to query-major order (one composed
    row gather) and merge each query's n_probes x kl candidates into the
    final top-k. ``kl`` is the candidates' width ``cand_d.shape[2]``:
    min(k, cap), or 128 R from the fold arm."""
    if cand_d.shape[2] != kl:
        raise ValueError(f"kl={kl} is not the candidates' width "
                         f"{cand_d.shape[2]}")
    group = cand_d.shape[1]
    dev = cand_d.device
    flat_slot = pair_bucket.long() * group + pair_pos.long()
    inv = torch.empty(total, dtype=torch.long, device=dev)
    inv[order.long()] = torch.arange(total, device=dev)
    comp = flat_slot[inv]
    pd = cand_d.reshape(-1, kl)[comp]
    pi = cand_i.reshape(-1, kl)[comp]
    return merge_topk(pd.reshape(m, n_probes * kl),
                      pi.reshape(m, n_probes * kl), k, select_min)


def _ivf_search(queries: torch.Tensor, centers: torch.Tensor,
                storage: torch.Tensor, indices: torch.Tensor,
                list_sizes: torch.Tensor, k: int, n_probes: int,
                metric_val: int, group: int, bucket_batch: int,
                filter_nbits: int, compute_dtype: str = "bf16",
                data_norms: Optional[torch.Tensor] = None,
                filter_bits: Optional[torch.Tensor] = None,
                route: str = "kernel", extract: Optional[str] = "exact",
                local_recall_target: float = 1.0):
    metric = DistanceType(metric_val)
    select_min = is_min_close(metric)
    C, cap, d = storage.shape
    q32 = queries.float()
    m = q32.shape[0]
    sentinel = sentinel_for(metric)

    # coarse phase: queries x centers product + select n_probes
    _, probes = select_k(coarse_distances(q32, centers, metric), n_probes,
                         select_min=select_min, device=q32.device)

    (bucket_list, bucket_q, pair_bucket, pair_pos, order, total, nb_pad) = \
        bucketize_pairs(probes, m, n_probes, C, group, bucket_batch)

    # scan: one (query group x list) step per bucket; per-list top-k cannot
    # exceed the capacity, the merge over n_probes lists restores k (the
    # route is scan_route's, and so is the arm unless the kernel picks it
    # at this query group)
    kl = min(k, cap)
    if extract is None:
        rt = float(local_recall_target)
        extract = ivf_scan.resolve_extract(kl, cap, group, rt < 1.0, rt,
                                           q32.device)
    scan = (ivf_scan.ivf_list_scan_topk if route == "kernel"
            else ivf_scan.ivf_list_scan_topk_plain)
    if metric == DistanceType.InnerProduct:
        mk, qaux, pn2 = ivf_scan.IP, None, None
    else:
        qnorm = (q32 * q32).sum(1)
        pn2 = (data_norms if data_norms is not None
               else (storage.float() ** 2).sum(2))
        if metric == DistanceType.CosineExpanded:
            mk, qaux = ivf_scan.COSINE, torch.sqrt(qnorm)
        else:
            mk, qaux = ivf_scan.L2, qnorm
    keep = None
    if filter_bits is not None:
        keep = filter_keep(filter_bits, filter_nbits, indices).to(torch.int32)
    out_d, cand_i = scan(
        storage, indices, list_sizes, bucket_list, bucket_q, q32, qaux, pn2,
        keep, k=kl, metric_kind=mk, compute_dtype=compute_dtype,
        extract=extract)
    cand_d = -out_d if metric == DistanceType.InnerProduct else out_d
    cand_d = torch.where(torch.isinf(out_d), sentinel, cand_d)
    out_d, out_i = unbucketize_merge(
        cand_d, cand_i, pair_bucket, pair_pos, order, total, m, n_probes,
        int(cand_d.shape[2]), k, select_min)
    out_i = torch.where(out_d == sentinel, -1, out_i)
    if metric == DistanceType.L2SqrtExpanded:
        out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
    return out_d, out_i


def search(search_params: SearchParams, index: Index, queries, k: int,
           prefilter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN search on the index's device. Returns (distances
    [m, k], source ids [m, k] int32); ids are -1 where fewer than k valid
    candidates were found in the probed lists."""
    dev = index.centers.device
    queries = as_tensor(queries, dev)
    n_probes = int(min(search_params.n_probes, index.n_lists))
    cap = index.storage.shape[1]
    if cap == 0:
        raise ValueError(
            "index is empty — build with add_data_on_build or extend")
    if k > n_probes * cap:
        raise ValueError(
            f"k={k} exceeds n_probes*list_capacity={n_probes * cap}")
    route, extract = scan_route(search_params.scan_impl, min(k, cap), cap,
                                dev)
    if str(search_params.compute_dtype) not in _DTYPES:
        raise ValueError(f"compute_dtype must be f32|bf16, got "
                         f"{search_params.compute_dtype!r}")
    bits = resolve_filter_bits(as_filter(prefilter), lambda: index.size)
    group = adaptive_query_group(int(queries.shape[0]), n_probes,
                                 index.n_lists,
                                 int(search_params.query_group))
    return _ivf_search(
        queries, index.centers, index.storage, index.indices,
        index.list_sizes, int(k), n_probes, int(index.metric), group,
        int(search_params.bucket_batch),
        0 if bits is None else int(bits.n_bits),
        str(search_params.compute_dtype), index.data_norms,
        None if bits is None else bits.bits.to(dev), route, extract,
        float(search_params.local_recall_target))


# ---------------------------------------------------------------------------
# serialization — the reference's file format, readable by either package
# ---------------------------------------------------------------------------


def save(path: str, index: Index) -> None:
    storage = index.storage
    bf16 = storage.dtype == torch.bfloat16
    if bf16:
        # bf16 is stored widened to f32 (exact) and narrowed back on load
        storage = storage.float()
    arrays = {
        "centers": index.centers.cpu().numpy(),
        "storage": storage.cpu().numpy(),
        "indices": index.indices.cpu().numpy(),
        "list_sizes": index.list_sizes.cpu().numpy(),
    }
    if index.data_norms is not None:
        arrays["data_norms"] = index.data_norms.cpu().numpy()
    write_index_file(path, "ivf_flat", _SERIAL_VERSION, {
        "metric": int(index.metric),
        "metric_arg": index.metric_arg,
        "adaptive_centers": index.adaptive_centers,
        "storage_dtype": "bf16" if bf16 else str(arrays["storage"].dtype),
    }, arrays)


def load(path: str, device=None) -> Index:
    """Read an index written by either package onto ``device`` (default:
    the CUDA card)."""
    from raft_tpu_torch.convert import ivf_flat_index_from_numpy

    _, meta, arrays = read_index_file(path, "ivf_flat")
    index = ivf_flat_index_from_numpy(
        arrays, DistanceType(meta["metric"]), device=device,
        storage_dtype=meta.get("storage_dtype"))
    return dataclasses.replace(
        index, metric_arg=meta["metric_arg"],
        adaptive_centers=bool(meta["adaptive_centers"]))
