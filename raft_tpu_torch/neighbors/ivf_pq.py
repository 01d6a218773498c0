"""IVF-PQ: inverted-file index with product-quantized residuals.

Counterpart of ``raft_tpu/neighbors/ivf_pq.py``, with its names, its
parameters, its index fields and its index files.

* **Build** (``build`` :372, ``_quantizer_index`` :405, ``extend`` :1343):
  balanced-kmeans coarse centers, an orthogonal rotation (identity unless
  forced or ``rot_dim != dim``, else QR of a Gaussian), per-subspace or
  per-cluster PQ codebooks trained on rotated residuals, then codes
  bit-packed into 32-bit words (``32 // pq_bits`` codes a word, no code
  straddles a word) and scattered into padded list blocks. ``batch_size``
  streams the encode over host or device batches (``_stream_encode``).
  Codes are held as int32 words with the reference's uint32 bits; the
  carriers (``convert``, ``save`` / ``load``) view them as uint32.
* **The caches** (``_cache_kind_for`` :1825, ``_attach_cache`` :1907),
  the scan operands of kernel 2, each bit for bit the reference's on the
  same codes (the norm sidecars to their sum order):

  - "i8", the int8 decoded-residual cache (``_recon_cache_scan`` :1731):
    every stored vector's reconstructed residual over one scale
    ``max|pq_centers| / 127`` (round half to even, clipped to +-127), the
    "auto" cache whenever it fits ``_CACHE_BUDGET``;
  - "i4", the decoded residuals as packed signed nibbles
    (``_recon_cache_scan_i4`` :1524) with per-list, per-component scales
    at the least-error clip (``_pick_clip_scale`` :1570) and the
    dequantized norms; "auto" below the i8 budget;
  - "pq4", the 4-bit codes themselves, transposed (pq_bits 4);
  - "rabitq", the decoded residuals' sign bits with the estimator's
    per-row ``fac`` and true norms (``attach_rabitq_cache`` :1710);
  - the raw rotated-residual caches of ``attach_raw_residual_cache``
    (:1757), i4 (packed) or i8, with per-list scales from the dataset.

  Packed caches are [n_lists, words, cap] int32 words with the
  reference's uint32 bits, rows on the fast axis.
* **Search** (``_pq_search`` :1971, ``search`` :2244): the coarse queries x
  centers product and ``select_k`` of the probes, ``bucketize_pairs``,
  then one of two scans, then ``unbucketize_merge``.

  - The cache scan runs kernel 2 (``ops.ivf_scan``) on the cache in its
    residual-query mode: per bucket ``(q_rot - centers_rot[l]) * qscale``
    for L2, ``q_rot * qscale`` for inner product with ``q_rot . c_l``
    added after the kernel (``ivf_pq.py:2033-2120``); ``qscale`` is the
    per-list scales of the i4 and raw caches, 1 for pq4 and RaBitQ, else
    ``recon_scale``. The packed caches take the kernel's packed arms:
    i4, pq4 (scored against ``pq_centers``), and RaBitQ (sign bits, the
    queries zero-padded to the word width, ``cache_fac`` as the row
    scale). Norms are ``cache_qnorms`` where the cache carries them.
  - The decode-then-matmul scan (the reference's XLA body, :2122-2241) is
    plain PyTorch: codes unpacked and decoded through the codebooks (or an
    i8, i4 or RaBitQ cache read back at its scales), the ``lut_dtype``
    ladder ("auto" / "i8" / "f32" / "bf16" / "f8"),
    ``internal_distance_dtype`` "bf16", prefilters and flat codes.

  Routes (``SearchParams.scan_impl``): "xla" takes the decode scan,
  exact, as the reference's XLA body is; so does every search without
  the cache or whose ``lut_dtype`` forbids it. The others take the cache
  scan, routed as IVF-Flat's (``neighbors.common.scan_route``): each list
  keeps ``min(k, cap)`` candidates, and where the reference runs its
  kernel the kernel's extraction arm (the dispatch table's
  ``ivf_scan_extract`` winner, "fold" included, else below a
  ``local_recall_target`` of 1 the binned arm where it is eligible) —
  "pallas_interpret" the plain version with it, "pallas" the kernel with
  it, "auto" on the card the kernel with it where ``min(k, cap)`` <= 64
  and the cap is 128-aligned, exact otherwise (the plain version past
  256), and on the CPU the decode scan, exact (the reference's "auto"
  takes its XLA body off the accelerator). ``merge_recall_target``
  is accepted at any value and the merge is exact, as the reference's is
  off the TPU (``lax.approx_min_k`` returns the exact top-k there).
  ``coarse_margins`` (:2339) is IVF-Flat's, which reads only the centers.

Not ported: ``build_streamed`` and its checkpointed resume (with it
``_trainset_i4_scales``), ``search_refined`` (it runs a compiled plan),
and the tracing spans (ROADMAP.md).
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
from raft_tpu_torch.neighbors.common import as_filter, backend_name, \
    filter_keep, merge_topk, resolve_filter_bits, scan_route, sentinel_for
from raft_tpu_torch.neighbors.ivf_flat import _aligned_cap, _pack_lists, \
    adaptive_query_group, bucketize_pairs, coarse_distances, \
    coarse_margins, unbucketize_merge
from raft_tpu_torch.ops import ivf_scan
from raft_tpu_torch.utils.precision import dist_dot

# the file version written here, the reference's: v3 carries a serialized
# cache (cache-only and per-list-scaled caches), v4 the RaBitQ sidecar
_SERIAL_VERSION = 4


class codebook_gen:
    """Codebook training mode (reference ivf_pq_types.hpp:48)."""

    PER_SUBSPACE = 0
    PER_CLUSTER = 1


# metrics the PQ residual scoring implements (the reference's set)
_SUPPORTED_METRICS = frozenset({
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.InnerProduct,
})


@dataclasses.dataclass
class IndexParams:
    """Build params (reference ivf_pq_types.hpp:48-97).

    ``pq_dim`` 0 picks ``dim / 4`` rounded down to a multiple of 8 (at
    least 8); ``cache_decoded`` builds the cache that ``cache_dtype``
    names ("i8", "i4", "pq4", "rabitq") when it fits ``_CACHE_BUDGET``, or
    with "auto" the ladder's choice (:func:`_cache_kind_for`)."""

    n_lists: int = 1024
    metric: DistanceType = DistanceType.L2Expanded
    metric_arg: float = 2.0
    kmeans_n_iters: int = 20
    kmeans_trainset_fraction: float = 0.5
    pq_bits: int = 8
    pq_dim: int = 0
    codebook_kind: int = codebook_gen.PER_SUBSPACE
    force_random_rotation: bool = False
    add_data_on_build: bool = True
    kmeans_compute_dtype: str = "f32"
    cache_decoded: bool = True
    cache_dtype: str = "auto"

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in _SUPPORTED_METRICS:
            raise ValueError(
                f"ivf_pq supports "
                f"{sorted(m.name for m in _SUPPORTED_METRICS)}, "
                f"got {self.metric!r}")
        if not 4 <= self.pq_bits <= 8:
            raise ValueError(f"pq_bits must be in [4, 8], got {self.pq_bits}")


@dataclasses.dataclass
class SearchParams:
    """Search params (reference ivf_pq_types.hpp:110-146).

    ``lut_dtype``: "auto" scans the index's cache when it has one, else
    decodes in f32; "i8" requires an i8 or i4 cache; "f32" / "bf16" /
    "f8" force the decode scan at that precision (torch dtypes
    accepted).
    ``internal_distance_dtype``: "f32" | "bf16" (decode scan).
    ``compute_dtype``: the scan's operand type ("bf16" rounds both
    operands, f32 accumulation). ``local_recall_target``,
    ``merge_recall_target`` and ``scan_impl`` as in the module
    docstring."""

    n_probes: int = 20
    lut_dtype: object = "auto"
    internal_distance_dtype: object = "f32"
    query_group: int = 256
    bucket_batch: int = 32
    compute_dtype: str = "bf16"
    local_recall_target: float = 0.95
    merge_recall_target: float = 1.0
    scan_impl: str = "auto"


@dataclasses.dataclass
class Index:
    """IVF-PQ index (reference ivf_pq_types.hpp:199+).

    ``codes`` [n_lists, cap, n_words] int32 holding the reference's
    bit-packed uint32 words (or flat [n_lists * cap, n_words]);
    ``rec_norms`` [n_lists, cap] f32 squared norms of the reconstructed
    residuals; ``pq_centers`` [pq_dim, K, pq_len] (PER_SUBSPACE) or
    [n_lists, K, pq_len] (PER_CLUSTER); ``rotation`` [rot_dim, dim];
    ``recon_cache`` the scan cache or None: int8 [n_lists, cap, rot_dim]
    (with ``recon_scale``, or per-list ``cache_scales`` for the raw
    cache), or packed int32 words [n_lists, words, cap] (i4, pq4,
    RaBitQ); ``cache_scales`` [n_lists, rot_dim] (i4 and raw caches),
    ``cache_qnorms`` [n_lists, cap] (the norms those caches are scored
    against) and ``cache_fac`` [n_lists, cap] (RaBitQ's estimator
    scale)."""

    centers: torch.Tensor
    centers_rot: torch.Tensor
    rotation: torch.Tensor
    pq_centers: torch.Tensor
    codes: torch.Tensor
    indices: torch.Tensor
    list_sizes: torch.Tensor
    rec_norms: torch.Tensor
    metric: DistanceType
    pq_dim_: int
    metric_arg: float = 2.0
    codebook_kind: int = codebook_gen.PER_SUBSPACE
    pq_bits: int = 8
    recon_cache: Optional[torch.Tensor] = None
    recon_scale: float = 1.0
    cache_scales: Optional[torch.Tensor] = None
    cache_qnorms: Optional[torch.Tensor] = None
    cache_fac: Optional[torch.Tensor] = None
    cache_decoded: bool = True
    cache_dtype: str = "auto"

    @property
    def n_lists(self) -> int:
        return self.centers.shape[0]

    @property
    def dim(self) -> int:
        return self.rotation.shape[1]

    @property
    def rot_dim(self) -> int:
        return self.rotation.shape[0]

    @property
    def pq_dim(self) -> int:
        return self.pq_dim_

    @property
    def pq_len(self) -> int:
        return self.rot_dim // self.pq_dim

    @property
    def pq_book_size(self) -> int:
        return 1 << self.pq_bits

    @property
    def size(self) -> int:
        return int(self.list_sizes.sum())

    @property
    def cache_kind(self) -> str:
        """"i8" (int8 rows), "i4" (packed nibbles with per-list
        scales), "pq4" (the transposed 4-bit codes), "rabitq" (sign bits
        with ``cache_fac``) or "none"; the packed kinds are told apart by
        their sidecars, as in the reference."""
        if self.recon_cache is None:
            return "none"
        if self.recon_cache.dtype == torch.int32:
            if self.cache_fac is not None:
                return "rabitq"
            return "i4" if self.cache_scales is not None else "pq4"
        return "i8"


# the decoded-residual cache is skipped when it would exceed this many
# bytes (the reference's budget)
_CACHE_BUDGET = 10 << 30


# ---------------------------------------------------------------------------
# bit-packed code words (reference ivf_pq.py:269-300)
# ---------------------------------------------------------------------------


def codes_per_word(pq_bits: int) -> int:
    return 32 // pq_bits


def packed_words(pq_dim: int, pq_bits: int) -> int:
    return -(-pq_dim // codes_per_word(pq_bits))


def pack_codes(codes, pq_bits: int) -> torch.Tensor:
    """[..., pq_dim] codes -> [..., n_words] int32 words (the reference's
    uint32 bits; no code straddles a word)."""
    codes = torch.as_tensor(codes)
    cpw = codes_per_word(pq_bits)
    p = codes.shape[-1]
    nw = packed_words(p, pq_bits)
    c = codes.to(torch.int64)
    pad = nw * cpw - p
    if pad:
        c = torch.cat([c, c.new_zeros((*c.shape[:-1], pad))], dim=-1)
    c = c.reshape(*c.shape[:-1], nw, cpw)
    shifts = torch.arange(cpw, device=c.device, dtype=torch.int64) * pq_bits
    words = (c << shifts).sum(-1)
    # uint32 bits into int32: values past 2^31 wrap to negative
    words = torch.where(words >= 2 ** 31, words - 2 ** 32, words)
    return words.to(torch.int32)


def unpack_codes(packed, pq_dim: int, pq_bits: int) -> torch.Tensor:
    """[..., n_words] words -> [..., pq_dim] int32 codes."""
    return ivf_scan.unpack_fields(packed, pq_dim, pq_bits)


# ---------------------------------------------------------------------------
# quantizers (reference ivf_pq.py:308-494)
# ---------------------------------------------------------------------------


def make_rotation_matrix(rot_dim: int, dim: int, force_random: bool,
                         gen: torch.Generator) -> torch.Tensor:
    """Orthogonal rotation [rot_dim, dim]: the identity unless forced
    random or ``rot_dim != dim``, else QR of a Gaussian from ``gen``."""
    dev = gen.device
    if not force_random and rot_dim == dim:
        return torch.eye(dim, dtype=torch.float32, device=dev)
    s = max(rot_dim, dim)
    g = torch.randn((s, s), generator=gen, device=dev, dtype=torch.float32)
    q, _ = torch.linalg.qr(g)
    return q[:rot_dim, :dim].contiguous()


def _auto_pq_dim(dim: int) -> int:
    # the reference's heuristic: dim/4 rounded down to a multiple of 8, >= 8
    v = max(8, (dim // 4) // 8 * 8)
    return min(v, dim)


def _coarse_params(n_lists: int, metric: DistanceType, n_iters: int = 20,
                   compute_dtype: str = "f32") -> KMeansBalancedParams:
    return KMeansBalancedParams(
        n_clusters=n_lists, n_iters=n_iters,
        metric=(DistanceType.InnerProduct
                if metric == DistanceType.InnerProduct
                else DistanceType.L2Expanded),
        compute_dtype=compute_dtype)


# distance elements per encode block: [rows, p, K] f32 is the transient
_ENCODE_ELEMS = 1 << 26


def _encode_subspace(res: torch.Tensor, pq_centers: torch.Tensor
                     ) -> torch.Tensor:
    """codes[n, p] = argmin_j ||res[n, p, :] - pq_centers[p, j, :]||^2,
    row-blocked so that the [block, p, K] distances are the peak
    transient."""
    n, p, _ = res.shape
    K = pq_centers.shape[1]
    cn = (pq_centers * pq_centers).sum(2)[None]              # [1, p, K]
    block = max(1, _ENCODE_ELEMS // (p * K))
    out = []
    for r0 in range(0, n, block):
        rb = res[r0:r0 + block]
        dots = torch.bmm(rb.transpose(0, 1),
                         pq_centers.transpose(1, 2)).transpose(0, 1)
        rn = (rb * rb).sum(2)[:, :, None]
        out.append(torch.argmin(rn - 2.0 * dots + cn, dim=2).to(torch.uint8))
    return torch.cat(out) if out else res.new_zeros((0, p), dtype=torch.uint8)


def _encode_per_cluster(res: torch.Tensor, labels: torch.Tensor,
                        pq_centers: torch.Tensor) -> torch.Tensor:
    """PER_CLUSTER encode (each row against its list's codebook),
    row-blocked like :func:`_encode_subspace`."""
    n, p, _ = res.shape
    K = pq_centers.shape[1]
    block = max(1, _ENCODE_ELEMS // (p * K))
    out = []
    for r0 in range(0, n, block):
        rb = res[r0:r0 + block]
        books = pq_centers[labels[r0:r0 + block].long()]      # [b, K, len]
        dots = torch.bmm(rb, books.transpose(1, 2))           # [b, p, K]
        rn = (rb * rb).sum(2)[:, :, None]
        cn = (books * books).sum(2)[:, None, :]
        out.append(torch.argmin(rn - 2.0 * dots + cn, dim=2).to(torch.uint8))
    return torch.cat(out) if out else res.new_zeros((0, p), dtype=torch.uint8)


def _decode_gather(codes: torch.Tensor, pq_centers: torch.Tensor,
                   codebook_kind: int, list_ids=None) -> torch.Tensor:
    """Reconstruct rotated residuals from codes [..., pq_dim] -> [...,
    rot_dim] f32 by one flat row gather: row ``s * K + code``
    (PER_SUBSPACE) or ``list * K + code`` (PER_CLUSTER, ``list_ids``
    broadcastable to codes[..., 0])."""
    c = codes.long()
    K = pq_centers.shape[1]
    if codebook_kind == codebook_gen.PER_SUBSPACE:
        p = pq_centers.shape[0]
        flat = c + torch.arange(p, device=c.device) * K
    else:
        flat = c + (torch.as_tensor(list_ids, device=c.device).long()
                    * K)[..., None]
    table = pq_centers.reshape(-1, pq_centers.shape[-1])
    return table[flat].reshape(*codes.shape[:-1], -1)


def _book_chunk(n_rows: int, K: int, books: int) -> int:
    """Codebooks trained per batched call, so that the [B, rows, K]
    products stay near 2^28 elements."""
    return max(1, min(books, (1 << 28) // max(1, n_rows * K)))


def _quantizer_index(params: IndexParams, trainset: torch.Tensor, dim: int,
                     dev: torch.device) -> Index:
    """Train the coarse centers, the rotation and the PQ codebooks on
    ``trainset`` and return the EMPTY index."""
    n_lists = int(params.n_lists)
    pq_dim = int(params.pq_dim) or _auto_pq_dim(dim)
    pq_len = -(-dim // pq_dim)
    rot_dim = pq_dim * pq_len
    K = 1 << int(params.pq_bits)
    gen = torch.Generator(device=dev).manual_seed(0)

    kb = _coarse_params(n_lists, params.metric, int(params.kmeans_n_iters),
                        str(params.kmeans_compute_dtype))
    centers = kmeans_balanced.fit(kb, trainset, device=dev)
    rotation = make_rotation_matrix(rot_dim, dim,
                                    bool(params.force_random_rotation), gen)
    centers_rot = dist_dot(centers, rotation.T)

    # residuals of the trainset in the rotated space
    t_labels = kmeans_balanced.predict(kb, centers, trainset, device=dev)
    t_rot = dist_dot(trainset.float(), rotation.T)
    t_res = (t_rot - centers_rot[t_labels.long()]).reshape(-1, pq_dim,
                                                           pq_len)
    del t_rot
    n_train = t_res.shape[0]
    if params.codebook_kind == codebook_gen.PER_SUBSPACE:
        # one row subsample shared by every subspace: xs [p, S, len]
        S = min(n_train, max(K * 32, 8192))
        if n_train < S:
            sel = torch.randint(0, n_train, (S,), generator=gen, device=dev)
        else:
            sel = torch.randperm(n_train, generator=gen, device=dev)[:S]
        xs = t_res[sel].transpose(0, 1).contiguous()
    else:
        # S rows per cluster, wrapped from each cluster's run in label
        # order (empty clusters take global rows); a cluster's book trains
        # on all its subvectors: xs [C, S * p, len]
        S = max(64, 16384 // pq_dim)
        flat = t_res.reshape(n_train, rot_dim)
        lab = t_labels.long()
        order = torch.sort(lab, stable=True).indices
        counts = torch.bincount(lab, minlength=n_lists)
        starts = torch.cumsum(counts, 0) - counts
        s_idx = torch.arange(S, device=dev)
        pos = starts[:, None] + s_idx[None, :] % torch.clamp_min(
            counts[:, None], 1)
        pos = torch.where(counts[:, None] > 0, pos, s_idx[None, :] % n_train)
        xs = flat[order][pos].reshape(n_lists, S * pq_dim, pq_len)
    chunk = _book_chunk(xs.shape[1], K, xs.shape[0])
    pq_centers = torch.cat([
        kmeans_balanced.build_clusters_batched(xs[b0:b0 + chunk], K, 10, gen)
        for b0 in range(0, xs.shape[0], chunk)])

    nw = packed_words(pq_dim, int(params.pq_bits))
    return Index(
        centers=centers, centers_rot=centers_rot, rotation=rotation,
        pq_centers=pq_centers,
        codes=torch.zeros((n_lists, 0, nw), dtype=torch.int32, device=dev),
        indices=torch.full((n_lists, 0), -1, dtype=torch.int32, device=dev),
        list_sizes=torch.zeros((n_lists,), dtype=torch.int32, device=dev),
        rec_norms=torch.zeros((n_lists, 0), dtype=torch.float32, device=dev),
        metric=params.metric, pq_dim_=pq_dim, metric_arg=params.metric_arg,
        codebook_kind=int(params.codebook_kind),
        pq_bits=int(params.pq_bits),
        cache_decoded=bool(params.cache_decoded),
        cache_dtype=str(params.cache_dtype))


# ---------------------------------------------------------------------------
# build / encode / extend
# ---------------------------------------------------------------------------


def build(params: IndexParams, dataset, batch_size: Optional[int] = None,
          device=None) -> Index:
    """Build the index on ``device`` (default: the CUDA card).

    With ``batch_size`` the encode streams: ``dataset`` (a host array or a
    tensor on any device) is sliced into device batches of that many rows,
    so only the trainset, one batch and the packed codes live on the
    device at once."""
    dev = resolve_device(device)
    stream = batch_size is not None
    if not stream:
        dataset = as_tensor(dataset, dev)
    elif not isinstance(dataset, torch.Tensor):
        dataset = np.asarray(dataset)
    n, dim = dataset.shape
    frac = float(params.kmeans_trainset_fraction)
    if 0 < frac < 1.0 and int(n * frac) >= int(params.n_lists):
        trainset = dataset[::max(int(1.0 / frac), 1)]
    else:
        trainset = dataset
    index = _quantizer_index(params, as_tensor(trainset, dev), dim, dev)
    if not params.add_data_on_build:
        return index
    if not stream:
        return extend(index, dataset,
                      torch.arange(n, dtype=torch.int32, device=dev))
    return _stream_encode(index, dataset, n, int(batch_size))


def _stream_encode(index: Index, dataset, n: int,
                   batch_size: int) -> Index:
    """Encode ``dataset`` in device batches of ``batch_size`` rows; only
    the labels and packed codes accumulate on the device."""
    dev = index.centers.device
    labels, codes = [], []
    for off in range(0, n, batch_size):
        lab, packed = encode(index, as_tensor(dataset[off:off + batch_size],
                                              dev))
        labels.append(lab)
        codes.append(packed)
    labels = torch.cat(labels)
    codes = torch.cat(codes)
    ids = torch.arange(n, dtype=torch.int32, device=dev)
    counts = torch.bincount(labels.long(), minlength=index.n_lists)
    cap = _aligned_cap(int(counts.max()))
    codes_packed, indices, list_sizes = _pack_lists(
        codes, labels, ids, index.n_lists, cap)
    del codes
    rec_norms = _rec_norms(codes_packed, index.pq_centers,
                           index.codebook_kind, index.pq_dim, index.pq_bits)
    return _attach_cache(dataclasses.replace(
        index, codes=codes_packed, indices=indices, list_sizes=list_sizes,
        rec_norms=rec_norms))


def encode(index: Index, vectors) -> Tuple[torch.Tensor, torch.Tensor]:
    """Label and PQ-encode vectors against the index's quantizers; returns
    (labels [n] int32, packed codes [n, n_words] int32)."""
    dev = index.centers.device
    vectors = as_tensor(vectors, dev)
    kb = _coarse_params(index.n_lists, index.metric)
    labels = kmeans_balanced.predict(kb, index.centers, vectors, device=dev)
    x_rot = dist_dot(vectors.float(), index.rotation.T)
    res = (x_rot - index.centers_rot[labels.long()]).reshape(
        -1, index.pq_dim, index.pq_len)
    del x_rot
    if index.codebook_kind == codebook_gen.PER_SUBSPACE:
        codes = _encode_subspace(res, index.pq_centers)
    else:
        codes = _encode_per_cluster(res, labels, index.pq_centers)
    return labels, pack_codes(codes, index.pq_bits)


def extend(index: Index, new_vectors, new_ids=None) -> Index:
    """Encode and add vectors: the new rows are labelled and encoded, all
    lists are repacked at the new capacity, and the norms and cache are
    rebuilt."""
    if index.codes.shape[-1] == 0 and index.size > 0:
        raise ValueError(
            "cache-only index (built with keep_codes=False) cannot be "
            "extended — the packed codes were dropped at build")
    dev = index.centers.device
    new_vectors = as_tensor(new_vectors, dev)
    n_new = new_vectors.shape[0]
    if new_ids is None:
        new_ids = torch.arange(index.size, index.size + n_new,
                               dtype=torch.int32, device=dev)
    new_ids = as_tensor(new_ids, dev).to(torch.int32)
    labels, new_packed = encode(index, new_vectors)

    # existing lists flattened + the new rows appended; padding rows get
    # the out-of-range label C so _pack_lists drops them
    C = index.n_lists
    nw = packed_words(index.pq_dim, index.pq_bits)
    old_cap = index.indices.shape[1]
    if old_cap > 0 and index.size > 0:
        old_ids = index.indices.reshape(-1)
        old_labels = torch.where(
            old_ids >= 0,
            torch.arange(C, dtype=torch.int32,
                         device=dev).repeat_interleave(old_cap),
            torch.tensor(C, dtype=torch.int32, device=dev))
        codes_all = torch.cat([index.codes.reshape(-1, nw), new_packed])
        labels_all = torch.cat([old_labels, labels])
        ids_all = torch.cat([old_ids, new_ids])
    else:
        codes_all, labels_all, ids_all = new_packed, labels, new_ids

    counts = index.list_sizes.cpu().numpy() + np.bincount(
        labels.cpu().numpy(), minlength=C)
    cap = _aligned_cap(int(counts.max()))
    codes_packed, indices, list_sizes = _pack_lists(
        codes_all, labels_all, ids_all, C, cap)
    rec_norms = _rec_norms(codes_packed, index.pq_centers,
                           index.codebook_kind, index.pq_dim, index.pq_bits)
    return _attach_cache(dataclasses.replace(
        index, codes=codes_packed, indices=indices, list_sizes=list_sizes,
        rec_norms=rec_norms))


# decoded elements per list chunk in the per-list passes below
_LIST_CHUNK_ELEMS = 1 << 26


def _decoded_lists(codes_packed: torch.Tensor, pq_centers: torch.Tensor,
                   codebook_kind: int, pq_dim: int, pq_bits: int):
    """Yields (first list, decoded residuals [lists, cap, rot] f32), a
    chunk of lists at a time, so that the unpacked codes never exist for
    the whole index at once."""
    C, cap, _ = codes_packed.shape
    rot = pq_dim * pq_centers.shape[-1]
    step = max(1, _LIST_CHUNK_ELEMS // max(1, cap * rot))
    for l0 in range(0, C, step):
        blk = codes_packed[l0:l0 + step]
        u = unpack_codes(blk, pq_dim, pq_bits)                 # [b, cap, p]
        lids = torch.arange(l0, l0 + blk.shape[0],
                            device=blk.device)[:, None]
        yield l0, _decode_gather(u, pq_centers, codebook_kind,
                                 None if codebook_kind ==
                                 codebook_gen.PER_SUBSPACE else lids)


def _rec_norms(codes_packed: torch.Tensor, pq_centers: torch.Tensor,
               codebook_kind: int, pq_dim: int,
               pq_bits: int) -> torch.Tensor:
    """||reconstructed residual||^2 per stored vector [C, cap]."""
    C, cap, _ = codes_packed.shape
    out = torch.empty((C, cap), dtype=torch.float32,
                      device=codes_packed.device)
    for l0, recon in _decoded_lists(codes_packed, pq_centers, codebook_kind,
                                    pq_dim, pq_bits):
        out[l0:l0 + recon.shape[0]] = (recon * recon).sum(-1)
    return out


# ---------------------------------------------------------------------------
# the int8 decoded-residual cache (reference ivf_pq.py:1731-1970)
# ---------------------------------------------------------------------------


def _recon_cache_scan(codes_packed: torch.Tensor, pq_centers: torch.Tensor,
                      codebook_kind: int, pq_dim: int, pq_bits: int
                      ) -> Tuple[torch.Tensor, float]:
    """The int8 cache [C, cap, rot] and its scale: each decoded residual
    component over ``max|pq_centers| / 127`` (every component IS a codebook
    entry, so no data pass is needed), rounded half to even and clipped to
    +-127. Bit for bit the reference's cache on the same codes."""
    C, cap, _ = codes_packed.shape
    rot = pq_dim * pq_centers.shape[-1]
    # times the f32 reciprocal of 127, the bits the reference's compiled
    # division by a constant gives
    scale = torch.clamp_min(pq_centers.abs().max(), 1e-30) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=pq_centers.device)
    cache = torch.empty((C, cap, rot), dtype=torch.int8,
                        device=codes_packed.device)
    for l0, recon in _decoded_lists(codes_packed, pq_centers, codebook_kind,
                                    pq_dim, pq_bits):
        cache[l0:l0 + recon.shape[0]] = torch.clamp(
            torch.round(recon / scale), -127, 127).to(torch.int8)
    return cache, float(scale)


# ---------------------------------------------------------------------------
# the compressed caches (reference ivf_pq.py:1440-1830)
# ---------------------------------------------------------------------------


def unpack_i4(packed) -> torch.Tensor:
    """[..., nw] words -> [..., nw * 8] f32 raw values in [-8, 7] (callers
    apply the scales): the kernel's sign-extending decode."""
    w = torch.as_tensor(packed)
    return ivf_scan.unpack_fields(w, w.shape[-1] * 8, 4, signed=True).float()


def _quant_pack_i4(recon: torch.Tensor, scales: torch.Tensor):
    """[..., rot] f32 -> ([..., rot // 8] int32 packed signed nibbles,
    [...] f32 dequantized-vector norms)."""
    q = torch.clamp(torch.round(recon / scales), -8, 7).to(torch.int32)
    deq = q.float() * scales
    return pack_codes(q & 0xF, 4), (deq * deq).sum(-1)


_CLIP_CANDIDATES = (0.6, 0.7, 0.8, 0.9, 1.0)


def _pick_clip_scale(vals: torch.Tensor, base_scale: torch.Tensor,
                     ok: torch.Tensor, qmax: int = 7) -> torch.Tensor:
    """Per-list least-error clip: quantize ``vals`` [..., n, rot] (valid
    rows ``ok`` [..., n, 1]) at each candidate scale ``m * base_scale``
    [..., rot] and keep, per leading entry, the ``m`` with the least total
    squared error (the first on a tie)."""
    best_err = best_m = None
    for m in _CLIP_CANDIDATES:
        s = base_scale * m
        q = torch.clamp(torch.round(vals / s[..., None, :]), -qmax - 1, qmax)
        e = q * s[..., None, :] - vals
        err = torch.where(ok, e * e, 0.0).sum((-2, -1))
        if best_err is None:
            best_err, best_m = err, torch.full_like(err, m)
        else:
            best_m = torch.where(err < best_err, m, best_m)
            best_err = torch.minimum(err, best_err)
    return base_scale * best_m[..., None]


def _recon_cache_scan_i4(codes_packed: torch.Tensor, indices: torch.Tensor,
                         pq_centers: torch.Tensor, codebook_kind: int,
                         pq_dim: int, pq_bits: int):
    """The packed-int4 decoded-residual cache: (cache [C, rot // 8, cap]
    int32 words, per-list per-component scales [C, rot], dequantized norms
    [C, cap]). A list's base scale is its largest valid |component| / 7;
    the clip multiplier is picked on its valid rows; every row, padding
    included, is quantized, as the reference does."""
    C, cap, _ = codes_packed.shape
    rot = pq_dim * pq_centers.shape[-1]
    dev = codes_packed.device
    # times the f32 reciprocal of 7, the bits the reference's compiled
    # division by a constant gives
    inv7 = torch.tensor(1.0 / 7.0, dtype=torch.float32, device=dev)
    cache = torch.empty((C, rot // 8, cap), dtype=torch.int32, device=dev)
    scales = torch.empty((C, rot), dtype=torch.float32, device=dev)
    qnorms = torch.empty((C, cap), dtype=torch.float32, device=dev)
    for l0, recon in _decoded_lists(codes_packed, pq_centers, codebook_kind,
                                    pq_dim, pq_bits):
        l1 = l0 + recon.shape[0]
        ok = (indices[l0:l1] >= 0)[..., None]
        lmax = torch.where(ok, recon.abs(), 0.0).amax(1)
        base = torch.clamp_min(lmax, 1e-30) * inv7
        s_best = _pick_clip_scale(recon, base, ok)
        packed, qn = _quant_pack_i4(recon, s_best[:, None, :])
        cache[l0:l1] = packed.transpose(1, 2)
        scales[l0:l1] = s_best
        qnorms[l0:l1] = qn
    return cache, scales, qnorms


def bits_words(rot: int) -> int:
    """Sign-bit words per row: ceil(rot / 32) (the last may be partial)."""
    return -(-rot // 32)


def pack_sign_bits(vals: torch.Tensor) -> torch.Tensor:
    """[..., d] f32 -> [..., ceil(d / 32)] int32 words: bit j of word w set
    where vals[..., 32 w + j] > 0, pad bits zero."""
    return pack_codes((vals > 0).to(torch.int32), 1)


def unpack_sign_bits(packed, d: int) -> torch.Tensor:
    """[..., nw] words -> [..., d] f32 in {-1, +1} (pad bits dropped)."""
    return 2.0 * ivf_scan.unpack_fields(packed, d, 1).float() - 1.0


def _quant_pack_rabitq(res: torch.Tensor):
    """[..., rot] f32 residuals -> (packed [..., ceil(rot / 32)] int32,
    fac [...] = ||r||^2 / ||r||_1, norm2 [...]). All-zero rows get fac 0."""
    norm2 = (res * res).sum(-1)
    l1 = res.abs().sum(-1)
    return pack_sign_bits(res), norm2 / torch.clamp_min(l1, 1e-30), norm2


def _rabitq_cache_scan(codes_packed: torch.Tensor, indices: torch.Tensor,
                       pq_centers: torch.Tensor, codebook_kind: int,
                       pq_dim: int, pq_bits: int):
    """The sign-bit cache of the decoded reconstruction: (cache [C,
    ceil(rot / 32), cap] int32 words, fac [C, cap], the reconstruction's
    norms [C, cap]); padding slots are zeroed."""
    C, cap, _ = codes_packed.shape
    rot = pq_dim * pq_centers.shape[-1]
    dev = codes_packed.device
    cache = torch.empty((C, bits_words(rot), cap), dtype=torch.int32,
                        device=dev)
    fac = torch.empty((C, cap), dtype=torch.float32, device=dev)
    qnorms = torch.empty((C, cap), dtype=torch.float32, device=dev)
    for l0, recon in _decoded_lists(codes_packed, pq_centers, codebook_kind,
                                    pq_dim, pq_bits):
        l1 = l0 + recon.shape[0]
        recon = torch.where((indices[l0:l1] >= 0)[..., None], recon, 0.0)
        packed, f, n2 = _quant_pack_rabitq(recon)
        cache[l0:l1] = packed.transpose(1, 2)
        fac[l0:l1] = f
        qnorms[l0:l1] = n2
    return cache, fac, qnorms


def scan_bytes_per_row(kind: str, rot: int, pq_dim: int = 0):
    """The first-stage scan's bytes per scanned row: (code bytes, total
    with the per-row sidecars and the 4-byte id the scan also reads)."""
    if kind == "rabitq":
        return bits_words(rot) * 4, bits_words(rot) * 4 + 12
    if kind == "i4":
        return rot // 2, rot // 2 + 8
    if kind == "i8":
        return rot, rot + 8
    if kind == "pq4":
        return pq_dim // 2, pq_dim // 2 + 8
    raise ValueError(f"unknown scan kind {kind!r}")


def attach_rabitq_cache(index: Index) -> Index:
    """The index on the RaBitQ rung: its sign-bit cache and sidecars
    rebuilt from the packed codes, replacing the cache it carried."""
    if index.codes.dim() != 3 or index.codes.shape[-1] == 0:
        raise ValueError(
            "attach_rabitq_cache needs the packed codes (cache-only "
            "indexes already carry their final cache)")
    cache, fac, qnorms = _rabitq_cache_scan(
        index.codes, index.indices, index.pq_centers, index.codebook_kind,
        index.pq_dim, index.pq_bits)
    return dataclasses.replace(index, recon_cache=cache, recon_scale=1.0,
                               cache_scales=None, cache_qnorms=qnorms,
                               cache_fac=fac)


def attach_raw_residual_cache(index: Index, dataset, block_lists: int = 64,
                              dtype: str = "i4") -> Index:
    """The index with a RAW rotated-residual cache built from ``dataset``
    (the rows its ids name): packed int4 ("i4", 0.5 B a component) or
    int8 ("i8"), both with per-list least-error-clip scales over the
    stored residuals and the dequantized norms; padding slots get norm 0.
    ``block_lists`` lists at a time bound the [B, cap, rot] f32
    transient."""
    if dtype not in ("i4", "i8"):
        raise ValueError(f"dtype must be i4|i8, got {dtype!r}")
    qmax = 7 if dtype == "i4" else 127
    C, cap = index.indices.shape
    rot = index.rot_dim
    if dtype == "i4" and rot % 8 != 0:
        raise ValueError(f"int4 cache needs rot_dim % 8 == 0, got {rot}")
    dev = index.centers.device
    ds = as_tensor(dataset, dev)
    cache = torch.empty((C, rot // 8, cap) if dtype == "i4"
                        else (C, cap, rot),
                        dtype=torch.int32 if dtype == "i4" else torch.int8,
                        device=dev)
    scales = torch.empty((C, rot), dtype=torch.float32, device=dev)
    qnorms = torch.empty((C, cap), dtype=torch.float32, device=dev)
    # a true division: the reference runs this builder eagerly, op by op
    qmax_t = torch.tensor(float(qmax), dtype=torch.float32, device=dev)
    for c0 in range(0, C, block_lists):
        ids = index.indices[c0:c0 + block_lists]             # [B, cap]
        B = ids.shape[0]
        ok = (ids >= 0)[..., None]
        rows = ds[ids.clamp_min(0).long()].float()           # [B, cap, d]
        r_rot = dist_dot(rows.reshape(B * cap, -1), index.rotation.T)
        res = r_rot.reshape(B, cap, rot) - index.centers_rot[c0:c0 + B][
            :, None, :]
        res = torch.where(ok, res, 0.0)
        base = torch.clamp_min(res.abs().amax(1), 1e-30) / qmax_t
        s_blk = _pick_clip_scale(res, base, ok, qmax=qmax)   # [B, rot]
        if dtype == "i4":
            packed, qn = _quant_pack_i4(res, s_blk[:, None, :])
            cache[c0:c0 + B] = packed.transpose(1, 2)
        else:
            q8 = torch.clamp(torch.round(res / s_blk[:, None, :]), -128, 127)
            deq = q8 * s_blk[:, None, :]
            qn = (deq * deq).sum(-1)
            cache[c0:c0 + B] = q8.to(torch.int8)
        scales[c0:c0 + B] = s_blk
        qnorms[c0:c0 + B] = torch.where(ok[..., 0], qn, 0.0)
    return dataclasses.replace(index, recon_cache=cache, recon_scale=1.0,
                               cache_scales=scales, cache_qnorms=qnorms,
                               cache_fac=None)


def _cache_kind_for(cache_decoded: bool, cache_dtype: str, C: int, cap: int,
                    rot: int, pq_bits: int = 8, pq_dim: int = 0,
                    per_subspace: bool = True) -> Optional[str]:
    """The reference's cache ladder. "auto" is i8 whenever it fits the
    budget; below it, the rung that fits among i4, pq4 and RaBitQ, which
    the reference picks through its tuning table (``tuning.choose``) with
    "i4" as the analytic fallback (else no cache). The table waits for
    the port of ``tuning/`` (ROADMAP.md, Queue A item 1), so "auto" gives
    what the reference gives on a table miss or with tuning off. An
    explicit kind that does not fit gives no cache, as in the
    reference."""
    if not cache_decoded or cap == 0:
        return None
    ok = {
        "i8": C * cap * rot <= _CACHE_BUDGET,
        "i4": rot % 8 == 0 and C * cap * rot // 2 <= _CACHE_BUDGET,
        "pq4": (pq_bits == 4 and per_subspace and pq_dim > 0
                and pq_dim % 8 == 0 and C * cap * pq_dim // 2
                <= _CACHE_BUDGET),
        # sign-bit words plus the fac / norm sidecars per row
        "rabitq": C * cap * (bits_words(rot) * 4 + 8) <= _CACHE_BUDGET,
    }
    if cache_dtype == "auto":
        if ok["i8"]:
            return "i8"
        return "i4" if ok["i4"] else None
    if cache_dtype not in ok:
        raise ValueError(f"unknown cache_dtype {cache_dtype!r}")
    return cache_dtype if ok[cache_dtype] else None


def _resolve_cache_kind(index: Index) -> Optional[str]:
    return _cache_kind_for(
        bool(index.cache_decoded), str(index.cache_dtype), index.n_lists,
        index.indices.shape[1], index.rot_dim, int(index.pq_bits),
        int(index.pq_dim),
        int(index.codebook_kind) == codebook_gen.PER_SUBSPACE)


def _attach_cache(index: Index) -> Index:
    """(Re)build the cache that the ladder picks; cache-only indexes keep
    the cache they carry."""
    none = dict(recon_scale=1.0, cache_scales=None, cache_qnorms=None,
                cache_fac=None)
    if index.codes.dim() != 3 or index.codes.shape[-1] == 0:
        # flat codes / cache-only: never rebuilt here
        if index.codes.shape[-1] == 0 and index.recon_cache is not None:
            return index
        return dataclasses.replace(index, **none, recon_cache=None)
    kind = _resolve_cache_kind(index)
    args = (index.codes, index.pq_centers, index.codebook_kind,
            index.pq_dim, index.pq_bits)
    if kind is None:
        return dataclasses.replace(index, **none, recon_cache=None)
    if kind == "i8":
        cache, scale = _recon_cache_scan(*args)
        return dataclasses.replace(index, **{**none, "recon_scale": scale},
                                   recon_cache=cache)
    if kind == "pq4":
        # the "cache" is the packed codes in the kernel's [C, nw, cap]
        # layout (told apart from i4 by the absent scales)
        return dataclasses.replace(
            index, **none,
            recon_cache=index.codes.transpose(1, 2).contiguous())
    if kind == "rabitq":
        return attach_rabitq_cache(index)
    cache, scales, qnorms = _recon_cache_scan_i4(
        index.codes, index.indices, *args[1:])
    return dataclasses.replace(index, recon_cache=cache, recon_scale=1.0,
                               cache_scales=scales, cache_qnorms=qnorms,
                               cache_fac=None)


# ---------------------------------------------------------------------------
# search
# ---------------------------------------------------------------------------


def _norm_dtype_knob(v) -> str:
    """A lut / internal dtype knob (string or torch dtype) as "auto" |
    "i8" | "f32" | "bf16" | "f8"."""
    if isinstance(v, str):
        s = v.lower()
        if s in ("auto", "i8", "int8"):
            return "auto" if s == "auto" else "i8"
        if s in ("f32", "float32", "fp32"):
            return "f32"
        if s in ("bf16", "bfloat16", "f16", "fp16", "float16"):
            return "bf16"
        if s in ("f8", "fp8", "float8", "float8_e4m3fn", "e4m3"):
            return "f8"
        raise ValueError(f"unknown dtype knob {v!r}")
    if v == torch.float32:
        return "f32"
    if v in (torch.bfloat16, torch.float16):
        return "bf16"
    if "float8" in str(v):
        return "f8"
    raise ValueError(f"unknown dtype knob {v!r}")


def _scan_route(requested: str, use_cache: bool, kl: int, cap: int,
                device) -> Tuple[str, Optional[str]]:
    """(route, extraction arm) for a ``scan_impl`` name: route "kernel" |
    "cache_plain" | "decode". The cache scan takes :func:`scan_route`'s
    kernel or plain route and arm (None: the kernel's own pick at the
    query group); "xla", "auto" on a CPU index, and every search without
    the cache score in the decode body, exactly, as the reference's XLA
    body does."""
    name = backend_name(requested)
    if not use_cache:
        if name.startswith("pallas"):
            raise ValueError(
                f"scan_impl={requested!r} needs the decoded-residual cache "
                "(build with cache_decoded=True and keep lut_dtype='auto'/"
                "'i8')")
        return "decode", "exact"
    if name == "xla" or (name == "auto" and
                         torch.device(device).type != "cuda"):
        # the reference's CPU route ("auto" resolves to its XLA body off
        # the accelerator)
        return "decode", "exact"
    route, arm = scan_route(requested, kl, cap, device)
    return ("kernel" if route == "kernel" else "cache_plain"), arm


def _cache_scan(index: Index, q_rot: torch.Tensor, bucket_list, bucket_q,
                kl: int, keep, compute_dtype: str, plain: bool,
                extract: str = "exact"):
    """Kernel 2 over the index's cache with residual queries: (candidate
    distances [nb, G, kl] in the metric's own space, 128 R wide from the
    fold arm, ids). The query
    scale is the per-list ``cache_scales`` where the cache has them, 1
    for pq4 and RaBitQ, else ``recon_scale``; the packed caches take
    their arm, RaBitQ with the queries zero-padded to its word width;
    ``extract`` is the extraction arm."""
    scan = (ivf_scan.ivf_list_scan_topk_plain if plain
            else ivf_scan.ivf_list_scan_topk)
    kind = index.cache_kind
    ip = index.metric == DistanceType.InnerProduct
    if index.cache_scales is not None:
        scale = index.cache_scales
    elif kind in ("pq4", "rabitq"):
        scale = 1.0
    else:
        scale = index.recon_scale
    q, centers = q_rot, index.centers_rot
    if kind == "rabitq":
        pad = index.recon_cache.shape[1] * 32 - index.rot_dim
        q = torch.nn.functional.pad(q_rot, (0, pad))
        centers = torch.nn.functional.pad(centers, (0, pad))
    arm = dict(k=kl, compute_dtype=compute_dtype, scale=scale,
               packed_i4=kind == "i4", packed_bits=kind == "rabitq",
               pq_centers=index.pq_centers if kind == "pq4" else None,
               row_scale=index.cache_fac if kind == "rabitq" else None,
               extract=extract)
    if ip:
        out_d, cand_i = scan(
            index.recon_cache, index.indices, index.list_sizes, bucket_list,
            bucket_q, q, None, None, keep, metric_kind=ivf_scan.IP, **arm)
        # q . x ~ q_rot . c_l + q_rot . recon; the kernel gave -(q_rot .
        # recon), the per-(query, list) constant comes back here
        qc = dist_dot(q_rot, index.centers_rot.T)[
            bucket_q.long().clamp_min(0), bucket_list.long()[:, None]]
        cand_d = qc[:, :, None] + (-out_d)
    else:
        norms = (index.rec_norms if index.cache_qnorms is None
                 else index.cache_qnorms)
        out_d, cand_i = scan(
            index.recon_cache, index.indices, index.list_sizes, bucket_list,
            bucket_q, q, None, norms, keep, metric_kind=ivf_scan.L2,
            centers=centers, **arm)
        cand_d = out_d
    sentinel = sentinel_for(index.metric)
    return torch.where(torch.isinf(out_d), sentinel, cand_d), cand_i


def _cache_block(index: Index, bl: torch.Tensor) -> torch.Tensor:
    """The decode scan's rows of lists ``bl`` read back from an i8, i4 or
    RaBitQ cache at their scales: [bb, cap, rot] f32."""
    kind = index.cache_kind
    blk = index.recon_cache[bl]
    if kind == "rabitq":
        signs = unpack_sign_bits(blk.transpose(1, 2), index.rot_dim)
        return signs * index.cache_fac[bl][:, :, None]
    if kind == "i4":
        return unpack_i4(blk.transpose(1, 2)) * \
            index.cache_scales[bl][:, None, :]
    if index.cache_scales is not None:                   # raw i8, per list
        return blk.float() * index.cache_scales[bl][:, None, :]
    return blk.float() * torch.tensor(index.recon_scale, dtype=torch.float32,
                                      device=blk.device)


def _decode_scan(index: Index, q_rot: torch.Tensor, bucket_list, bucket_q,
                 kl: int, filter_bits, filter_nbits: int, mm: torch.dtype,
                 lut: str, internal: str, bucket_batch: int):
    """The decode-then-matmul scan (the reference's XLA body), one batch of
    ``bucket_batch`` buckets at a time: each probed list decoded (or read
    back from an i8, i4 or RaBitQ cache, scored against the cache's own
    norms, when ``lut`` allows it; pq4 decodes its codes), optionally
    through e4m3 at a per-batch scale, scored against the bucket's
    residual queries, masked, and cut to its top-kl."""
    metric = index.metric
    C, cap = index.indices.shape
    ip = metric == DistanceType.InnerProduct
    sentinel = sentinel_for(metric)
    select_min = is_min_close(metric)
    use_cache_blk = (index.cache_kind in ("i8", "i4", "rabitq")
                     and lut in ("auto", "i8"))
    norms = (index.cache_qnorms if use_cache_blk and
             index.cache_qnorms is not None else index.rec_norms)
    col = torch.arange(cap, device=q_rot.device)
    inv240 = torch.tensor(1.0 / 240.0, dtype=torch.float32,
                          device=q_rot.device)
    out_d, out_i = [], []
    for b0 in range(0, bucket_list.shape[0], bucket_batch):
        bl = bucket_list[b0:b0 + bucket_batch].long()
        bq = bucket_q[b0:b0 + bucket_batch].long()
        ids = index.indices[bl]
        sizes = index.list_sizes[bl].long()
        rn = norms[bl]
        if use_cache_blk:
            recon = _cache_block(index, bl)
        else:
            if index.codes.dim() == 2:
                rows = bl[:, None] * cap + col[None, :]
                blk_raw = index.codes[rows]
            else:
                blk_raw = index.codes[bl]
            blk_codes = unpack_codes(blk_raw, index.pq_dim, index.pq_bits)
            recon = _decode_gather(
                blk_codes, index.pq_centers, index.codebook_kind,
                None if index.codebook_kind == codebook_gen.PER_SUBSPACE
                else bl[:, None])
        if lut == "f8":
            # scaled round trip through e4m3 (unscaled values beyond +-448
            # would overflow); the scale is the batch's max times the f32
            # reciprocal of 240, as the reference's compiled division gives
            f8_scale = torch.clamp_min(recon.abs().max(), 1e-30) * inv240
            recon = (recon / f8_scale).to(torch.float8_e4m3fn).float() \
                * f8_scale
        recon = recon.to(mm).float()
        qsafe = bq.clamp_min(0)
        qr = q_rot[qsafe]                                    # [bb, G, rot]
        cr = index.centers_rot[bl]                           # [bb, rot]
        if ip:
            qc = torch.bmm(qr, cr[:, :, None])[:, :, 0]
            qdots = torch.bmm(qr.to(mm).float(), recon.transpose(1, 2))
            dist = qc[:, :, None] + qdots
        else:
            q_res = qr - cr[:, None, :]
            dots = torch.bmm(q_res.to(mm).float(), recon.transpose(1, 2))
            qrn = (q_res * q_res).sum(2)
            dist = torch.clamp_min(
                qrn[:, :, None] - 2.0 * dots + rn[:, None, :], 0.0)
        valid = (col[None, :] < sizes[:, None])[:, None, :] & \
            (bq >= 0)[:, :, None]
        if filter_bits is not None:
            valid = valid & filter_keep(filter_bits, filter_nbits,
                                        ids)[:, None, :]
        dist = torch.where(valid, dist, sentinel)
        if internal == "bf16":
            dist = dist.to(torch.bfloat16).float()
        ld, li = merge_topk(dist, ids[:, None, :].expand_as(dist), kl,
                            select_min)
        out_d.append(ld)
        out_i.append(li)
    return torch.cat(out_d), torch.cat(out_i)


def _pq_search(index: Index, queries: torch.Tensor, k: int, n_probes: int,
               group: int, bucket_batch: int, filter_bits,
               filter_nbits: int, compute_dtype: str, lut: str,
               internal: str, route: str, extract: Optional[str] = "exact",
               local_recall_target: float = 1.0):
    metric = index.metric
    select_min = is_min_close(metric)
    C, cap = index.indices.shape
    q32 = queries.float()
    m = q32.shape[0]
    sentinel = sentinel_for(metric)

    _, probes = select_k(coarse_distances(q32, index.centers, metric),
                         n_probes, select_min=select_min, device=q32.device)
    (bucket_list, bucket_q, pair_bucket, pair_pos, order, total, _) = \
        bucketize_pairs(probes, m, n_probes, C, group, bucket_batch)
    kl = min(k, cap)
    q_rot = dist_dot(q32, index.rotation.T)                  # [m, rot]
    # lut_dtype lowers the decode precision below the compute dtype
    bf16 = compute_dtype == "bf16" or lut == "bf16"
    if route in ("kernel", "cache_plain"):
        if extract is None:
            rt = float(local_recall_target)
            extract = ivf_scan.resolve_extract(kl, cap, group, rt < 1.0, rt,
                                               q32.device)
        keep = None
        if filter_bits is not None:
            keep = filter_keep(filter_bits, filter_nbits,
                               index.indices).to(torch.int32)
        cand_d, cand_i = _cache_scan(
            index, q_rot, bucket_list, bucket_q, kl, keep,
            "bf16" if compute_dtype == "bf16" else "f32",
            plain=route == "cache_plain", extract=extract)
    else:
        cand_d, cand_i = _decode_scan(
            index, q_rot, bucket_list, bucket_q, kl, filter_bits,
            filter_nbits, torch.bfloat16 if bf16 else torch.float32, lut,
            internal, bucket_batch)
    out_d, out_i = unbucketize_merge(
        cand_d, cand_i, pair_bucket, pair_pos, order, total, m, n_probes,
        int(cand_d.shape[2]), k, select_min)
    # fewer than k valid candidates: the id is -1 (refine would otherwise
    # re-score filtered-out ids back into the top-k)
    out_i = torch.where(out_d == sentinel, -1, out_i)
    if metric == DistanceType.L2SqrtExpanded:
        out_d = torch.sqrt(torch.clamp_min(out_d, 0.0))
    return out_d, out_i


def search(search_params: SearchParams, index: Index, queries, k: int,
           prefilter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate k-NN search on the index's device: (distances [m, k],
    source ids [m, k] int32; -1 where fewer than k valid candidates were
    found). Distances are PQ approximations — pair with ``refine`` for
    exact re-ranking."""
    dev = index.centers.device
    queries = as_tensor(queries, dev)
    n_probes = int(min(search_params.n_probes, index.n_lists))
    cap = index.indices.shape[1]
    if cap == 0:
        raise ValueError(
            "index is empty — build with add_data_on_build or extend")
    if k > n_probes * cap:
        raise ValueError(f"k={k} exceeds n_probes*list_capacity="
                         f"{n_probes * cap}")
    if str(search_params.compute_dtype) not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype must be f32|bf16, got "
                         f"{search_params.compute_dtype!r}")
    bits = resolve_filter_bits(as_filter(prefilter), lambda: index.size)
    group = adaptive_query_group(int(queries.shape[0]), n_probes,
                                 index.n_lists,
                                 int(search_params.query_group))
    lut = _norm_dtype_knob(search_params.lut_dtype)
    internal = _norm_dtype_knob(search_params.internal_distance_dtype)
    use_cache = index.recon_cache is not None and lut in ("auto", "i8")
    if lut == "i8" and index.cache_kind not in ("i8", "i4"):
        raise ValueError(
            "lut_dtype='i8' needs the decoded-residual cache; build with "
            "cache_decoded=True (and within _CACHE_BUDGET)")
    route, extract = _scan_route(
        str(search_params.scan_impl), use_cache, min(int(k), cap), cap, dev)
    # the decode scan reads the codes unless it reads an i8 / i4 / RaBitQ
    # cache's rows instead
    if route == "decode" and index.codes.shape[-1] == 0 and not (
            use_cache and index.cache_kind != "pq4"):
        raise ValueError(
            "this index was built with keep_codes=False (cache-only); the "
            "decode scan needs the packed codes — search with "
            "lut_dtype='auto' and the cache scan instead")
    return _pq_search(
        index, queries, int(k), n_probes, group,
        int(search_params.bucket_batch),
        None if bits is None else bits.bits.to(dev),
        0 if bits is None else int(bits.n_bits),
        str(search_params.compute_dtype), lut, internal, route, extract,
        float(search_params.local_recall_target))


# ---------------------------------------------------------------------------
# serialization — the reference's file format, readable by either package
# ---------------------------------------------------------------------------


def save(path: str, index: Index) -> None:
    """Write the index file the reference writes (kind "ivf_pq"). A cache
    that the codes cannot rebuild — a cache-only index's, a per-list-scaled
    raw cache, a RaBitQ cache — is written with its sidecars; the others
    are rebuilt from the codes on load, as the reference does."""
    cap = index.indices.shape[1]
    codes = index.codes.cpu().numpy().view(np.uint32)
    if codes.ndim == 2:
        codes = codes.reshape(index.n_lists, cap, -1)
    arrays = {
        "centers": index.centers.cpu().numpy(),
        "centers_rot": index.centers_rot.cpu().numpy(),
        "rotation": index.rotation.cpu().numpy(),
        "pq_centers": index.pq_centers.cpu().numpy(),
        "codes": codes,
        "indices": index.indices.cpu().numpy(),
        "list_sizes": index.list_sizes.cpu().numpy(),
        "rec_norms": index.rec_norms.cpu().numpy(),
    }
    cache_only = codes.shape[-1] == 0 and cap > 0
    if cache_only and index.recon_cache is None:
        raise ValueError("cache-only index has no recon_cache to serialize")
    raw_scaled = (index.cache_scales is not None
                  or index.cache_fac is not None)
    serialized = "none"
    if cache_only or raw_scaled:
        cache = index.recon_cache.cpu().numpy()
        arrays["recon_cache"] = (cache.view(np.uint32)
                                 if cache.dtype == np.int32 else cache)
        serialized = index.cache_kind
        for name in ("cache_scales", "cache_fac", "cache_qnorms"):
            if raw_scaled and getattr(index, name) is not None:
                arrays[name] = getattr(index, name).cpu().numpy()
    write_index_file(path, "ivf_pq", _SERIAL_VERSION, {
        "metric": int(index.metric),
        "metric_arg": index.metric_arg,
        "codebook_kind": int(index.codebook_kind),
        "pq_bits": int(index.pq_bits),
        "pq_dim": int(index.pq_dim),
        "cache_decoded": bool(index.cache_decoded),
        "cache_dtype": str(index.cache_dtype),
        "serialized_cache": serialized,
        "recon_scale": float(index.recon_scale),
    }, arrays)


def load(path: str, device=None) -> Index:
    """Read an index file written by either package onto ``device``
    (default: the CUDA card): a serialized cache is restored verbatim,
    else the cache is rebuilt from the codes."""
    from raft_tpu_torch.convert import ivf_pq_index_from_numpy

    version, meta, arrays = read_index_file(path, "ivf_pq")
    if version > _SERIAL_VERSION:
        raise ValueError(f"{path}: ivf_pq file version {version} is newer "
                         f"than this package reads ({_SERIAL_VERSION})")
    if meta.get("serialized_cache", "none") == "none":
        arrays.pop("recon_cache", None)
    return ivf_pq_index_from_numpy(
        arrays, DistanceType(meta["metric"]), device=device,
        pq_dim=int(meta["pq_dim"]), pq_bits=int(meta["pq_bits"]),
        codebook_kind=int(meta["codebook_kind"]),
        recon_scale=meta.get("recon_scale", 1.0),
        metric_arg=meta["metric_arg"],
        cache_decoded=bool(meta.get("cache_decoded", True)),
        cache_dtype=str(meta.get("cache_dtype", "auto")))
