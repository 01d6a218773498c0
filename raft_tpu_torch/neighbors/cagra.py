"""CAGRA: graph-based ANN (build: pruned KNN graph; search: beam search).

Counterpart of ``raft_tpu/neighbors/cagra.py``, with the same parameters,
index fields, packed inline layout and index files.

* **Build** makes an all-KNN graph — by default (``graph_build_algo=
  build_algo.IVF_PQ``, ``build_knn_graph``) an IVF-PQ self-search whose
  candidates are refined exactly (the list scan is kernel 2's int8 arm),
  or with nn-descent (``build_algo.NN_DESCENT``; its local join is a CUDA
  kernel, ``ops/graph_join``) — prunes it with ``optimize`` (detour
  counts, then reverse edges spliced in after ``degree/2`` protected slots
  — the reference's semantics, computed here with a sorted-list
  membership test instead of the reference's cube of comparisons), and
  packs the inline search layout.
* **Search** with the packed layout (the default on the card whenever
  the index carries ``nbr_pack``; on the CPU, as in the reference off its
  accelerator, the default is the scattered path): seeds from a query-shared slab scored by one f32
  matmul of bf16 operands, then ``iters`` beam steps (``ops/beam_step``:
  the CUDA kernel on the card, its plain version on the CPU), then an
  exact f32 rescore of the buffer's first R rows. Without the layout, or
  with ``compute_dtype`` set to ``"f32"`` / ``"bf16"``, the scattered path
  scores exact gathers with plain tensor code, as the reference's XLA path
  does.
* **Filtered search** accumulates filter-passing candidates beside the
  unfiltered traversal, as the reference does.

Per-query state is row-major [m, L]. The port has no ``obs`` spans, and
CAGRA's table-driven choices (the beam tile) stay analytic;
``serialize_to_hnswlib`` is not ported (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.core.serialize import read_index_file, write_index_file
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.matrix.bitonic import sort_by_key
from raft_tpu_torch.neighbors import nn_descent
from raft_tpu_torch.neighbors.common import (
    as_filter, backend_name, merge_topk, resolve_filter_bits)
from raft_tpu_torch.neighbors.ivf_flat import _pack_lists
from raft_tpu_torch.ops.beam_step import beam_merge_step, \
    beam_merge_step_plain, packed_row_layout
from raft_tpu_torch.utils.precision import dist_dot

_SERIAL_VERSION = 1
_MASK32 = 0xFFFFFFFF


class build_algo:
    """Graph build algorithm (reference cagra_types.hpp:47)."""

    IVF_PQ = 0
    NN_DESCENT = 1


@dataclasses.dataclass
class IndexParams:
    """Build params (reference cagra_types.hpp:47-63)."""

    intermediate_graph_degree: int = 64
    graph_degree: int = 32
    metric: DistanceType = DistanceType.L2Expanded
    graph_build_algo: int = build_algo.IVF_PQ
    add_data_on_build: bool = True  # API parity; dataset always attached
    # build the packed inline layout for fast search (skipped above
    # _INLINE_BUDGET bytes; search then takes the scattered path)
    inline_codes: bool = True
    # nn-descent iterations of an NN_DESCENT build (the reference's
    # cagra_types.hpp nn_descent_niter; the JAX package always runs
    # nn-descent's default of 20)
    nn_descent_niter: int = 20

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in (
            DistanceType.L2Expanded,
            DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded,
            DistanceType.InnerProduct,
        ):
            raise ValueError(
                f"cagra supports L2/IP metrics, got {self.metric!r}")
        if self.graph_degree > self.intermediate_graph_degree:
            raise ValueError(
                "graph_degree must be <= intermediate_graph_degree")


@dataclasses.dataclass
class SearchParams:
    """Search params (reference cagra_types.hpp:65-117)."""

    itopk_size: int = 64
    search_width: int = 4          # parents expanded per iteration
    max_iterations: int = 0        # 0 -> auto
    # traversal scoring: "auto" = the packed int8 layout when the index
    # has one (the final top-k is rescored exactly in f32), else exact
    # scattered gathers; "f32" | "bf16" force the scattered path with
    # that scoring type
    compute_dtype: str = "auto"
    # seeds scored per query (0 = max(2 * itopk, 128))
    n_seeds: int = 0
    # "auto" = "packed" when the index is on the card, carries nbr_pack
    # and compute_dtype is "auto", else "scattered"; the reference's names
    # force a route: "pallas" (packed, the kernel), "pallas_interpret"
    # (packed, the kernel's plain version), "xla" (scattered); the port's
    # own "packed" / "scattered" are accepted too
    scan_impl: str = "auto"
    # reference knobs kept for API parity (no-ops here, as in the
    # reference's batched search)
    algo: str = "auto"
    team_size: int = 0
    hashmap_min_bitlen: int = 0
    num_random_samplings: int = 1
    rand_xor_mask: int = 0x128394


@dataclasses.dataclass
class Index:
    """CAGRA index = dataset + fixed-degree graph (cagra_types.hpp:133).

    ``nbr_pack`` is the optional inline search layout: per node one int32
    row ``[deg*d/4 code words | deg norm bitcasts (L2) | deg neighbour
    ids]`` holding its neighbours' vectors int8-quantized with their
    exact norms and ids (``ops.beam_step.packed_row_layout``). Rebuilt on
    load; never serialized."""

    dataset: torch.Tensor      # [n, d]
    graph: torch.Tensor        # [n, degree] int32
    metric: DistanceType
    data_norms: Optional[torch.Tensor] = None   # [n] f32 (L2 metrics)
    nbr_pack: Optional[torch.Tensor] = None     # [n, W] int32 packed rows
    flat_codes: Optional[torch.Tensor] = None   # [n, d] int8 (seed scoring)
    code_scale: float = 1.0                     # int8 dequant scale

    @property
    def size(self) -> int:
        return self.dataset.shape[0]

    @property
    def dim(self) -> int:
        return self.dataset.shape[1]

    @property
    def graph_degree(self) -> int:
        return self.graph.shape[1]


# the inline layout is skipped when the packed table exceeds this many
# bytes; search then takes the scattered path
_INLINE_BUDGET = 6 << 30


def _code_scale(dataset: torch.Tensor) -> torch.Tensor:
    """The int8 dequant scale: max |x| / 127 (f32)."""
    return torch.clamp_min(dataset.float().abs().max(), 1e-30) / 127.0


def _pack_tables(dataset, graph, need_norms: bool, chunk: int = 1 << 14,
                 norms=None):
    """The packed inline layout: per node one int32 row ``[deg*d/4 code
    words | deg norm bitcasts | deg ids]`` (norms omitted for IP), plus
    flat int8 codes [n, d] for seed scoring and the dequant scale. Code
    word ``e*(d/4)+t`` holds bytes ``4t..4t+3`` of neighbour ``e``'s codes,
    little-endian. ``norms`` defaults to the rows' own squared norms;
    chunked over nodes to bound the [chunk, deg, d] gather."""
    n, d = dataset.shape
    deg = graph.shape[1]
    d32 = dataset.float()
    scale = _code_scale(d32)
    codes = torch.clamp(torch.round(d32 / scale), -127, 127).to(torch.int8)
    if need_norms and norms is None:
        norms = (d32 * d32).sum(1)
    dw, o_norm, o_id, W = packed_row_layout(deg, d, not need_norms)
    pack = torch.zeros((n, W), dtype=torch.int32, device=d32.device)
    for s in range(0, n, chunk):
        gc = graph[s:s + chunk]
        g = gc.clamp_min(0).long()
        b = codes[g].reshape(gc.shape[0], deg * d).to(torch.int64) & 0xFF
        words = (b[:, 0::4] | (b[:, 1::4] << 8) | (b[:, 2::4] << 16)
                 | (b[:, 3::4] << 24))
        words = torch.where(words >= 1 << 31, words - (1 << 32), words)
        pack[s:s + chunk, :dw] = words.to(torch.int32)
        if need_norms:
            pack[s:s + chunk, o_norm:o_norm + deg] = \
                norms[g].float().contiguous().view(torch.int32)
        pack[s:s + chunk, o_id:o_id + deg] = gc.to(torch.int32)
    return pack, codes, scale


def _inline_eligible(n: int, d: int, deg: int, need_norms: bool) -> bool:
    """The inline-layout gate: dims in whole code words, the packed table
    within ``_INLINE_BUDGET`` bytes, and ids below 2^30 (they ride as
    ``(id << 1) | explored`` in the beam step)."""
    if d % 4:
        return False
    row_bytes = 4 * packed_row_layout(deg, d, not need_norms)[3]
    return n * row_bytes <= _INLINE_BUDGET and n < (1 << 30)


def _attach_inline(index: Index, inline: bool) -> Index:
    n, d = index.dataset.shape
    deg = index.graph.shape[1]
    need_norms = index.metric != DistanceType.InnerProduct
    if not inline or not _inline_eligible(n, d, deg, need_norms):
        return index
    nbr_pack, flat_codes, scale = _pack_tables(
        index.dataset, index.graph, need_norms, norms=index.data_norms)
    return dataclasses.replace(index, nbr_pack=nbr_pack,
                               flat_codes=flat_codes,
                               code_scale=float(scale))


# ---------------------------------------------------------------------------
# build
# ---------------------------------------------------------------------------


def _detour_counts(graph: torch.Tensor, chunk: int) -> torch.Tensor:
    """Detour counts (reference kern_prune, graph_core.cuh:128): for node
    A with rank-sorted neighbours N, ``count[b] = #{a < b : N[b] in
    graph[N[a]]}``. Membership is a search in each two-hop list sorted
    once, over node chunks. A negative neighbour id indexes from the end,
    as in the reference."""
    n, D = graph.shape
    dev = graph.device
    tri = torch.arange(D, device=dev)[:, None] < torch.arange(
        D, device=dev)[None, :]                              # a < b
    out = torch.empty((n, D), dtype=torch.int32, device=dev)
    for s in range(0, n, chunk):
        g = graph[s:s + chunk].long()                        # [c, D]
        hops = torch.sort(graph[g].long(), dim=-1).values    # [c, D, D]
        want = g[:, None, :].expand(-1, D, -1).contiguous()  # [c, a, b] = N[b]
        pos = torch.searchsorted(hops, want).clamp_max(D - 1)
        found = hops.gather(-1, pos) == want     # N[b] in the hops of N[a]
        out[s:s + chunk] = (found & tri).sum(1).to(torch.int32)
    return out


def _optimize_impl(graph: torch.Tensor, counts: torch.Tensor, degree: int,
                   protected: int, chunk: int = 1 << 14) -> torch.Tensor:
    n, D = graph.shape
    dev = graph.device
    # 1. keep edges by ascending detour count, rank-stable
    key = counts.long() * D + torch.arange(D, device=dev)[None, :]
    order = torch.argsort(key, dim=1)[:, :degree]
    pruned = graph.gather(1, order)

    # 2. reverse graph, capped at degree per node
    src = torch.arange(n, dtype=torch.int32,
                       device=dev).repeat_interleave(degree)
    dst = pruned.reshape(-1).long()
    dst = torch.where(dst >= 0, dst, n)
    _, rev, _ = _pack_lists(
        torch.zeros((n * degree, 1), dtype=torch.int8, device=dev), dst, src,
        n, degree)

    # 3. splice the reverse edges after the protected prefix: protected
    #    originals, then reverse edges, then the remaining originals, with
    #    duplicates (of the prefix or of an earlier candidate) dropped
    prot = pruned[:, :protected]
    tail = pruned[:, protected:]
    cand_full = torch.cat([rev, tail], 1)                    # [n, L]
    L = cand_full.shape[1]
    tri = torch.arange(L, device=dev)[None, :] < torch.arange(
        L, device=dev)[:, None]                              # j < i
    kept = []
    for s in range(0, n, chunk):
        cand, pr = cand_full[s:s + chunk], prot[s:s + chunk]
        dup_prot = (cand[:, :, None] == pr[:, None, :]).any(2)
        dup_earlier = ((cand[:, :, None] == cand[:, None, :]) & tri).any(2)
        bad = dup_prot | dup_earlier | (cand < 0)
        rank = torch.sort(bad.to(torch.int32), dim=1,
                          stable=True).indices[:, :degree - protected]
        k = cand.gather(1, rank)
        # a -1 left in a degenerate tiny graph falls back to the original
        kept.append(torch.where(k >= 0, k, tail[s:s + chunk]))
    return torch.cat([prot, torch.cat(kept)], 1).to(torch.int32)


def optimize(graph, degree: int, chunk: int = 1024) -> torch.Tensor:
    """Prune a KNN graph to ``degree`` by two-hop detour count +
    reverse-edge augmentation (reference graph_core.cuh:320 optimize).
    Runs on the graph's device."""
    graph = torch.as_tensor(graph).to(torch.int32)
    counts = _detour_counts(graph, int(chunk))
    protected = max(int(degree) // 2, 1)
    return _optimize_impl(graph, counts, int(degree), protected)


def _norms_for(dataset: torch.Tensor, metric: DistanceType):
    if metric == DistanceType.InnerProduct:
        return None
    d32 = dataset.float()
    return (d32 * d32).sum(1)


def build_knn_graph(dataset, intermediate_degree: int, metric: DistanceType,
                    refine_rate: float = 2.0, query_batch: int = 16384,
                    min_degree: Optional[int] = None,
                    device=None) -> torch.Tensor:
    """Raw KNN graph by IVF-PQ self-search + exact refine (reference
    ``cagra.py:345-440``): [n, min(intermediate_degree, 63)] int32 when the
    trim applies, else [n, intermediate_degree]; self excluded.

    The reference's parameter heuristic: ``n_lists = clip(n / 2500, 16,
    1024)``, ``pq_dim`` = d/2 rounded up to a multiple of 8, 10 k-means
    iterations, a trainset fraction of ``clip(10000 n_lists / n, 0.1,
    0.5)``, ``n_probes = max(10, n_lists / 10)``. The search k is trimmed
    to 64 when the final degree (``min_degree``) allows it (63 neighbours
    after the self edge), as the reference keeps its self-search on the
    fused scan's k <= 64. Queries run in ``query_batch`` batches, each
    refined exactly; the self edge (or, if absent, the worst candidate) is
    pushed to the end and cut."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.neighbors.refine import refine

    dev = resolve_device(device)
    dataset = as_tensor(dataset, dev)
    n, d = dataset.shape
    k = int(intermediate_degree) + 1              # +1: drop self afterwards
    if k > 64 and min_degree is not None and min_degree <= 63:
        if k > 65:
            import warnings

            warnings.warn(
                f"CAGRA build: intermediate_graph_degree={k - 1} trimmed "
                f"to 63 to keep the self-search at k <= 64 (final "
                f"graph_degree={min_degree} is unaffected; pass "
                f"min_degree=None to keep the full candidate pool)",
                stacklevel=2)
        k = 64
    k = min(k, n)
    gpu_top_k = min(n, max(k, int(k * refine_rate)))
    if k <= 64 and gpu_top_k > 64:
        gpu_top_k = 64

    n_lists = int(np.clip(n // 2500, 16, 1024))
    pq_dim = max(8, ((d // 2) + 7) // 8 * 8)
    params = ivf_pq.IndexParams(
        n_lists=n_lists, pq_dim=min(pq_dim, d),
        metric=(DistanceType.InnerProduct
                if metric == DistanceType.InnerProduct
                else DistanceType.L2Expanded),
        kmeans_n_iters=10,
        kmeans_trainset_fraction=min(0.5, max(0.1, 10000.0 * n_lists / n)))
    index = ivf_pq.build(params, dataset, device=dev)
    sp = ivf_pq.SearchParams(n_probes=min(n_lists, max(10, n_lists // 10)))
    rows = []
    for start in range(0, n, query_batch):
        q = dataset[start:start + query_batch]
        _, cand = ivf_pq.search(sp, index, q, gpu_top_k)
        # always refine: optimize reads rank order, and PQ ranks are
        # approximate even when gpu_top_k == k
        _, cand = refine(dataset, q, cand, k, metric, device=dev)
        rows.append(cand)
    graph = torch.cat(rows)
    self_col = graph == torch.arange(n, dtype=graph.dtype,
                                     device=dev)[:, None]
    order = torch.sort(self_col.to(torch.int32), dim=1, stable=True).indices
    keep = min(int(intermediate_degree), k - 1)
    return torch.gather(graph, 1, order)[:, :keep].to(torch.int32)


def build(params: IndexParams, dataset, device=None) -> Index:
    """Build the index on ``device`` (default: the CUDA card): a KNN graph
    (IVF-PQ self-search + refine, or nn-descent), ``optimize``, packed
    inline layout."""
    dev = resolve_device(device)
    dataset = as_tensor(dataset, dev)
    if params.graph_build_algo == build_algo.NN_DESCENT:
        nd_params = nn_descent.IndexParams(
            graph_degree=int(params.intermediate_graph_degree),
            metric=params.metric,
            max_iterations=int(params.nn_descent_niter))
        knn = nn_descent.build(nd_params, dataset, device=dev).graph
    elif params.graph_build_algo == build_algo.IVF_PQ:
        knn = build_knn_graph(dataset, int(params.intermediate_graph_degree),
                              params.metric,
                              min_degree=int(params.graph_degree),
                              device=dev)
    else:
        raise ValueError(f"unknown graph_build_algo "
                         f"{params.graph_build_algo!r}")
    graph = optimize(knn, int(params.graph_degree))
    index = Index(dataset=dataset, graph=graph, metric=params.metric,
                  data_norms=_norms_for(dataset, params.metric))
    return _attach_inline(index, params.inline_codes)


def from_graph(dataset, graph, metric=DistanceType.L2Expanded,
               inline_codes: bool = True, device=None) -> Index:
    """Wrap a prebuilt graph (pylibraft cagra.Index from_graph analog) on
    ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    dataset = as_tensor(dataset, dev)
    metric = resolve_metric(metric)
    index = Index(dataset=dataset,
                  graph=as_tensor(graph, dev, torch.int32),
                  metric=metric, data_norms=_norms_for(dataset, metric))
    return _attach_inline(index, inline_codes)


# ---------------------------------------------------------------------------
# search helpers
# ---------------------------------------------------------------------------


def _next_pow2(x: int) -> int:
    return 1 << (int(x) - 1).bit_length()


def _pad_cols(a: torch.Tensor, L: int, fill):
    pad = L - a.shape[1]
    if pad <= 0:
        return a
    return torch.cat([a, torch.full((a.shape[0], pad), fill, dtype=a.dtype,
                                    device=a.device)], 1)


def _window_dedup(sd, si, se, window: int = 2):
    """Windowed dedup on distance-sorted rows: a copy of an id within
    ``window`` slots after an earlier copy is blanked to (+inf, -1,
    explored), and the earlier copy inherits its explored flag."""
    dup = torch.zeros(si.shape, dtype=torch.bool, device=si.device)
    e = se
    for s in range(1, window + 1):
        eq = (si[:, s:] == si[:, :-s]) & (si[:, s:] >= 0)
        dup[:, s:] |= eq
        e = e | torch.nn.functional.pad(eq & se[:, s:], (0, s))
    sd = torch.where(dup, torch.inf, sd)
    si = torch.where(dup, -1, si)
    e = torch.where(dup, True, e)
    return sd, si, e


def _sorted_buffer(dists, ids, itopk: int):
    """Sort candidate rows, dedup, return the first ``itopk`` slots."""
    m, L0 = ids.shape
    L = _next_pow2(max(L0, itopk))
    sd = _pad_cols(dists, L, torch.inf)
    si = _pad_cols(ids, L, -1)
    se = torch.zeros((m, L), dtype=torch.bool, device=ids.device)
    sd, (si, se) = sort_by_key(sd, si, se)
    sd, si, se = _window_dedup(sd, si, se)
    return sd[:, :itopk], si[:, :itopk], se[:, :itopk]


def _seed_ids(m: int, n: int, n_seeds: int, device) -> torch.Tensor:
    """Deterministic pseudo-random seed nodes per query, in uint32
    arithmetic as the reference draws them."""
    a = (torch.arange(m, dtype=torch.int64, device=device)[:, None]
         * 2654435761) & _MASK32
    b = (torch.arange(n_seeds, dtype=torch.int64, device=device)[None, :]
         * 40503) & _MASK32
    return (((a + b + 0x128394) & _MASK32) % n).to(torch.int32)


def _pick_parents(buf_d, buf_i, buf_e, width: int):
    """First ``width`` unexplored entries of the sorted buffer
    (pickup_next_parents): parents [m, width] (-1 = none left), flags."""
    une = (~buf_e) & (buf_i >= 0) & torch.isfinite(buf_d)
    rank = torch.cumsum(une.to(torch.int32), 1) - 1
    sel = une & (rank < width)
    parents = torch.stack(
        [torch.where(sel & (rank == j), buf_i, -1).amax(1)
         for j in range(width)], 1)
    return parents, buf_e | sel


def _merge_step(buf_d, buf_i, buf_e, cand_d, cand_i, itopk: int,
                window: int = 2):
    """Merge the sorted buffer with fresh candidates: a full bitonic sort
    of the concatenation + windowed dedup."""
    m, c = cand_i.shape
    L = _next_pow2(itopk + c)
    all_d = _pad_cols(torch.cat([buf_d, cand_d], 1), L, torch.inf)
    all_i = _pad_cols(torch.cat([buf_i, cand_i], 1), L, -1)
    all_e = _pad_cols(
        torch.cat([buf_e, torch.zeros((m, c), dtype=torch.bool,
                                      device=buf_e.device)], 1), L, True)
    sd, (si, se) = sort_by_key(all_d, all_i, all_e)
    sd, si, se = _window_dedup(sd, si, se, window)
    return sd[:, :itopk], si[:, :itopk], se[:, :itopk]


def _exact_dedup_prefix(fd, fi, k: int):
    """All-pairs id dedup on the sorted prefix, then a resort."""
    L = fi.shape[1]
    P = min(L, _next_pow2(max(2 * k, 16)))
    pi, pd = fi[:, :P], fd[:, :P]
    tri = (torch.arange(P, device=fi.device)[None, :]
           < torch.arange(P, device=fi.device)[:, None])[None]
    dup = ((pi[:, :, None] == pi[:, None, :]) & tri
           & (pi >= 0)[:, :, None]).any(2)
    pd = torch.where(dup, torch.inf, pd)
    pi = torch.where(dup, -1, pi)
    pd, (pi,) = sort_by_key(pd, pi)
    return pd[:, :k], pi[:, :k]


def _side_accumulate(res_d, res_i, dvals, ids, kr: int, window: int = 8):
    """Merge scored candidates into the filtered-search side buffer and
    blank duplicate ids within ``window`` slots."""
    rd, ri = merge_topk(torch.cat([res_d, dvals], 1),
                        torch.cat([res_i, ids.to(res_i.dtype)], 1), kr, True)
    dup = torch.zeros(ri.shape, dtype=torch.bool, device=ri.device)
    for s in range(1, window + 1):
        eq = (ri[:, s:] == ri[:, :-s]) & (ri[:, s:] >= 0)
        dup[:, s:] |= eq
    rd = torch.where(dup, torch.inf, rd)
    ri = torch.where(dup, -1, ri)
    return rd, ri


def _filter_penalty_vector(filter_bits, filter_nbits: int, n: int, scale):
    """Dense per-node penalty [n] f32: 0 where the bit is set, ``scale``
    where filtered (bits past ``filter_nbits`` count as filtered)."""
    w = filter_bits.shape[0]
    shifts = torch.arange(32, dtype=torch.int32, device=filter_bits.device)
    flat = ((filter_bits.to(torch.int32)[:, None] >> shifts) & 1).reshape(
        w * 32)
    if w * 32 < n:
        flat = torch.nn.functional.pad(flat, (0, n - w * 32))
    keep = flat[:n] != 0
    if filter_nbits < n:
        keep &= torch.arange(n, device=keep.device) < filter_nbits
    return torch.where(keep, 0.0, float(scale)).to(torch.float32)


def _finalize(out_d, out_i, q32, metric: DistanceType):
    """Restore the dropped ||q||^2 term / signs and mask invalid slots."""
    ip = metric == DistanceType.InnerProduct
    out_i = torch.where(torch.isinf(out_d), -1, out_i)
    if ip:
        out_d = -out_d
    elif metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded,
                    DistanceType.L2Unexpanded):
        qn = (q32 * q32).sum(1, keepdim=True)
        out_d = torch.clamp_min(out_d + qn, 0.0)
        if metric == DistanceType.L2SqrtExpanded:
            out_d = torch.sqrt(out_d)
    out_d = torch.where(out_i < 0, -torch.inf if ip else torch.inf, out_d)
    return out_d, out_i


def _beam_search(queries, dataset, graph, data_norms, k: int, itopk: int,
                 width: int, iters: int, metric: DistanceType,
                 compute_dtype: str = "f32", n_seeds: int = 0,
                 filter_bits=None, filter_nbits: int = 0):
    """Scattered-gather beam search with exact scoring (the path for an
    index without the inline layout, or a forced compute_dtype)."""
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(
            f"compute_dtype must be f32|bf16, got {compute_dtype!r}")
    ip = metric == DistanceType.InnerProduct
    n = dataset.shape[0]
    deg = graph.shape[1]
    m = queries.shape[0]
    dev = dataset.device
    q32 = queries.float()
    mm = torch.bfloat16 if compute_dtype == "bf16" else torch.float32
    data = dataset.to(mm)
    qmm = q32.to(mm)

    side = filter_nbits > 0
    if side:
        pen = _filter_penalty_vector(filter_bits, filter_nbits, n, torch.inf)
        kr = max(4 * k, 64)
        res_d = torch.full((m, kr), torch.inf, device=dev)
        res_i = torch.full((m, kr), -1, dtype=torch.int32, device=dev)

    def score(ids):                         # [m, c] -> [m, c] (min-close)
        vecs = data[ids.long()]
        dots = (vecs * qmm[:, None, :]).sum(-1, dtype=torch.float32)
        if ip:
            return -dots
        return data_norms[ids.long()] - 2.0 * dots   # ||q||^2 dropped

    if n_seeds <= 0:
        n_seeds = max(2 * itopk, 128)
    seeds = _seed_ids(m, n, n_seeds, dev)
    seed_d = score(seeds)
    buf_d, buf_i, buf_e = _sorted_buffer(seed_d, seeds, itopk)
    if side:
        res_d, res_i = _side_accumulate(res_d, res_i,
                                        seed_d + pen[seeds.long()], seeds,
                                        kr, window=max(8, width))
    for _ in range(iters):
        parents, buf_e = _pick_parents(buf_d, buf_i, buf_e, width)
        nbrs = graph[parents.clamp_min(0).long()].reshape(m, width * deg)
        nbr_d = score(nbrs)
        ok = (parents >= 0)[:, :, None].expand(m, width, deg).reshape(
            m, width * deg)
        nbr_d = torch.where(ok, nbr_d, torch.inf)
        buf_d, buf_i, buf_e = _merge_step(buf_d, buf_i, buf_e, nbr_d, nbrs,
                                          itopk)
        if side:
            res_d, res_i = _side_accumulate(res_d, res_i,
                                            nbr_d + pen[nbrs.long()], nbrs,
                                            kr, window=max(8, width))
    if side:
        fd, fi = res_d, res_i
        LR = _next_pow2(kr)
        fd = torch.where(fi < 0, torch.inf, fd)
    else:
        # sink dedup ghosts (id -1, real distance) below live entries
        fd = torch.where(buf_i < 0, torch.inf, buf_d)
        fi = buf_i
        LR = _next_pow2(itopk)
    fd = _pad_cols(fd, LR, torch.inf)
    fi = _pad_cols(fi, LR, -1)
    fd, (fi,) = sort_by_key(fd, fi)
    fd, fi = _exact_dedup_prefix(fd, fi, k)
    return _finalize(fd, fi, q32, metric)


def _beam_search_packed(queries, dataset, graph, data_norms, nbr_pack,
                        flat_codes, code_scale: float, k: int, itopk: int,
                        width: int, iters: int, metric: DistanceType,
                        n_seeds: int = 0, filter_bits=None,
                        filter_nbits: int = 0, plain: bool = False):
    """Beam search over the packed inline layout: the counterpart of the
    reference's ``_beam_search_pallas``. Seeds are one query-shared slab
    scored by an f32 matmul of the bf16 query and the seeds' int8 codes;
    every step after that is one ``beam_merge_step`` (its plain version
    with ``plain``, the reference's interpret mode); the buffer's first
    R rows are rescored exactly in f32."""
    step = beam_merge_step_plain if plain else beam_merge_step
    ip = metric == DistanceType.InnerProduct
    n, d = dataset.shape
    deg = graph.shape[1]
    m = queries.shape[0]
    dev = dataset.device
    side = filter_nbits > 0
    if side:
        pen = _filter_penalty_vector(filter_bits, filter_nbits, n, torch.inf)
    q32 = queries.float()
    two_scale = (1.0 if ip else 2.0) * float(code_scale)
    qs = (q32 * two_scale).to(torch.bfloat16)

    # ---- shared seed slab: bf16 operands, f32 products and sums
    if n_seeds <= 0:
        n_seeds = max(2 * itopk, 128)
    seed_ids = ((((torch.arange(n_seeds, dtype=torch.int64, device=dev)
                   * 2654435761) + 0x128394) & _MASK32) % n).to(torch.int32)
    sdots = dist_dot(qs, flat_codes[seed_ids.long()].T)       # [m, S]
    if ip:
        seed_d = -sdots
    else:
        seed_d = data_norms[seed_ids.long()][None, :] - sdots
    seed_i = seed_ids[None, :].expand(m, n_seeds)
    if side:
        kr = max(4 * k, 64)
        res_d = torch.full((m, kr), torch.inf, device=dev)
        res_i = torch.full((m, kr), -1, dtype=torch.int32, device=dev)
        res_d, res_i = _side_accumulate(
            res_d, res_i, seed_d + pen[seed_ids.long()][None, :], seed_i, kr)

    buf_d = torch.full((m, itopk), torch.inf, device=dev)
    buf_i = torch.full((m, itopk), -1, dtype=torch.int32, device=dev)
    buf_e = torch.zeros((m, itopk), dtype=torch.int32, device=dev)
    buf_d, buf_i, buf_e, parents = step(
        buf_d, buf_i, buf_e, cand_d=seed_d, cand_i=seed_i, width=width,
        ip=ip)
    for _ in range(iters):
        out = step(buf_d, buf_i, buf_e, qs=qs, nbr_pack=nbr_pack,
                              parents=parents, deg=deg, d=d, width=width,
                              ip=ip, emit_cands=side)
        buf_d, buf_i, buf_e, parents = out[:4]
        if side:
            cd, ci = out[4:]
            vd = cd + pen[ci.clamp_min(0).long()]
            vd = torch.where(ci < 0, torch.inf, vd)
            res_d, res_i = _side_accumulate(res_d, res_i, vd, ci, kr,
                                            window=max(8, width))

    # ---- exact f32 rescore of the buffer prefix
    if side:
        R = kr
        ri = torch.where(torch.isinf(res_d), -1, res_i)
    else:
        R = min(itopk, max(32, _next_pow2(2 * k)))
        ri = buf_i[:, :R]
    rvec = dataset[ri.clamp_min(0).long()].float()            # [m, R, d]
    rdots = (rvec * q32[:, None, :]).sum(-1)
    if ip:
        rd = -rdots
    else:
        rd = (rvec * rvec).sum(-1) - 2.0 * rdots
    rd = torch.where(ri < 0, torch.inf, rd)
    LR = _next_pow2(R)
    rd = _pad_cols(rd, LR, torch.inf)
    ri = _pad_cols(ri, LR, -1)
    rd, (ri,) = sort_by_key(rd, ri)
    rd, ri = _exact_dedup_prefix(rd, ri, k)
    return _finalize(rd, ri, q32, metric)


# the reference's scan_impl names -> the port's routes: "pallas" the packed
# path through the kernel, "pallas_interpret" the packed path through the
# kernel's plain version, "xla" the scattered path
_BEAM_IMPLS = {"pallas": "packed", "pallas_interpret": "packed_plain",
               "xla": "scattered"}


def _resolve_beam_impl(requested: str, index: Index,
                       compute_dtype: str) -> str:
    if requested in ("packed", "scattered"):
        return requested
    name = backend_name(requested)
    if name != "auto":
        return _BEAM_IMPLS[name]
    if index.nbr_pack is None or compute_dtype != "auto":
        return "scattered"
    # the packed traversal is the reference's TPU route; off its
    # accelerator it takes the scattered path, and so does a CPU index here
    return "packed" if index.dataset.is_cuda else "scattered"


def search_plan(search_params: SearchParams, k: int):
    """(itopk, width, iters, n_seeds) from params + k (the reference's
    search_plan, detail/cagra/search_plan.cuh:70)."""
    itopk = max(int(search_params.itopk_size), k)
    width = max(1, int(search_params.search_width))
    n_seeds = int(search_params.n_seeds)
    if n_seeds > 0:
        n_seeds = max(n_seeds, k)   # at least k live candidates to return
    iters = int(search_params.max_iterations)
    if iters <= 0:
        iters = max(1 + itopk // width, 10)
    return itopk, width, iters, n_seeds


def search(search_params: SearchParams, index: Index, queries, k: int,
           prefilter=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched beam search (reference cagra.cuh:299 search) on the
    index's device: the packed path when the index carries the inline
    layout, else the exact scattered path. ``prefilter`` (a Bitset or
    BitsetFilter) restricts RESULTS to set bits; traversal itself stays
    unfiltered (side accumulation, as in the reference)."""
    dev = index.dataset.device
    queries = as_tensor(queries, dev)
    filt = as_filter(prefilter)
    bits = resolve_filter_bits(filt, int(index.size))
    fbits = None if bits is None else bits.bits.to(dev)
    fnbits = 0 if bits is None else int(bits.n_bits)
    itopk, width, iters, n_seeds = search_plan(search_params, k)
    dtype = str(search_params.compute_dtype)
    impl = _resolve_beam_impl(str(search_params.scan_impl), index, dtype)
    if impl in ("packed", "packed_plain"):
        if index.nbr_pack is None:
            raise ValueError(
                "scan_impl='packed' needs the packed inline layout (build "
                "with inline_codes=True; requires dim % 4 == 0)")
        if dtype != "auto":
            raise ValueError(
                "scan_impl='packed' scores int8 traversal distances; "
                f"compute_dtype must stay 'auto' (got {dtype!r})")
        return _beam_search_packed(
            queries, index.dataset, index.graph, index.data_norms,
            index.nbr_pack, index.flat_codes, index.code_scale, int(k),
            itopk, width, iters, index.metric, n_seeds, fbits, fnbits,
            plain=impl == "packed_plain")
    return _beam_search(
        queries, index.dataset, index.graph, index.data_norms, int(k),
        itopk, width, iters, index.metric,
        "f32" if dtype == "auto" else dtype, n_seeds, fbits, fnbits)


# ---------------------------------------------------------------------------
# serialize (reference detail/cagra/cagra_serialize.cuh)
# ---------------------------------------------------------------------------


def save(path: str, index: Index) -> None:
    """Write the index file the reference writes (dataset + graph; the
    inline layout is rebuilt on load)."""
    write_index_file(
        path, "cagra", _SERIAL_VERSION,
        {"metric": int(index.metric),
         "inline_codes": index.nbr_pack is not None},
        {"dataset": index.dataset.cpu().numpy(),
         "graph": index.graph.cpu().numpy()})


def load(path: str, device=None) -> Index:
    """Read an index file written by either package onto ``device``
    (default: the CUDA card)."""
    _, meta, arrays = read_index_file(path, "cagra")
    return from_graph(arrays["dataset"], arrays["graph"],
                      DistanceType(meta["metric"]),
                      inline_codes=bool(meta.get("inline_codes", True)),
                      device=device)
