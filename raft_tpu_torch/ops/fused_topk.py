"""Fused brute-force distance + top-k: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/fused_topk.py:_fused_kernel`` (``pallas_call`` at
:304, exact arm). What it computes is the reference's: for each query, the
k nearest rows in min-space — L2 ``max(||q||^2 + ||x||^2 - 2 q.x, 0)``,
inner product ``-q.x``, cosine ``1 - q.x / max(||q|| ||x||, 1e-30)`` —
with f32 accumulation, ties to the lower column, and rows short of k valid
candidates padded with (+inf, -1). Operands follow the queries' type, as
the reference's brute force does (``brute_force.py:231-238``): bf16
queries round both operands to bf16; f32 queries meet f32 or bf16 rows
unrounded (bf16 rows widen exactly). Products are exact in f32 either way
for bf16 pairs, and summed in f32.

The kernel (``csrc/fused_knn_topk.cu``) never writes the [m, n] distance
matrix: each block keeps its queries' candidates over one chunk of rows
and writes them to a candidate buffer that ``merge_topk`` reduces, as the
reference merges its per-tile buffers (``fused_topk.py:255-258``). What
bounds it on the H100 and what the design does about it is in the
source's header. Two arms (``variant``), the reference's:

* "exact": a block's exact top-k of its chunk, a [m, n_chunks * k]
  buffer (the port's own chunks; k <= 256);
* "fold" (``_extract_fold`` :102): the rows are cut into tiles of
  ``tile_n`` (a multiple of 128; default :func:`tile_geometry`'s), and in
  each tile each of the 128 lanes (column mod 128) keeps its R =
  :func:`fold_depth` smallest (distance, column) pairs by the compare-swap
  cascade of :func:`fold_lane_stacks`, written out unextracted — slot
  (r, lane) of tile j at column ``j 128 R + r 128 + lane`` of a
  [m, n_tiles * 128 R] buffer, id -1 where +inf. A true neighbour is lost
  only where more than R of a tile's top-k share a lane; the exact merge
  keeps everything else (k <= 256).

The fold arm has two CUDA bodies: the shared core's
(``csrc/scan_topk.cuh``, f32 dots on the CUDA cores, the stacks in shared
memory), and one designed for Hopper (``csrc/fused_fold_hopper.cuh``:
``wgmma`` distance tiles of 128 queries (64 at R = 3 and 4) x 128 rows
from shared memory, the lane stacks in registers). :func:`fold_body`
routes by shape and type: bf16 queries (which round f32 rows; bf16 rows
as stored) with d a multiple of 16 whose block fits
(:func:`fold_smem_bytes`: d <= 288 at R = 2, 352 at R = 3 and 4) and
tiles of at most 2048 rows take the Hopper body; f32 queries, other
widths and wider tiles keep the core's. The Hopper body sums each dot's
exact bf16 products in another order than the plain version, so it is
bit for bit the plain version only where every partial sum is exact.

The exact arm has two CUDA bodies as well: the shared core's
(``fused_knn_topk.cu``, kExact) and one designed for Hopper
(``csrc/fused_exact_hopper.cuh``: 128 queries a block, a cp.async ring of
64-row tiles, each (query, row) under the query's k-th distance buffered
and merged by warps). :func:`exact_body` routes f32 or bf16 queries over
f32 or bf16 rows with d a multiple of 16 up to 128 and k <= 64 to it;
other types, widths and k keep the core. Under bf16 queries its dots are
the fold body's ``wgmma`` bf16 tiles (exact products, f32 sums in another
order); under f32 queries they are 3xTF32 on the tensor cores (each
operand split into hi = tf32(v) and lo = tf32(v - hi), hi.hi + hi.lo +
lo.hi with f32 sums, each 16 dims' products added to the dot at round to
nearest), which keeps f32 accuracy: bit for bit the plain version where
every partial sum is exact, and otherwise its sums' rounding in another
order. Its chunks of rows are chosen so the grid fills the card's SMs
(:func:`exact_chunk_rows`).

On a CUDA tensor :func:`fused_knn_topk` (and :func:`fused_knn_fold`, the
fold's unmerged buffer) launches the kernel or raises; on a CPU tensor it
runs the plain version; nothing else. Its ``launches`` counts every
launch and ``by_body`` splits them by body ("core", "fold_hopper",
"exact_hopper").
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.neighbors.common import BLOCK_ROWS, blocked_topk, \
    merge_topk
from raft_tpu_torch.ops import _build
from raft_tpu_torch.utils.math import cdiv, round_up_to_multiple
from raft_tpu_torch.utils.precision import dist_dot, round_bf16

# metric_kind values, shared with ops.ivf_scan and the reference kernels
L2 = 0        # dist = ||q||^2 + ||x||^2 - 2 q.x  (norms = ||x||^2, qaux = ||q||^2)
IP = 1        # dist = -q.x (caller negates back)
COSINE = 2    # dist = 1 - q.x / (||q|| ||x||)  (norms = ||x||^2, qaux = ||q||)

K_MAX = 256          # the kernel's per-block top-k capacity
_QT = 64             # queries per block (csrc/scan_topk.cuh QT)
_RT = 64             # rows per tile (csrc/scan_topk.cuh RT)
_TARGET_BLOCKS = 2048
# a block's shared memory on the H100, and the Hopper fold body's block
# (csrc/fused_fold_hopper.cuh): 128 queries at R = 2, else 64, and 2 ring
# stages of 128-row bf16 chunks with their norms and keep flags; chunk
# ids in 4 bits, so at most 16 chunks a tile
SMEM_LIMIT = 232_448
_FOLDH_C, _FOLDH_STAGES, _FOLDH_MAX_TILE = 128, 2, 2048
# the Hopper exact body's block (csrc/fused_exact_hopper.cuh): 64-row
# tiles in 2 to 6 ring stages with their norms and keep flags, k <= 64, d
# <= 128
_EXH_T, _EXH_STAGES, _EXH_KMAX, _EXH_DMAX = 64, 6, 64, 128
_EXH_SIDE = 2 * _EXH_T * 4
_EXH_STATIC = 2 * _EXH_STAGES * 8     # the ring's mbarriers


def _operands(queries: torch.Tensor):
    """(f32 queries, whether the compute type is bf16): bf16 iff the
    queries are bf16."""
    return queries.float(), queries.dtype == torch.bfloat16


def _aux(q32: torch.Tensor, metric_kind: int, qaux):
    if metric_kind == IP or qaux is not None:
        return qaux
    qn = (q32 * q32).sum(1)
    return qn if metric_kind == L2 else torch.sqrt(qn)


def _norms(x: torch.Tensor, metric_kind: int, bf16: bool, norms):
    if metric_kind == IP or norms is not None:
        return norms
    x32 = round_bf16(x.float()) if bf16 else x.float()
    return (x32 * x32).sum(1)


# the per-core VMEM the reference's tile geometry budgets for (16 MB)
_VMEM_BYTES = 16 * 1024 * 1024


def fold_depth(k: int) -> int:
    """Lane-stack depth R of the fold arm (``fused_topk.py:184``):
    ceil(k / 64), at least 2."""
    return max(2, -(-int(k) // 64))


def candidate_width(k: int, variant: str) -> int:
    """A tile's candidate-buffer width: k for "exact", 128 R for "fold"
    (``fused_topk.py:174``)."""
    if variant == "fold":
        return 128 * fold_depth(k)
    return int(k)


def tile_geometry(m: int, n: int, d: int, k: int, variant: str,
                  itemsize: int = 2) -> dict:
    """The reference's analytic tile geometry (``fused_topk.py:146-169``),
    verbatim: the query tile, and the row tile halved from 2048 (to 256 at
    least) until queries, rows, the f32 distance tile and the candidate
    buffers fit half of a TPU core's VMEM. The fold arm folds the rows of
    one such row tile together, so the port keeps its ``tile_n``."""
    floor = {1: 32, 2: 16}.get(int(itemsize), 8)
    tile_q = 128 if m >= 128 else max(
        floor, 1 << (max(m - 1, 1)).bit_length())
    cand = candidate_width(k, variant)
    budget = _VMEM_BYTES // 2
    tile_n = 2048
    while tile_n > 256:
        used = (tile_q * d * itemsize + tile_n * d * itemsize
                + 4 * tile_q * tile_n + 8 * tile_q * cand)
        if used <= budget:
            break
        tile_n //= 2
    return {"tile_q": int(tile_q), "tile_n": int(tile_n)}


def fold_lane_stacks(dist: torch.Tensor, ids: torch.Tensor, R: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold's R-deep lane stacks (``fused_topk.py:76-99``) over
    distances ``dist`` [..., T] (T a multiple of 128) with ``ids`` of the
    same shape: lane b keeps its R smallest (distance, id) pairs, filled
    chunk by chunk in column order by a compare-swap cascade with a strict
    ``<`` (a newcomer enters at the first level it beats, the slot it
    displaces goes on down; equal distances do not keep column order).
    Returns (stack_d, stack_i) [..., R, 128], +inf / -1 where unfilled."""
    chunks = dist.shape[-1] // 128
    nd_all = dist.unflatten(-1, (chunks, 128))
    ni_all = ids.unflatten(-1, (chunks, 128))
    shape = nd_all.shape[:-2] + (128,)
    sd = [torch.full(shape, float("inf"), dtype=dist.dtype,
                     device=dist.device)] * R
    si = [torch.full(shape, -1, dtype=ids.dtype, device=ids.device)] * R
    for c in range(chunks):
        nd, ni = nd_all[..., c, :], ni_all[..., c, :]
        for r in range(R):
            swap = nd < sd[r]
            sd[r], nd = torch.where(swap, nd, sd[r]), torch.where(swap, sd[r],
                                                                 nd)
            si[r], ni = torch.where(swap, ni, si[r]), torch.where(swap, si[r],
                                                                 ni)
    return torch.stack(sd, -2), torch.stack(si, -2)


def fold_block_queries(k: int) -> int:
    """Queries a Hopper fold block holds: 128 at R = 2, else 64."""
    return 128 if fold_depth(k) == 2 else 64


def fold_smem_bytes(d: int, k: int) -> int:
    """Dynamic shared memory of one Hopper fold block at width ``d`` and
    ``k``: its bf16 queries (:func:`fold_block_queries`) and two ring
    stages of a 128-row bf16 chunk with its 128 norms and keep flags
    (100,352 B at d = 128, R = 2)."""
    return ((fold_block_queries(k) + _FOLDH_STAGES * _FOLDH_C) * int(d) * 2
            + _FOLDH_STAGES * 2 * _FOLDH_C * 4)


def fold_body(queries_dtype: torch.dtype, d: int, tile_n: int,
              k: int) -> str:
    """The body a fold launch at ``k`` takes: "fold_hopper"
    (``csrc/fused_fold_hopper.cuh``) for bf16 queries (the operands'
    compute type; f32 rows are rounded as they are staged) with ``d`` a
    multiple of 16 whose block fits a block's shared memory
    (:func:`fold_smem_bytes`) and ``tile_n`` <= 2048 (chunk ids in 4
    bits); else "core" (the shared core's kFold2..4)."""
    if queries_dtype != torch.bfloat16 or int(d) % 16 or \
            int(tile_n) > _FOLDH_MAX_TILE or \
            fold_smem_bytes(d, k) > SMEM_LIMIT:
        return "core"
    return "fold_hopper"


def exact_row_bytes(bf16_ops: bool, x_bf16: bool, d: int) -> int:
    """Bytes of a row in a ring stage of the Hopper exact body: bf16
    operands' bf16 rows (f32 ones rounded as staged); f32 operands' f32
    rows, or bf16 rows padded to 8 words mod 32 (d a multiple of 32)."""
    d = int(d)
    if bf16_ops:
        return 2 * d
    if x_bf16:
        return 2 * d + (32 if d % 32 == 0 else 0)
    return 4 * d


def exact_smem_bytes(bf16_ops: bool, x_bf16: bool, d: int, k: int,
                     q: int, ns: int) -> int:
    """Dynamic shared memory of a Hopper exact block of ``q`` queries and
    ``ns`` ring stages: the queries (bf16 or f32), the stages of 64 rows
    with their norms and keep flags, the candidate buffer (q x 64 of an
    f32 distance and a row byte, q counts) and the lists (q k of f32 and
    int32)."""
    return (q * int(d) * (2 if bf16_ops else 4)
            + ns * (_EXH_T * exact_row_bytes(bf16_ops, x_bf16, d)
                    + _EXH_SIDE)
            + q * _EXH_T * 5 + q * 4 + q * int(k) * 8)


def exact_block_queries(bf16_ops: bool, x_bf16: bool, d: int, k: int) -> int:
    """Queries a Hopper exact block holds: 128 where that block fits with
    two ring stages, else 64 (f32 rows under f32 queries past k 57 at d
    128)."""
    return 128 if exact_smem_bytes(bf16_ops, x_bf16, d, k, 128, 2) + \
        _EXH_STATIC <= SMEM_LIMIT else 64


def exact_ring_stages(bf16_ops: bool, x_bf16: bool, d: int, k: int,
                      q: int) -> int:
    """Ring stages of a Hopper exact block of ``q`` queries: as many as
    fit, 6 at most and 2 at least (3 for the f32 oracle at d 128, k 10;
    6 under bf16 operands at k 42)."""
    ns = _EXH_STAGES
    while ns > 2 and exact_smem_bytes(bf16_ops, x_bf16, d, k, q, ns) + \
            _EXH_STATIC > SMEM_LIMIT:
        ns -= 1
    return ns


def exact_body(queries_dtype: torch.dtype, rows_dtype: torch.dtype, d: int,
               k: int) -> str:
    """The body an exact launch takes: "exact_hopper"
    (``csrc/fused_exact_hopper.cuh``) for f32 or bf16 queries (the
    operands' compute type: bf16 queries round f32 rows) over f32 or bf16
    rows with ``d`` a multiple of 16 up to 128 and ``k`` <= 64; else
    "core" (the shared core's kExact)."""
    types = (torch.float32, torch.bfloat16)
    if queries_dtype not in types or rows_dtype not in types or \
            int(d) % 16 or not 0 < int(d) <= _EXH_DMAX or \
            not 0 < int(k) <= _EXH_KMAX:
        return "core"
    return "exact_hopper"


def exact_chunk_rows(m: int, n: int, block_q: int, sms: int) -> int:
    """Rows a chunk (a multiple of 64) of a Hopper exact launch: the
    fewest chunks (each a block per query tile, one block an SM) whose
    grid fills at least 95% of its last wave of ``sms`` blocks, else the
    best fill, at most 64 chunks of at least 8 tiles each. Fewer chunks
    mean fewer candidates to merge, and each (query, chunk)'s list fills
    once: 16 chunks at 1,000 queries on 132 SMs, 5 at 10,000."""
    q_tiles = cdiv(m, block_q)
    c_max = max(1, min(64, int(n) // (8 * _EXH_T)))
    best, best_fill = 1, 0.0
    for c in range(1, c_max + 1):
        blocks = q_tiles * c
        fill = blocks / (cdiv(blocks, sms) * sms)
        if fill >= 0.95:
            best = c
            break
        if fill > best_fill:
            best, best_fill = c, fill
    return round_up_to_multiple(cdiv(n, best), _EXH_T)


def _check(queries, dataset, k, metric_kind, variant="exact", tile_n=None):
    if queries.dim() != 2 or dataset.dim() != 2 or \
            queries.shape[1] != dataset.shape[1]:
        raise ValueError(f"bad shapes {tuple(queries.shape)} vs "
                         f"{tuple(dataset.shape)}")
    if metric_kind not in (L2, IP, COSINE):
        raise ValueError(f"metric_kind must be L2|IP|COSINE, got {metric_kind}")
    if not 0 < k <= min(K_MAX, dataset.shape[0]):
        raise ValueError(f"k={k} out of range (1..min({K_MAX}, n))")
    if variant not in ("exact", "fold"):
        raise ValueError(f"variant must be 'exact'|'fold', got {variant!r}")
    if variant == "fold" and int(tile_n) % 128:
        raise ValueError(f"variant='fold' needs tile_n % 128 == 0 (the lane "
                         f"fold covers tile_n // 128 chunks), got tile_n="
                         f"{tile_n}")


def _fold_tile(queries, dataset, k, tile_n):
    """The fold's row tile: ``tile_n``, or the analytic geometry's at the
    queries' operand width."""
    if tile_n is not None:
        return int(tile_n)
    m, d = queries.shape
    itemsize = 2 if queries.dtype == torch.bfloat16 else 4
    return tile_geometry(m, dataset.shape[0], d, k, "fold",
                         itemsize)["tile_n"]


def fused_knn_topk(queries: torch.Tensor, dataset: torch.Tensor, k: int, *,
                   metric_kind: int, norms: Optional[torch.Tensor] = None,
                   qaux: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None,
                   variant: str = "exact", tile_n: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """KNN in min-space: (dist [m, k] f32, idx [m, k] int32), best-first.
    ``norms`` [n] = ||x||^2 and ``qaux`` [m] (||q||^2 for L2, ||q|| for
    cosine) default to the operands' own; ``keep`` [n] (nonzero =
    eligible) filters rows. ``variant`` "exact" or "fold" with its row
    tile ``tile_n`` (module docstring; the exact arm chooses its own
    chunks)."""
    if variant == "fold":
        tile_n = _fold_tile(queries, dataset, k, tile_n)
    _check(queries, dataset, k, metric_kind, variant, tile_n)
    if queries.device.type == "cpu":
        return fused_knn_topk_plain(queries, dataset, k,
                                    metric_kind=metric_kind, norms=norms,
                                    qaux=qaux, keep=keep, variant=variant,
                                    tile_n=tile_n)
    if not queries.is_cuda:
        raise ValueError(f"fused_knn_topk takes CPU or CUDA tensors, got "
                         f"{queries.device}")
    cand_d, cand_i = _launch(queries, dataset, int(k), metric_kind, norms,
                             qaux, keep, variant, tile_n)
    return merge_topk(cand_d, cand_i, int(k), select_min=True)


fused_knn_topk.launches = 0
fused_knn_topk.by_body = {"core": 0, "fold_hopper": 0, "exact_hopper": 0}


def fused_knn_fold(queries: torch.Tensor, dataset: torch.Tensor, k: int, *,
                   metric_kind: int, norms: Optional[torch.Tensor] = None,
                   qaux: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None,
                   tile_n: Optional[int] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold arm's unmerged buffer (dist, idx) [m, n_tiles * 128 R]
    (module docstring): the kernel on a CUDA tensor (its launch counts on
    :func:`fused_knn_topk`), :func:`fused_knn_fold_plain` on a CPU one."""
    tile_n = _fold_tile(queries, dataset, k, tile_n)
    _check(queries, dataset, k, metric_kind, "fold", tile_n)
    if queries.device.type == "cpu":
        return fused_knn_fold_plain(queries, dataset, k,
                                    metric_kind=metric_kind, norms=norms,
                                    qaux=qaux, keep=keep, tile_n=tile_n)
    if not queries.is_cuda:
        raise ValueError(f"fused_knn_fold takes CPU or CUDA tensors, got "
                         f"{queries.device}")
    return _launch(queries, dataset, int(k), metric_kind, norms, qaux, keep,
                   "fold", tile_n)


def _count(body: str) -> None:
    # counted on the module attribute, which a stand-in may replace
    counted = fused_knn_topk
    counted.launches += 1
    by_body = getattr(counted, "by_body", None)
    if by_body is not None:
        by_body[body] = by_body.get(body, 0) + 1


def _launch(queries, dataset, k, metric_kind, norms, qaux, keep,
            variant="exact", tile_n=None):
    dev = queries.device
    if dataset.device != dev:
        raise ValueError("queries and dataset must be on the same device")
    m, d = queries.shape
    n = dataset.shape[0]
    q32, bf16 = _operands(queries)
    q32 = q32.contiguous()
    x = dataset if dataset.dtype in (torch.float32, torch.bfloat16) \
        else dataset.float()
    x = x.contiguous()
    body = (fold_body(queries.dtype, d, tile_n, k) if variant == "fold"
            else exact_body(queries.dtype, dataset.dtype, d, k))
    xn = _norms(x, metric_kind, bf16, norms)
    qa = _aux(q32, metric_kind, qaux)
    if xn is not None:
        xn = xn.to(device=dev, dtype=torch.float32).contiguous()
        qa = qa.to(device=dev, dtype=torch.float32).contiguous()
    kp = None
    if keep is not None:
        kp = keep.to(device=dev, dtype=torch.int32).contiguous()
    if body == "fold_hopper":
        return _launch_fold_hopper(queries, x, xn, qa, kp, k, metric_kind,
                                   tile_n)
    if body == "exact_hopper":
        return _launch_exact_hopper(queries if bf16 else q32, x, xn, qa, kp,
                                    k, metric_kind, bf16)
    if variant == "fold":
        # a block per (64 queries, row tile), writing 128 R slots a query
        fold_r = fold_depth(k)
        chunk_rows = int(tile_n)
        n_chunks = cdiv(n, chunk_rows)
        width = n_chunks * 128 * fold_r
    else:
        # rows per block: whole tiles, enough chunks for ~_TARGET_BLOCKS
        fold_r = 0
        want = max(1, min(cdiv(n, _RT), cdiv(_TARGET_BLOCKS, cdiv(m, _QT))))
        chunk_rows = round_up_to_multiple(cdiv(n, want), _RT)
        n_chunks = cdiv(n, chunk_rows)
        width = n_chunks * k
    out_d = torch.empty((m, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, width), dtype=torch.int32, device=dev)

    lib = _build.load("fused_knn_topk")
    fn = lib.fused_knn_topk
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 9
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(q32), ptr(qa), ptr(x), int(x.dtype == torch.bfloat16),
                ptr(xn), ptr(kp), m, n, d, k, chunk_rows, n_chunks,
                int(metric_kind), int(bf16), fold_r, ptr(out_d), ptr(out_i),
                stream)
    _build.check(lib, "fused_knn_topk", rc)
    _count("core")
    return out_d, out_i


def _launch_fold_hopper(queries, x, xn, qa, kp, k, metric_kind, tile_n):
    """The fold through the Hopper body (:func:`fold_body`): bf16 queries
    as given, rows as stored (bf16) or f32 (rounded as staged)."""
    dev = queries.device
    m, d = queries.shape
    n = x.shape[0]
    fold_r = fold_depth(k)
    n_tiles = cdiv(n, int(tile_n))
    width = n_tiles * 128 * fold_r
    q = _build.aligned(queries.contiguous())
    x, xn, kp = _build.aligned(x), _build.aligned(xn), _build.aligned(kp)
    out_d = torch.empty((m, width), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, width), dtype=torch.int32, device=dev)

    lib = _build.load("fused_knn_topk")
    fn = lib.fused_knn_fold_hopper
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(q), ptr(qa), ptr(x), int(x.dtype == torch.bfloat16),
                ptr(xn), ptr(kp), m, n, d, int(tile_n), n_tiles,
                int(metric_kind), fold_r, ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "fused_knn_fold_hopper", rc)
    _count("fold_hopper")
    return out_d, out_i


def _launch_exact_hopper(queries, x, xn, qa, kp, k, metric_kind, bf16):
    """The exact arm through the Hopper body (:func:`exact_body`): bf16
    queries over bf16 rows or f32 ones (rounded as staged), or f32 queries
    over f32 or bf16 rows (3xTF32), in chunks of :func:`exact_chunk_rows`
    rows."""
    dev = queries.device
    m, d = queries.shape
    n = x.shape[0]
    x_bf16 = x.dtype == torch.bfloat16
    bq = exact_block_queries(bf16, x_bf16, d, k)
    ns = exact_ring_stages(bf16, x_bf16, d, k, bq)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    chunk_rows = exact_chunk_rows(m, n, bq, sms)
    n_chunks = cdiv(n, chunk_rows)
    q = _build.aligned(queries.contiguous())
    x, xn, kp = _build.aligned(x), _build.aligned(xn), _build.aligned(kp)
    out_d = torch.empty((m, n_chunks * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, n_chunks * k), dtype=torch.int32, device=dev)

    lib = _build.load("fused_knn_topk")
    fn = lib.fused_knn_exact_hopper
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 10
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(q), ptr(qa), ptr(x), int(x_bf16), ptr(xn), ptr(kp), m,
                n, d, k, chunk_rows, n_chunks, int(metric_kind), int(bf16),
                bq, ns, ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "fused_knn_exact_hopper", rc)
    _count("exact_hopper")
    return out_d, out_i


def _distance_blocks(queries, dataset, metric_kind, norms, qaux):
    """The kernel's distances as a function of a column range: (c0, c1) ->
    [m, c1 - c0] f32 in min-space."""
    q32, bf16 = _operands(queries)
    xn = _norms(dataset, metric_kind, bf16, norms)
    qa = _aux(q32, metric_kind, qaux)

    def block(c0: int, c1: int) -> torch.Tensor:
        xb = dataset[c0:c1].float()
        if bf16:
            xb = round_bf16(xb)
        return _epilogue(dist_dot(q32, xb.T), metric_kind,
                         None if qa is None else qa[:, None],
                         None if xn is None else xn[None, c0:c1])

    return block


def fused_knn_topk_plain(queries: torch.Tensor, dataset: torch.Tensor,
                         k: int, *, metric_kind: int,
                         norms: Optional[torch.Tensor] = None,
                         qaux: Optional[torch.Tensor] = None,
                         keep: Optional[torch.Tensor] = None,
                         variant: str = "exact",
                         tile_n: Optional[int] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: for "exact", dense distance
    blocks merged into a running top-k (``blocked_topk``, ties to the
    lower column); for "fold", :func:`fused_knn_fold_plain`'s buffer
    merged by ``merge_topk``."""
    if variant == "fold":
        cand_d, cand_i = fused_knn_fold_plain(
            queries, dataset, k, metric_kind=metric_kind, norms=norms,
            qaux=qaux, keep=keep, tile_n=tile_n)
        return merge_topk(cand_d, cand_i, int(k), select_min=True)
    _check(queries, dataset, k, metric_kind)
    block = _distance_blocks(queries, dataset, metric_kind, norms, qaux)
    return blocked_topk(block, dataset.shape[0], k, keep=keep)


def fused_knn_fold_plain(queries: torch.Tensor, dataset: torch.Tensor,
                         k: int, *, metric_kind: int,
                         norms: Optional[torch.Tensor] = None,
                         qaux: Optional[torch.Tensor] = None,
                         keep: Optional[torch.Tensor] = None,
                         tile_n: Optional[int] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The fold kernel's unmerged buffer in plain PyTorch: distance blocks
    of whole row tiles, padded and filtered-out columns +inf, folded by
    :func:`fold_lane_stacks` and laid out as the module docstring says."""
    tile_n = _fold_tile(queries, dataset, k, tile_n)
    _check(queries, dataset, k, metric_kind, "fold", tile_n)
    n = dataset.shape[0]
    R = fold_depth(k)
    block = _distance_blocks(queries, dataset, metric_kind, norms, qaux)
    step = tile_n * max(1, BLOCK_ROWS // tile_n)
    out_d, out_i = [], []
    for c0 in range(0, n, step):
        c1 = min(n, c0 + step)
        dist = block(c0, c1)
        if keep is not None:
            dist = torch.where(keep[c0:c1].to(dist.device)[None, :] > 0,
                               dist, float("inf"))
        pad = round_up_to_multiple(c1 - c0, tile_n) - (c1 - c0)
        dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf"))
        col = torch.arange(c0, c0 + dist.shape[1], dtype=torch.int32,
                           device=dist.device).expand_as(dist)
        tiles = (dist.shape[0], dist.shape[1] // tile_n, tile_n)
        sd, si = fold_lane_stacks(dist.reshape(tiles), col.reshape(tiles), R)
        out_d.append(sd.flatten(1))
        out_i.append(torch.where(torch.isinf(sd), -1, si).flatten(1))
    return torch.cat(out_d, 1), torch.cat(out_i, 1)


def _epilogue(dots: torch.Tensor, metric_kind: int, qaux, norms):
    """Min-space distances from f32 dots — the kernels' epilogue. ``qaux``
    (per query) and ``norms`` (per row) come shaped to broadcast against
    ``dots``; both are None for inner product."""
    if metric_kind == L2:
        return torch.clamp_min(qaux + norms - 2.0 * dots, 0.0)
    if metric_kind == IP:
        return -dots
    plen = torch.sqrt(torch.clamp_min(norms, 1e-30))
    return 1.0 - dots / torch.clamp_min(qaux * plen, 1e-30)
