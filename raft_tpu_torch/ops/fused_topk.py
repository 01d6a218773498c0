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
matrix: each block keeps its queries' top-k over one chunk of rows and
writes a [m, n_chunks * k] candidate buffer that ``merge_topk`` reduces,
as the reference merges its per-tile buffers (``fused_topk.py:255-258``).
What bounds it on the H100 and what the design does about it is in the
source's header. The reference's ``fold`` arm is not ported (ROADMAP.md).

On a CUDA tensor :func:`fused_knn_topk` launches the kernel or raises; on a
CPU tensor it runs :func:`fused_knn_topk_plain`; nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.neighbors.common import blocked_topk, merge_topk
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


def _check(queries, dataset, k, metric_kind):
    if queries.dim() != 2 or dataset.dim() != 2 or \
            queries.shape[1] != dataset.shape[1]:
        raise ValueError(f"bad shapes {tuple(queries.shape)} vs "
                         f"{tuple(dataset.shape)}")
    if metric_kind not in (L2, IP, COSINE):
        raise ValueError(f"metric_kind must be L2|IP|COSINE, got {metric_kind}")
    if not 0 < k <= min(K_MAX, dataset.shape[0]):
        raise ValueError(f"k={k} out of range (1..min({K_MAX}, n))")


def fused_knn_topk(queries: torch.Tensor, dataset: torch.Tensor, k: int, *,
                   metric_kind: int, norms: Optional[torch.Tensor] = None,
                   qaux: Optional[torch.Tensor] = None,
                   keep: Optional[torch.Tensor] = None,
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact KNN in min-space: (dist [m, k] f32, idx [m, k] int32),
    best-first. ``norms`` [n] = ||x||^2 and ``qaux`` [m] (||q||^2 for L2,
    ||q|| for cosine) default to the operands' own; ``keep`` [n] (nonzero
    = eligible) filters rows."""
    _check(queries, dataset, k, metric_kind)
    if queries.device.type == "cpu":
        return fused_knn_topk_plain(queries, dataset, k,
                                    metric_kind=metric_kind, norms=norms,
                                    qaux=qaux, keep=keep)
    if not queries.is_cuda:
        raise ValueError(f"fused_knn_topk takes CPU or CUDA tensors, got "
                         f"{queries.device}")
    cand_d, cand_i = _launch(queries, dataset, int(k), metric_kind, norms,
                             qaux, keep)
    return merge_topk(cand_d, cand_i, int(k), select_min=True)


fused_knn_topk.launches = 0


def _launch(queries, dataset, k, metric_kind, norms, qaux, keep):
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
    xn = _norms(x, metric_kind, bf16, norms)
    qa = _aux(q32, metric_kind, qaux)
    if xn is not None:
        xn = xn.to(device=dev, dtype=torch.float32).contiguous()
        qa = qa.to(device=dev, dtype=torch.float32).contiguous()
    kp = None
    if keep is not None:
        kp = keep.to(device=dev, dtype=torch.int32).contiguous()
    # rows per block: whole tiles, enough chunks for ~_TARGET_BLOCKS blocks
    want = max(1, min(cdiv(n, _RT), cdiv(_TARGET_BLOCKS, cdiv(m, _QT))))
    chunk_rows = round_up_to_multiple(cdiv(n, want), _RT)
    n_chunks = cdiv(n, chunk_rows)
    out_d = torch.empty((m, n_chunks * k), dtype=torch.float32, device=dev)
    out_i = torch.empty((m, n_chunks * k), dtype=torch.int32, device=dev)

    lib = _build.load("fused_knn_topk")
    fn = lib.fused_knn_topk
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 8
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(q32), ptr(qa), ptr(x), int(x.dtype == torch.bfloat16),
                ptr(xn), ptr(kp), m, n, d, k, chunk_rows, n_chunks,
                int(metric_kind), int(bf16), ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "fused_knn_topk", rc)
    fused_knn_topk.launches += 1
    return out_d, out_i


def fused_knn_topk_plain(queries: torch.Tensor, dataset: torch.Tensor,
                         k: int, *, metric_kind: int,
                         norms: Optional[torch.Tensor] = None,
                         qaux: Optional[torch.Tensor] = None,
                         keep: Optional[torch.Tensor] = None,
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: dense distance blocks
    merged into a running top-k (``blocked_topk``, ties to the lower
    column)."""
    _check(queries, dataset, k, metric_kind)
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

    return blocked_topk(block, dataset.shape[0], k, keep=keep)


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
