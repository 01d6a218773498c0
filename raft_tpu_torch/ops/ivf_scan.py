"""IVF list scan + per-list top-k: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/ivf_scan.py:_scan_kernel`` (``pallas_call`` at
:547): the float-storage arm and the int8 rows that its float branch
widens (:302-308, IVF-PQ's decoded-residual cache), with exact
extraction. One step per bucket — one query group against one inverted
list: the list is found through ``bucket_list[b]``, ``dots = q . row``
with f32 accumulation, the L2 / inner-product / cosine epilogue in
min-space, columns past ``list_sizes[l]`` or with ``keep == 0`` masked,
and each query's top-k (ties to the lower list position) emitted with the
**stored global ids** read from the list's id row. Tails come back as
(+inf, -1).

The reference takes the query group pre-gathered as ``qv`` [nb, G, d] and
``qaux`` [nb, G]; here the kernel gathers queries itself through
``bucket_q`` [nb, G] (-1 = empty slot) from ``queries`` [m, d] and
``qaux`` [m] — at the SIFT-1M main path the pre-gathered copy would be a
233 MB write and read per batch. Empty slots come back as (+inf, -1) (the
reference scans query 0 there; the caller never reads those slots).

Operands. ``compute_dtype`` "bf16" rounds both operands to bf16 (the
reference's bf16 compute); "f32" multiplies f32 queries by the rows
widened exactly (f32, bf16 or int8 rows). The default follows the queries'
type, as the reference's ``qv.dtype`` does.

Residual queries (IVF-PQ, ``ivf_pq.py:2043-2062``). With ``centers``
[C, d] the staged query of a bucket on list ``l`` is
``(queries[q] - centers[l]) * scale`` and ``qaux`` is the kernel's own
``||queries[q] - centers[l]||^2`` of the unscaled f32 residual, summed
over components in order (L2 only); inner product passes ``scale`` alone
(``queries[q] * scale``). The kernel builds these while it stages, so the
[nb, G, d] residual slab never exists.

On a CUDA tensor :func:`ivf_list_scan_topk` launches
``csrc/ivf_list_scan_topk.cu`` or raises; on a CPU tensor it runs
:func:`ivf_list_scan_topk_plain`; nothing else. The packed storage arms
(i4, pq4, RaBitQ bits) and the binned / fold extractions are not ported
(ROADMAP.md, Queue B).
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.neighbors.common import merge_topk
from raft_tpu_torch.ops import _build
from raft_tpu_torch.ops.fused_topk import COSINE, IP, K_MAX, L2, _epilogue
from raft_tpu_torch.utils.precision import dist_dot, round_bf16

_PLAIN_BUCKETS = 64     # buckets per plain-version batch
# storage dtype -> the kernel's storage_kind
_STORAGE_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, compute_dtype, k_max):
    if storage.dim() != 3:
        raise ValueError(f"storage must be [C, cap, d], got "
                         f"{tuple(storage.shape)}")
    if storage.dtype not in _STORAGE_KIND:
        raise ValueError(f"storage must be f32, bf16 or int8, got "
                         f"{storage.dtype}")
    C, cap, d = storage.shape
    if tuple(indices.shape) != (C, cap) or tuple(list_sizes.shape) != (C,):
        raise ValueError("indices must be [C, cap] and list_sizes [C]")
    if bucket_q.dim() != 2 or bucket_q.shape[0] != bucket_list.shape[0]:
        raise ValueError("bucket_q must be [nb, G] with nb = len(bucket_list)")
    if queries.dim() != 2 or queries.shape[1] != d:
        raise ValueError(f"queries must be [m, {d}], got "
                         f"{tuple(queries.shape)}")
    if metric_kind not in (L2, IP, COSINE):
        raise ValueError(f"metric_kind must be L2|IP|COSINE, got {metric_kind}")
    if centers is not None:
        if metric_kind != L2:
            raise ValueError("centers (residual queries) are for L2 only; "
                             "inner product passes scale alone")
        if tuple(centers.shape) != (C, d):
            raise ValueError(f"centers must be [{C}, {d}], got "
                             f"{tuple(centers.shape)}")
    if metric_kind != IP and (norms is None or
                              (qaux is None and centers is None)):
        raise ValueError("L2 and cosine need norms [C, cap] and qaux [m] "
                         "(or centers)")
    if compute_dtype not in ("f32", "bf16"):
        raise ValueError(f"compute_dtype must be f32|bf16, got "
                         f"{compute_dtype!r}")
    if not 0 < k <= min(k_max, cap):
        raise ValueError(f"k={k} out of range (1..min({k_max}, cap={cap}))")


def _compute_dtype(queries: torch.Tensor, compute_dtype) -> str:
    if compute_dtype is None:
        return "bf16" if queries.dtype == torch.bfloat16 else "f32"
    return str(compute_dtype)


def ivf_list_scan_topk(storage: torch.Tensor, indices: torch.Tensor,
                       list_sizes: torch.Tensor, bucket_list: torch.Tensor,
                       bucket_q: torch.Tensor, queries: torch.Tensor,
                       qaux: Optional[torch.Tensor] = None,
                       norms: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None, *, k: int,
                       metric_kind: int,
                       compute_dtype: Optional[str] = None,
                       centers: Optional[torch.Tensor] = None,
                       scale: float = 1.0,
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan each bucket's list against its query group; returns
    (out_d [nb, G, k] f32 min-space, out_i [nb, G, k] int32 global ids).

    ``storage`` [C, cap, d] f32, bf16 or int8; ``indices`` [C, cap] int32;
    ``list_sizes`` [C]; ``bucket_list`` [nb]; ``bucket_q`` [nb, G];
    ``queries`` [m, d]; ``qaux`` [m] (||q||^2 for L2, ||q|| for cosine;
    None for inner product and with ``centers``) and ``norms`` [C, cap]
    (||x||^2, None for inner product); ``keep`` [C, cap] (nonzero =
    eligible) or None; ``compute_dtype``, ``centers`` and ``scale`` as in
    the module docstring."""
    cd = _compute_dtype(queries, compute_dtype)
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, cd, K_MAX)
    if storage.device.type == "cpu":
        return ivf_list_scan_topk_plain(
            storage, indices, list_sizes, bucket_list, bucket_q, queries,
            qaux, norms, keep, k=k, metric_kind=metric_kind,
            compute_dtype=cd, centers=centers, scale=scale)
    if not storage.is_cuda:
        raise ValueError(f"ivf_list_scan_topk takes CPU or CUDA tensors, got "
                         f"{storage.device}")
    return _launch(storage, indices, list_sizes, bucket_list, bucket_q,
                   queries, qaux, norms, keep, int(k), int(metric_kind),
                   cd == "bf16", centers, float(scale))


ivf_list_scan_topk.launches = 0


def _launch(storage, indices, list_sizes, bucket_list, bucket_q, queries,
            qaux, norms, keep, k, metric_kind, bf16, centers, scale):
    dev = storage.device
    C, cap, d = storage.shape
    nb, G = bucket_q.shape

    def i32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.int32).contiguous()

    def f32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.float32).contiguous()

    st = storage.contiguous()
    q32 = f32(queries)
    if bf16 and centers is None and ctypes.c_float(scale).value == 1.0:
        # plain queries are rounded once here; the kernel rounds only the
        # residual queries it builds while staging
        q32 = round_bf16(q32)
    args = dict(ix=i32(indices), ls=i32(list_sizes), bl=i32(bucket_list),
                bq=i32(bucket_q), qa=None if centers is not None
                else f32(qaux), xn=f32(norms), kp=i32(keep),
                ct=f32(centers))
    out_d = torch.empty((nb, G, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, G, k), dtype=torch.int32, device=dev)

    lib = _build.load("ivf_list_scan_topk")
    fn = lib.ivf_list_scan_topk
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 9 + [ctypes.c_float]
                   + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(st), _STORAGE_KIND[st.dtype], ptr(args["ix"]),
                ptr(args["ls"]), ptr(args["bl"]), ptr(args["bq"]), ptr(q32),
                ptr(args["qa"]), ptr(args["xn"]), ptr(args["kp"]),
                ptr(args["ct"]), scale, cap, d, nb, G, k, metric_kind,
                int(bf16), ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "ivf_list_scan_topk", rc)
    ivf_list_scan_topk.launches += 1
    return out_d, out_i


def sq_norms_in_order(r: torch.Tensor) -> torch.Tensor:
    """``sum(r * r, -1)`` in f32, component 0 first, each product and each
    sum rounded once — the kernel's order for residual qaux."""
    acc = torch.zeros(r.shape[:-1], dtype=torch.float32, device=r.device)
    for c in range(r.shape[-1]):
        rc = r[..., c]
        acc = acc + rc * rc
    return acc


def ivf_list_scan_topk_plain(storage: torch.Tensor, indices: torch.Tensor,
                             list_sizes: torch.Tensor,
                             bucket_list: torch.Tensor,
                             bucket_q: torch.Tensor, queries: torch.Tensor,
                             qaux: Optional[torch.Tensor] = None,
                             norms: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None, *, k: int,
                             metric_kind: int,
                             compute_dtype: Optional[str] = None,
                             centers: Optional[torch.Tensor] = None,
                             scale: float = 1.0,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: batches of buckets gather
    their list blocks and queries (subtracting, scaling and rounding as
    the kernel stages them), take a batched f32 product, mask, and keep
    each query's top-k with a stable sort (ties to the lower list
    position). It keeps any k up to the capacity (the kernel: 256)."""
    cd = _compute_dtype(queries, compute_dtype)
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms, centers, cd, storage.shape[1])
    C, cap, d = storage.shape
    nb, G = bucket_q.shape
    dev = storage.device
    bf16 = cd == "bf16"
    q32 = queries.to(dev).float()
    sc = torch.tensor(float(scale), dtype=torch.float32, device=dev)
    col = torch.arange(cap, device=dev)
    out_d, out_i = [], []
    for b0 in range(0, nb, _PLAIN_BUCKETS):
        bl = bucket_list[b0:b0 + _PLAIN_BUCKETS].long()
        bq = bucket_q[b0:b0 + _PLAIN_BUCKETS].long()
        qsafe = bq.clamp_min(0)
        qv = q32[qsafe]                                   # [bb, G, d]
        qa = None
        if centers is not None:
            qv = qv - centers.to(dev).float()[bl][:, None, :]
            qa = sq_norms_in_order(qv)[:, :, None]        # [bb, G, 1]
        elif metric_kind != IP:
            qa = qaux.to(dev).float()[qsafe][:, :, None]
        qv = qv * sc
        blk = storage[bl].float()                         # [bb, cap, d]
        if bf16:
            qv, blk = round_bf16(qv), round_bf16(blk)
        dots = dist_dot(qv, blk.transpose(1, 2))          # [bb, G, cap]
        xn = None if metric_kind == IP else norms[bl].float()[:, None, :]
        dist = _epilogue(dots, metric_kind, qa, xn)
        valid = col[None, :] < list_sizes[bl].long()[:, None]   # [bb, cap]
        if keep is not None:
            valid = valid & (keep[bl] > 0)
        valid = valid[:, None, :] & (bq >= 0)[:, :, None]
        dist = torch.where(valid, dist, float("inf"))
        ids = indices[bl].to(torch.int32)[:, None, :].expand(-1, G, -1)
        d_k, i_k = merge_topk(dist, ids, k, select_min=True)
        out_d.append(d_k)
        out_i.append(torch.where(torch.isinf(d_k), -1, i_k))
    return torch.cat(out_d), torch.cat(out_i).to(torch.int32)
