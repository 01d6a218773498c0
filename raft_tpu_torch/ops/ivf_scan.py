"""IVF list scan + per-list top-k: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/ivf_scan.py:_scan_kernel`` (``pallas_call`` at
:547; float-storage arm, exact extraction). One step per bucket — one
query group against one inverted list: the list is found through
``bucket_list[b]``, ``dots = q . row`` with f32 accumulation, the L2 /
inner-product / cosine epilogue in min-space, columns past
``list_sizes[l]`` or with ``keep == 0`` masked, and each query's top-k
(ties to the lower list position) emitted with the **stored global ids**
read from the list's id row. Tails come back as (+inf, -1).

The reference takes the query group pre-gathered as ``qv`` [nb, G, d] and
``qaux`` [nb, G]; here the kernel gathers queries itself through
``bucket_q`` [nb, G] (-1 = empty slot) from ``queries`` [m, d] and
``qaux`` [m] — at the SIFT-1M main path the pre-gathered copy would be a
233 MB write and read per batch. Empty slots come back as (+inf, -1) (the
reference scans query 0 there; the caller never reads those slots).

On a CUDA tensor :func:`ivf_list_scan_topk` launches
``csrc/ivf_list_scan_topk.cu`` or raises; on a CPU tensor it runs
:func:`ivf_list_scan_topk_plain`; nothing else. The packed storage arms
(i4, pq4, RaBitQ bits) and the binned / fold extractions are not ported
(ROADMAP.md).
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


def _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms):
    if storage.dim() != 3:
        raise ValueError(f"storage must be [C, cap, d], got "
                         f"{tuple(storage.shape)}")
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
    if metric_kind != IP and (qaux is None or norms is None):
        raise ValueError("L2 and cosine need norms [C, cap] and qaux [m]")
    if not 0 < k <= min(K_MAX, cap):
        raise ValueError(f"k={k} out of range (1..min({K_MAX}, cap={cap}))")


def ivf_list_scan_topk(storage: torch.Tensor, indices: torch.Tensor,
                       list_sizes: torch.Tensor, bucket_list: torch.Tensor,
                       bucket_q: torch.Tensor, queries: torch.Tensor,
                       qaux: Optional[torch.Tensor] = None,
                       norms: Optional[torch.Tensor] = None,
                       keep: Optional[torch.Tensor] = None, *, k: int,
                       metric_kind: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scan each bucket's list against its query group; returns
    (out_d [nb, G, k] f32 min-space, out_i [nb, G, k] int32 global ids).

    ``storage`` [C, cap, d] f32 or bf16; ``indices`` [C, cap] int32;
    ``list_sizes`` [C]; ``bucket_list`` [nb]; ``bucket_q`` [nb, G];
    ``queries`` [m, d] (bf16 queries or bf16 storage make both operands
    bf16); ``qaux`` [m] (||q||^2 for L2, ||q|| for cosine) and ``norms``
    [C, cap] (||x||^2), both None for inner product; ``keep`` [C, cap]
    (nonzero = eligible) or None."""
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms)
    if storage.device.type == "cpu":
        return ivf_list_scan_topk_plain(
            storage, indices, list_sizes, bucket_list, bucket_q, queries,
            qaux, norms, keep, k=k, metric_kind=metric_kind)
    if not storage.is_cuda:
        raise ValueError(f"ivf_list_scan_topk takes CPU or CUDA tensors, got "
                         f"{storage.device}")
    return _launch(storage, indices, list_sizes, bucket_list, bucket_q,
                   queries, qaux, norms, keep, int(k), int(metric_kind))


ivf_list_scan_topk.launches = 0


def _launch(storage, indices, list_sizes, bucket_list, bucket_q, queries,
            qaux, norms, keep, k, metric_kind):
    dev = storage.device
    C, cap, d = storage.shape
    nb, G = bucket_q.shape
    bf16 = torch.bfloat16 in (queries.dtype, storage.dtype)
    st = storage if storage.dtype in (torch.float32, torch.bfloat16) \
        else storage.float()

    def i32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.int32).contiguous()

    def f32(t):
        return None if t is None else t.to(device=dev,
                                           dtype=torch.float32).contiguous()

    q32 = queries.to(dev).float()
    q32 = (round_bf16(q32) if bf16 else q32).contiguous()
    args = dict(st=st.contiguous(), ix=i32(indices), ls=i32(list_sizes),
                bl=i32(bucket_list), bq=i32(bucket_q), qa=f32(qaux),
                xn=f32(norms), kp=i32(keep))
    out_d = torch.empty((nb, G, k), dtype=torch.float32, device=dev)
    out_i = torch.empty((nb, G, k), dtype=torch.int32, device=dev)

    lib = _build.load("ivf_list_scan_topk")
    fn = lib.ivf_list_scan_topk
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int]
                   + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int

    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(args["st"]), int(st.dtype == torch.bfloat16),
                ptr(args["ix"]), ptr(args["ls"]), ptr(args["bl"]),
                ptr(args["bq"]), ptr(q32), ptr(args["qa"]), ptr(args["xn"]),
                ptr(args["kp"]), cap, d, nb, G, k, metric_kind, int(bf16),
                ptr(out_d), ptr(out_i), stream)
    _build.check(lib, "ivf_list_scan_topk", rc)
    ivf_list_scan_topk.launches += 1
    return out_d, out_i


def ivf_list_scan_topk_plain(storage: torch.Tensor, indices: torch.Tensor,
                             list_sizes: torch.Tensor,
                             bucket_list: torch.Tensor,
                             bucket_q: torch.Tensor, queries: torch.Tensor,
                             qaux: Optional[torch.Tensor] = None,
                             norms: Optional[torch.Tensor] = None,
                             keep: Optional[torch.Tensor] = None, *, k: int,
                             metric_kind: int,
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: batches of buckets gather
    their list blocks and queries, take a batched f32 product, mask, and
    keep each query's top-k with a stable sort (ties to the lower list
    position)."""
    _check(storage, indices, list_sizes, bucket_list, bucket_q, queries, k,
           metric_kind, qaux, norms)
    C, cap, d = storage.shape
    nb, G = bucket_q.shape
    dev = storage.device
    bf16 = torch.bfloat16 in (queries.dtype, storage.dtype)
    q32 = queries.to(dev).float()
    q32 = round_bf16(q32) if bf16 else q32
    col = torch.arange(cap, device=dev)
    out_d, out_i = [], []
    for b0 in range(0, nb, _PLAIN_BUCKETS):
        bl = bucket_list[b0:b0 + _PLAIN_BUCKETS].long()
        bq = bucket_q[b0:b0 + _PLAIN_BUCKETS].long()
        qsafe = bq.clamp_min(0)
        blk = storage[bl].float()                         # [bb, cap, d]
        if bf16:
            blk = round_bf16(blk)
        dots = dist_dot(q32[qsafe], blk.transpose(1, 2))  # [bb, G, cap]
        qa = xn = None
        if metric_kind != IP:
            qa = qaux.to(dev).float()[qsafe][:, :, None]   # [bb, G, 1]
            xn = norms[bl].float()[:, None, :]             # [bb, 1, cap]
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
