"""nn-descent local join: the CUDA kernel and its plain version.

Replaces ``raft_tpu/ops/graph_join.py:_join_kernel`` (``pallas_call`` at
:257, entry ``graph_local_join`` :169). Per node row: score its C
candidates (L2 ``max(||q||^2 + ||c||^2 - 2 q.c, 0)``, inner product
``-q.c``; a candidate id < 0 scores +inf), pool them with the row's current
list of K, and return the pool's unique-by-id top-K, best-first: a
duplicate id keeps its smallest distance, distance ties go to the smallest
id, and unfilled slots are (+inf, -1) — the reference kernel's contract.

The reference takes the candidate vectors pre-gathered (``cand_vecs``
[B, C, d], gathered by XLA); here the kernel reads them from ``data`` by
id, so the caller passes ``data`` [n, d] and its squared ``norms`` [n].
The node rows are ``q`` [B, d] (with ``qn`` [B] = ||q||^2 for L2), or node
ids [B] into ``data``.

On a CUDA tensor :func:`graph_local_join` launches
``csrc/graph_local_join.cu`` or raises; on a CPU tensor it runs
:func:`graph_local_join_plain`; nothing else.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from raft_tpu_torch.ops import _build
from raft_tpu_torch.utils.precision import dist_dot

POOL_MAX = 2048         # the kernel's largest next_pow2(K + C)
_PLAIN_ROWS = 8192      # node rows per plain-version block
_NO_ID = torch.iinfo(torch.int32).max


def _rows(q, data, norms, qn, ip):
    """(node vectors [B, d] f32, their squared norms or None)."""
    if not q.dtype.is_floating_point:          # node ids into data
        ids = q.long()
        return data[ids].float(), None if ip else norms[ids].float()
    if not ip and qn is None:
        raise ValueError("L2 needs qn [B] (or node ids for q)")
    return q.float(), None if ip else qn.float()


def _check(q, cand_ids, data, norms, cur_d, cur_i, ip):
    B, C = cand_ids.shape
    if q.shape[0] != B or cur_d.shape[0] != B or \
            tuple(cur_i.shape) != tuple(cur_d.shape):
        raise ValueError(
            f"rows disagree: q {tuple(q.shape)}, cand_ids {(B, C)}, cur_d "
            f"{tuple(cur_d.shape)}, cur_i {tuple(cur_i.shape)}")
    if data.dim() != 2 or (q.dim() == 2 and q.shape[1] != data.shape[1]):
        raise ValueError(f"data must be [n, d] matching q, got "
                         f"{tuple(data.shape)}")
    if cur_d.shape[1] < 1:
        raise ValueError("the current list needs K >= 1 columns")
    if not ip and norms is None:
        raise ValueError("L2 needs the data norms")


def graph_local_join(q: torch.Tensor, cand_ids: torch.Tensor,
                     data: torch.Tensor, norms: Optional[torch.Tensor],
                     cur_d: torch.Tensor, cur_i: torch.Tensor, *,
                     qn: Optional[torch.Tensor] = None, ip: bool = False,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge each row's scored candidates into its unique top-K (K = the
    current list's width). Returns (new_d [B, K] f32, new_i [B, K]
    int32)."""
    _check(q, cand_ids, data, norms, cur_d, cur_i, ip)
    if data.device.type == "cpu":
        return graph_local_join_plain(q, cand_ids, data, norms, cur_d, cur_i,
                                      qn=qn, ip=ip)
    if not data.is_cuda:
        raise ValueError(f"graph_local_join takes CPU or CUDA tensors, got "
                         f"{data.device}")
    return _launch(q, cand_ids, data, norms, cur_d, cur_i, qn, bool(ip))


graph_local_join.launches = 0


def _launch(q, cand_ids, data, norms, cur_d, cur_i, qn, ip):
    dev = data.device
    for t in (q, cand_ids, cur_d, cur_i, norms, qn):
        if t is not None and t.device != dev:
            raise ValueError("every input must be on the data's device")
    B, C = cand_ids.shape
    K = cur_d.shape[1]
    if K + C > POOL_MAX:
        raise ValueError(f"K + C = {K + C} exceeds the kernel's pool of "
                         f"{POOL_MAX}")
    qv, qnv = _rows(q, data, norms, qn, ip)
    x = data.float().contiguous()
    d = x.shape[1]
    qv = qv.contiguous()
    cid = cand_ids.to(torch.int32).contiguous()
    cd = cur_d.float().contiguous()
    ci = cur_i.to(torch.int32).contiguous()
    xn = None if ip else norms.float().contiguous()
    qnv = None if ip else qnv.contiguous()
    out_d = torch.empty((B, K), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, K), dtype=torch.int32, device=dev)
    if B == 0:
        return out_d, out_i
    vec4 = int(d % 4 == 0 and x.data_ptr() % 16 == 0)

    lib = _build.load("graph_local_join")
    fn = lib.graph_local_join
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    ptr = _build.ptr
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ptr(qv), ptr(qnv), ptr(cid), ptr(x), ptr(xn), ptr(cd),
                ptr(ci), B, C, K, d, int(ip), vec4, ptr(out_d), ptr(out_i),
                stream)
    _build.check(lib, "graph_local_join", rc)
    graph_local_join.launches += 1
    return out_d, out_i


def graph_local_join_plain(q: torch.Tensor, cand_ids: torch.Tensor,
                           data: torch.Tensor, norms: Optional[torch.Tensor],
                           cur_d: torch.Tensor, cur_i: torch.Tensor, *,
                           qn: Optional[torch.Tensor] = None,
                           ip: bool = False,
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: gathered candidate rows,
    f32 dots, then :func:`merge_unique`; ``_PLAIN_ROWS`` rows at a time
    so the [rows, C, d] gather stays bounded."""
    _check(q, cand_ids, data, norms, cur_d, cur_i, ip)
    qv, qnv = _rows(q, data, norms, qn, ip)
    K = cur_d.shape[1]
    out_d, out_i = [], []
    for r0 in range(0, cand_ids.shape[0], _PLAIN_ROWS):
        r1 = r0 + _PLAIN_ROWS
        cid = cand_ids[r0:r1].long()
        safe = cid.clamp_min(0)
        dots = dist_dot(qv[r0:r1, None, :],
                        data[safe].transpose(1, 2))[:, 0, :]
        if ip:
            dist = -dots
        else:
            dist = torch.clamp_min(
                qnv[r0:r1, None] + norms[safe].float() - 2.0 * dots, 0.0)
        dist = torch.where(cid < 0, torch.inf, dist)
        nd, ni = merge_unique(cur_d[r0:r1].float(), cur_i[r0:r1], dist, cid,
                              K)
        out_d.append(nd)
        out_i.append(ni)
    if not out_d:
        return cur_d.float().clone(), cur_i.to(torch.int32).clone()
    return torch.cat(out_d), torch.cat(out_i)


def merge_unique(cur_d: torch.Tensor, cur_i: torch.Tensor,
                 new_d: torch.Tensor, new_i: torch.Tensor, K: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each row's unique-by-id top-K of the pooled (distance, id) pairs:
    a duplicate id keeps its smallest distance, ties go to the smallest
    id, ids < 0 and +inf distances are dropped, and unfilled slots are
    (+inf, -1)."""
    all_d = torch.cat([cur_d, new_d], 1)
    all_i = torch.cat([cur_i.long(), new_i.long()], 1)
    all_d = torch.where(all_i < 0, torch.inf, all_d) + 0.0   # -0.0 -> +0.0
    # by (id, distance): each id's smallest copy first
    o = torch.sort(all_d, dim=1, stable=True).indices
    sd, si = all_d.gather(1, o), all_i.gather(1, o)
    o = torch.sort(torch.where(si < 0, _NO_ID, si), dim=1,
                   stable=True).indices
    sd, si = sd.gather(1, o), si.gather(1, o)
    later = torch.zeros_like(si, dtype=torch.bool)
    later[:, 1:] = si[:, 1:] == si[:, :-1]
    sd = torch.where(later | (si < 0), torch.inf, sd)
    # by (distance, id): a stable sort of the id-ordered row
    o = torch.sort(sd, dim=1, stable=True).indices[:, :K]
    sd, si = sd.gather(1, o), si.gather(1, o)
    si = torch.where(sd == torch.inf, -1, si)
    return sd, si.to(torch.int32)
