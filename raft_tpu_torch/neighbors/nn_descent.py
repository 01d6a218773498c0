"""NN-descent: iterative all-KNN-graph construction.

Counterpart of ``raft_tpu/neighbors/nn_descent.py``: the same pull-based
local join (each node gathers candidates from its two-hop neighbourhood
over the forward + reverse graph, scores them and merges them into its
list with a unique top-K), the same sample-then-gather draw of two-hop
columns, the same node blocks and the same convergence window.

The join runs through ``ops.graph_join.graph_local_join`` — the CUDA
kernel on the card, its plain version on the CPU; ``join_impl`` takes the
reference's names ("auto" / "pallas[:tile]" the kernel, "xla" /
"pallas_interpret" the plain version on any device). ``_score`` and
``_merge_topk_unique`` are the reference's XLA join in plain PyTorch
(keep-first dedup in id order), kept as the twin of the CPU oracle; the
build itself does not call them.

Random state (the initial neighbours and each iteration's column draw)
comes from one ``torch.Generator`` seeded with ``params.seed``; it draws
other numbers than ``jax.random`` does, so graphs are compared by quality,
not bit for bit. The node block is the fixed ``_DEF_BLOCK_ROWS``; the
reference's tuned ``graph_join_rows`` budget and its OOM ladder are not
ported (ROADMAP.md), and neither are its ``obs`` spans.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device
from raft_tpu_torch.distance.types import DistanceType, resolve_metric
from raft_tpu_torch.neighbors.common import backend_route, merge_topk
from raft_tpu_torch.neighbors.ivf_flat import _pack_lists
from raft_tpu_torch.ops.graph_join import graph_local_join, \
    graph_local_join_plain
from raft_tpu_torch.utils.precision import dist_dot

_NO_ID = torch.iinfo(torch.int32).max   # sort-to-end sentinel for invalid ids

# node rows per join launch
_DEF_BLOCK_ROWS = 1 << 16


@dataclasses.dataclass
class IndexParams:
    """Build params (reference nn_descent_types.hpp: graph_degree,
    intermediate_graph_degree, max_iterations, termination_threshold)."""

    graph_degree: int = 64
    intermediate_graph_degree: int = 0     # 0 -> 1.5x graph_degree
    max_iterations: int = 20
    termination_threshold: float = 0.0001
    metric: DistanceType = DistanceType.L2Expanded
    # candidates pulled per node per iteration, sampled from the 2-hop pool
    n_candidates: int = 128
    seed: int = 0
    # join backend, the reference's names (module docstring)
    join_impl: str = "auto"
    # rows per join launch; 0 = _DEF_BLOCK_ROWS
    block_rows: int = 0
    # the device-side update-count window is read once every this many
    # iterations
    check_every: int = 4

    def __post_init__(self):
        self.metric = resolve_metric(self.metric)
        if self.metric not in (
            DistanceType.L2Expanded,
            DistanceType.L2SqrtExpanded,
            DistanceType.L2Unexpanded,
            DistanceType.InnerProduct,
        ):
            raise ValueError(
                f"nn_descent supports L2/IP metrics, got {self.metric!r}")


@dataclasses.dataclass
class Index:
    """All-neighbours graph (reference nn_descent index: graph [n, deg])."""

    graph: torch.Tensor       # [n, graph_degree] int32
    distances: torch.Tensor   # [n, graph_degree] f32


def _score(q_ids, cand_ids, data, norms, ip: bool):
    """dist(x[q_ids[v]], x[cand_ids[v, :]]) for every node v, min-close
    in both metrics (IP negated)."""
    qv = data[q_ids.long()]
    cv = data[cand_ids.long()]
    dots = dist_dot(qv[:, None, :], cv.transpose(1, 2))[:, 0, :]
    if ip:
        return -dots
    return torch.clamp_min(
        norms[q_ids.long()][:, None] + norms[cand_ids.long()] - 2.0 * dots,
        0.0)


def _merge_topk_unique(cur_d, cur_i, new_d, new_i, K: int):
    """Merge candidate (dist, id) lists into each row's unique top-K:
    stable id-sort, first copy of each id kept, repeats and invalid ids
    scored +inf, then a stable top-K (ties to the lower id)."""
    all_d = torch.cat([cur_d, new_d], 1)
    all_i = torch.cat([cur_i.long(), new_i.long()], 1)
    order = torch.sort(torch.where(all_i < 0, _NO_ID, all_i), dim=1,
                       stable=True).indices
    si = all_i.gather(1, order)
    sd = all_d.gather(1, order)
    dup = torch.zeros_like(si, dtype=torch.bool)
    dup[:, 1:] = si[:, 1:] == si[:, :-1]
    dup |= si < 0
    sd = torch.where(dup, torch.inf, sd)
    si = torch.where(dup, -1, si)
    d, i = merge_topk(sd, si, K, select_min=True)
    return d, i.to(torch.int32)


def _make_rev(graph_i: torch.Tensor) -> torch.Tensor:
    """Reverse graph, capped at K per node: sources packed by destination
    with the IVF sort-scatter (first K sources in row order)."""
    n, K = graph_i.shape
    dev = graph_i.device
    src = torch.arange(n, dtype=torch.int32,
                       device=dev).repeat_interleave(K)
    dst = graph_i.reshape(-1).long()
    dst = torch.where(dst >= 0, dst, n)
    _, rev_i, _ = _pack_lists(
        torch.zeros((n * K, 1), dtype=torch.int8, device=dev), dst, src, n, K)
    return rev_i


def _init_block(data, norms, init_i, start: int, rows: int, ip: bool,
                join=None):
    """Exactly score + dedup one node block of the random init (the local
    join against an empty list)."""
    K = init_i.shape[1]
    ib = init_i[start:start + rows]
    empty_d = torch.full((ib.shape[0], K), torch.inf, device=data.device)
    empty_i = torch.full((ib.shape[0], K), -1, dtype=torch.int32,
                         device=data.device)
    return (join or graph_local_join)(
        data[start:start + rows], ib, data, None if ip else norms, empty_d,
        empty_i, qn=None if ip else norms[start:start + rows], ip=ip)


def _join_block(data, norms, graph_d, graph_i, pool, rev_i, cols,
                start: int, rows: int, ip: bool, join=None):
    """One local join over node rows [start, start + rows).

    Sample-then-gather: ``cols`` selects (pool slot, neighbour slot)
    pairs, so only the [rows, S] sampled two-hop entries are gathered.
    Rows are independent, so blocks cover [0, n) in any split. Returns
    (new_d, new_i, number of changed list slots as a device scalar)."""
    K = graph_i.shape[1]
    sl = slice(start, start + rows)
    gd, gi = graph_d[sl], graph_i[sl]
    pool_b, rev_b = pool[sl], rev_i[sl]

    sel = (cols // K).long()                     # [S] pool slot
    off = (cols % K).long()                      # [S] neighbour slot
    hop_src = pool_b[:, sel]                     # [rows, S]
    cand = graph_i[hop_src.clamp_min(0).long(), off[None, :]]
    cand = torch.where(hop_src >= 0, cand, -1)
    cand = torch.cat([cand, rev_b], 1)           # pool reverse edges too
    node_ids = torch.arange(start, start + gi.shape[0], dtype=torch.int32,
                            device=data.device)
    cand = torch.where(cand == node_ids[:, None], -1, cand)   # no self loops
    new_d, new_i = (join or graph_local_join)(
        data[sl], cand, data, None if ip else norms, gd, gi,
        qn=None if ip else norms[sl], ip=ip)
    return new_d, new_i, (new_i != gi).sum()


def _blocked(fn, n: int, block: int) -> List[Tuple]:
    """Cover [0, n) with ``fn(start, rows)``, ``block`` rows at a time."""
    return [fn(s, min(block, n - s)) for s in range(0, n, block)]


def build(params: IndexParams, dataset, device=None) -> Index:
    """Build the all-KNN graph on ``device`` (default: the CUDA card)."""
    dev = resolve_device(device)
    data = as_tensor(dataset, dev).float().contiguous()
    n = data.shape[0]
    K = int(params.intermediate_graph_degree) or max(
        int(params.graph_degree * 3 // 2), int(params.graph_degree))
    K = min(K, n - 1)
    out_K = min(int(params.graph_degree), K)
    ip = params.metric == DistanceType.InnerProduct
    norms = (data * data).sum(1)
    gen = torch.Generator(device=dev).manual_seed(int(params.seed))
    S = int(params.n_candidates)
    block = int(params.block_rows) or _DEF_BLOCK_ROWS
    join = (None if backend_route(params.join_impl, "join_impl") == "kernel"
            else graph_local_join_plain)

    # init: random neighbours, exactly scored + deduped
    init_i = torch.randint(0, n, (n, K), generator=gen, device=dev,
                           dtype=torch.int32)
    self_id = torch.arange(n, dtype=torch.int32, device=dev)[:, None]
    init_i = torch.where(init_i == self_id, (init_i + 1) % n, init_i)
    parts = _blocked(
        lambda s, r: _init_block(data, norms, init_i, s, r, ip, join), n,
        block)
    graph_d = torch.cat([p[0] for p in parts])
    graph_i = torch.cat([p[1] for p in parts])
    del init_i, parts

    threshold = float(params.termination_threshold) * n * K
    check_every = max(1, int(params.check_every))
    updates = []                 # device-side window, read once per window
    for _ in range(int(params.max_iterations)):
        rev_i = _make_rev(graph_i)
        pool = torch.cat([graph_i, rev_i], 1)                 # [n, 2K]
        # a fresh column draw per iteration replaces the reference's
        # bloom-filter "new vs old" bookkeeping
        cols = torch.randint(0, 2 * K * K, (S,), generator=gen, device=dev)
        parts = _blocked(
            lambda s, r: _join_block(data, norms, graph_d, graph_i, pool,
                                     rev_i, cols, s, r, ip, join), n, block)
        graph_d = torch.cat([p[0] for p in parts])
        graph_i = torch.cat([p[1] for p in parts])
        updates.append(sum(p[2] for p in parts))
        del parts, pool, rev_i
        if len(updates) >= check_every:
            window = torch.stack(updates).cpu()
            updates = []
            if int(window.min()) <= threshold:
                break
    dists = graph_d[:, :out_K]
    if params.metric == DistanceType.L2SqrtExpanded:
        dists = torch.sqrt(torch.clamp_min(dists, 0.0))
    elif ip:
        dists = -dists
    return Index(graph=graph_i[:, :out_K].contiguous(),
                 distances=dists.contiguous())
