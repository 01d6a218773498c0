"""Smoke run of the PyTorch/CUDA port (raft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device  — a CUDA card is required; prints the card's name and power
             limit as nvidia-smi reports them;
2. build   — compiles every CUDA kernel with nvcc, one process per
             library, all at once: the four kernels whole, and the two
             scan kernels and the local join again with only their first
             stages (for the stage timings);
3. parity  — holds each kernel against its plain PyTorch version on the
             card, first on small ragged shapes (lists shorter than k, a
             keep filter, all metrics; f32 x f32, f32 x bf16 and bf16 x
             bf16 operands for kernels 1 and 2; kernel 2's int8 arm with
             residual queries, L2 and inner product, k from 1 to 256, rot
             20 to 128, bf16 and f32 operands, empty slots; its packed
             arms — i4, RaBitQ sign bits with the row scale (rot off a
             whole word too), pq4 (bit for bit on the core's kernel) —
             and the int8 arm with
             per-list scales on the same kinds of cases; for the
             nn-descent join C < K, K = 1, K = 128, d off a multiple of 4
             and duplicate ids, then, on small integers (every distance
             exact, so bit for bit): many duplicate ids (n < C),
             candidates repeating the list, twin rows (equal distances),
             -0.0 (zero rows under inner product, a candidate that is the
             node's row), rows of -1 candidates only, C = 0, K + C =
             2048, 513 and <= 32, C off a multiple of 32, d = 30, and
             sorted lists (a first join's output) that half the
             candidates repeat; for the
             beam step both arms, emitted
             candidates, m off any tile and masked parents; kernel 2's
             binned and binned_deep extraction arms on every storage
             kind, caps 256 and 384, k 1 to 256, with duplicate rows,
             bit for bit wherever the exact arm is (on the core's
             body), and refused at cap 128; binned_deep through its
             Hopper body (int8, i4 and sign-bit rows, rot 40 to 128, k 1
             to 256, caps 256 to 640, L2, inner product and cosine, G off
             a multiple of 64), bit for bit on small integers; the exact
             and binned arms through the Hopper arms' body likewise (k 1
             to 64; a cap of 390 left to the core), over IVF-Flat's f32
             and bf16 rows too (d 16 to 128, L2, inner product and
             cosine, small integers and f32 rows whose rounding to bf16
             meets exact ties; f32 operands and d 136 left to the core);
             the pq4
             arm through its Hopper body (exact, binned, binned_deep; k 1
             to 64, p 24 to 96 at pq_len 1 and 2, L2 and inner product,
             caps 256 to 640 and 390, a padding bucket), bit for bit on
             small integers, and refused past its shared memory; the fold
             arms of both kernels, unmerged buffers bit for bit: kernel
             1's for every metric, f32 and bf16, R = 2, 3, 4
             and each tile of tuning.FUSED_TOPK_TILES with n off the tile,
             kernel 1's Hopper fold body likewise (bf16 queries over bf16
             and f32 rows, d 48 and 128, with and without keep) and on
             random rows within fold_atol, kernel 2's on every storage
             kind and the pq4 kernel at R = 2 and 4; kernel 2's f16 and
             uint8 rows); kernel 1's exact arm through its Hopper body
             (f32 queries over f32 and bf16 rows, bf16 queries over bf16
             and f32 rows; L2, inner product and cosine, with and without
             keep, k 1, 10, 32, 33, 42 and 64, d 16 to 128, ragged m and
             n) bit for bit on small integers, on random rows within
             exact_atol, and d 136, k 65 and f16 rows left to the core;
             then at the paths' own shapes; then a small
             IVF-Flat (f32, float16 and uint8 rows),
             a small IVF-PQ (L2 and inner product, then one per cache
             rung: i4, pq4, RaBitQ, raw i4, raw i8), each with the exact
             and the binned arm, and a small CAGRA search on the card
             against the same index searched on the CPU;
4. IVF-Flat path — on 1,000,000 x 128 f32 SIFT-like rows made on the card
             from a seed: build with n_lists=1024, search 10,000 queries
             with n_probes=64 and k=10 at local_recall_target=1.0 (the
             exact arm), recall@10 against the port's exact brute force on
             1,000 queries (>= 0.90), QPS as the median of 5 timed batches
             after a warm-up, and a profiler breakdown of one batch; then
             its default search (phase 8); then the fast brute force
             (brute_force.search(fast=True), k=10, k_cand=42) on the same
             rows and queries: its default on the card must take kernel
             1's fold at fused_fold:2048 on its Hopper body (from the
             launch record); the
             same call at impl="fused_exact" beside it; recall@10 of both
             (the fold's no more than 0.01 under the exact arm's), QPS
             and a profile; then the same fast search under a prefilter
             keeping ~90% of the rows (kernel 1's exact arm under bf16
             queries, the keep filter) against the filtered exact search,
             its recall no more than 0.01 under the exact arm's and no
             filtered-out row returned;
5. CAGRA paths — on the same rows: (a) nn-descent
             (intermediate_graph_degree=64, at most 80 iterations) ->
             optimize (graph_degree=32) -> packed inline layout, with the
             nn-descent graph's recall on 1,000 sampled nodes and the
             build and recall at nn-descent's default of 20 iterations
             (reported, not gated); (b) the reference's default build, an
             IVF-PQ self-search refined exactly -> optimize -> packed
             layout, its self-search at the default target (binned_deep
             at k = 64, with the self-search graph's recall@63 on 1,000
             sampled nodes). Each part timed; search the 10,000 queries
             with n_seeds=64, max_iterations=15 and k=10; recall@10 as
             above (>= 0.90), QPS and a profile as above;
6. IVF-PQ path — the JAX package's DEEP-10M configuration
             (bench.py:283-343) on 10,000,000 x 96 SIFT-like rows: the
             streamed build (batch_size=2,000,000, n_lists=1024,
             pq_dim=48, pq_bits=8, the default int8 cache), split into
             train / encode / pack / rec_norms / cache; search 10,000
             queries with n_probes=128 and k=10 at local_recall_target
             1.0: recall@10 on 1,000 queries (>= 0.85), QPS, launches per
             search, a profile; the refined search (30 candidates refined
             exactly to 10, recall >= 0.95); then phase 8;
7. IVF-PQ rungs — the compressed caches at the same configuration, on
             the same rows and queries, one index at a time: (a)
             cache_dtype="i4"; (b) attach_raw_residual_cache(dtype="i4")
             on the default index; (c) pq_dim=96, pq_bits=4,
             cache_dtype="pq4"; (d) attach_rabitq_cache on the default
             index, searched at k=40. Each, at local_recall_target=1.0:
             build / attach seconds by part, cache GB, recall@10 raw
             (>= 0.85 for a-c) and refined
             (30 candidates, exact refine; >= 0.95 for a-c; RaBitQ from
             40 and from 80 candidates, the smaller that reaches
             RABITQ_REFINED_RECALL_FLOOR, or the run fails), QPS, launches per
             search, a profile, and the arm timed at its shapes; then the
             default search on the same index (phase 8). Every kernel of a
             path must have launched during that path's run (counts set
             to 0 just before it, read just after);
8. defaults — at the reference's default local_recall_target
             (0.95), on the indexes, queries and truth of phases 4, 6 and
             7: IVF-Flat (binned at k=10), IVF-PQ int8 (binned at k=10)
             and its refined search (binned_deep at 30, refined to 10),
             the i4, raw i4 and pq4 rungs (binned at k=10), pq4's refined
             search (binned_deep at 30, refined to 10) and RaBitQ
             (binned_deep at 40, refined to 10): recall@10, QPS, kernel
             2's launches by arm, a profile, and the arm timed at the
             search's shapes by stage beside its plain version and bound.
             Each must reach its exact run's recall less 0.05 (raw, and
             refined where refined); IVF-Flat also 0.90, refined IVF-PQ
             0.95; the raw rungs' absolute floor is printed, not held.
             Then IVF-Flat (k=10) and IVF-PQ int8 (k=10, and the refined
             search's 30) again under a dispatch table written to a
             temporary file that names kernel 2's fold for each search's
             key {cap, k, g} (tuning.set_table_path, restored after): the
             fold arm recorded, the same gates;
9. report  — each kernel (and kernel 2's int8 arm) timed at its path's
             shapes beside its plain version and its bound (the scan
             kernels also by stage: staging loads and epilogue, dots,
             top-k selection; the local join by stage: candidate rows
             gathered, scores, merge; the packed and binned arms were timed on
             their paths); then the nvidia-smi line, one JSON line of
             per-kernel numbers (binned from the IVF-Flat default search
             and, on the Hopper arms' body, from the DEEP-10M int8 and i4
             default searches, binned_deep from the refined IVF-PQ one;
             the int8, i4 and RaBitQ rows are their exact searches' scans,
             on that body too; kernel 1's exact arm from the recall
             oracle (f32) and from the fast path's impl="fused_exact"
             launch (bf16, with its library yardstick of bf16 products
             and torch.topk), both on its Hopper body, whose f32 bound
             counts three TF32 products a pair; kernel 1's fold (its
             Hopper body, with its library yardstick) from the fast brute
             force, kernel 2's fold from IVF-Flat under the fold table; a
             fold's bound counts its candidate write), and
             last the result line.

Tolerances: the brute-force, list-scan and join kernels and their plain
versions sum f32 products in different orders, so distances agree to
1e-4 relative plus an absolute term (1e-4; for the join 2e-6 of the
expanded form's terms, ||q||^2 + ||c||^2, whose rounding it inherits),
and ids agree exactly wherever a distance is not within that tolerance of
its neighbour in the row (a tie). The int8, i4 and sign-bit arms'
residual queries, their qaux and the operand rounding are computed in one
order by both, so only the dots' sum order differs. The core's pq4
kernel, and the beam step, and their plain versions round and sum in one
fixed order, so they must agree bit for bit; the pq4 Hopper body (bf16
operands) adds the same table entries in the same order on the tensor
cores, whose f32 sums may truncate where the plain version rounds to
nearest: bit for bit on small integers (every partial sum exact), else
within ``pq4_atol`` with equal ids on tie-free keys (compare's join
rule). The binned and fold arms keep what the
reference's bin rules keep from the same distances, so wherever the exact
arm agrees bit for bit, they must too; except the binned_deep arm's Hopper
body (int8, i4 and sign-bit rows under bf16 operands), whose dots run on
the tensor cores and sum the exact products in another order: it is held
bit for bit on small-integer cases, where every dot is exact in any
order, and elsewhere to the tolerance with equal ids on tie-free keys.
Kernel 1's Hopper fold body likewise: bit for bit on small integers,
else within ``fold_atol`` (1.25 d 2^-24 of ||q|| times the largest row
norm, twice that for L2) on sorted or merged rows, a lane's near-tied
rival hidden. Kernel 1's exact arm on its Hopper body: bit for bit on
small integers; else under bf16 queries within ``fold_atol`` (the same
arithmetic), under f32 queries (3xTF32, f32 sums) within compare's own
1e-4 relative + 1e-4, both with the join rule (the k-th's rival past the
row is unseen).
The exact and binned arms over the same rows, and over f32 and bf16 rows
with plain queries (the f32 rows rounded to bf16 as the plain version
rounds them), take the Hopper arms' body and are held the same way, the
binned arm also hiding a bin's near-tied rival.
The CAGRA self-search, the refined IVF-PQ first stage and RaBitQ's first
stage must take the binned_deep body; the DEEP-10M int8 exact (k 10 and
the refined search's 30) and default searches, the i4 and raw i4 rungs'
exact and default searches and RaBitQ's exact search the Hopper arms'
body; and every launch of the pq4 rung's exact, default and refined
default searches the pq4 Hopper body (launches by body printed), or the
run fails after its report; so must the IVF-Flat main path's exact and
default searches take the Hopper arms' body, and its fold under the table
the core's; and kernel 1's exact arm must take its Hopper body at the
recall oracle (the default exact search), at the fast path's
impl="fused_exact" launch, at the filtered fast search and at the
filtered exact search.

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import time

import torch

H100_HBM_BYTES_PER_S = 3.35e12        # NVIDIA data sheet, SXM
H100_F32_FLOPS = 67e12                 # f32 on the CUDA cores
# one f32 add (or FMA) a lane a clock: an add takes an FMA's issue slot
# but counts one operation, not two
H100_F32_ADDS = H100_F32_FLOPS / 2
H100_BF16_FLOPS = 989e12               # bf16 tensor cores, dense
H100_TF32_FLOPS = 495e12               # TF32 tensor cores, dense
RTOL = ATOL = 1e-4
F32, BF16 = torch.float32, torch.bfloat16
RECALL_FLOOR = 0.90
# a default search (local_recall_target 0.95, the binned arms) may lose at
# most the reference's per-list budget, 1 - 0.95, of its exact run's recall
RECALL_LOSS_BUDGET = 0.05
IVF_PQ_RECALL_FLOOR = 0.85         # IVF-PQ at the DEEP-10M config
REFINED_RECALL_FLOOR = 0.95        # the same, 3k candidates refined to k
# the RaBitQ rung's first stage (4k candidates) refined to k: the
# reference's recall on that recipe at CPU size, held by
# tests/test_torch_ivf_pq_rungs.py::test_rabitq_refined_recipe_sets_the_smoke_gate
RABITQ_REFINED_RECALL_FLOOR = 0.80
# the RaBitQ rung's first-stage widths, as multiples of k, each refined
# exactly to k: bench.py:428-450's 4, then doubled. The gate holds the
# smallest that clears RABITQ_REFINED_RECALL_FLOOR, the reference's rule
# for this pipeline (raft_tpu/tuning/microbench.py:464). At 4 the
# recipe's refined recall falls as the rows grow, in the reference as in
# the port (tests/torch_rung_scaling.py), and at 10M rows it is under
# the floor (PERF.md)
RABITQ_REFINE_RATIOS = (4, 8)
# nn-descent iterations of the CAGRA build: at the reference's default of
# 20, the sampled join has not converged at 1M rows (PERF.md, PR 5)
NN_DESCENT_NITER = 80


class SmokeFailure(RuntimeError):
    pass


def log(*args):
    print(*args, flush=True)


def sift_like(n: int, d: int, seed: int, device, intrinsic: int = 16,
              block: int = 1 << 20) -> torch.Tensor:
    """The reference benchmark's manifold recipe (raft_tpu/bench/run.py
    ``synthetic_dataset``): rows near a 16-dim manifold in d dims, around
    64 with a spread of 24, plus noise of 2, clipped to [0, 255] — made on
    the card from ``seed``."""
    gp = torch.Generator(device=device).manual_seed(12345)
    proj = torch.randn(intrinsic, d, generator=gp, device=device) / \
        intrinsic ** 0.5
    g = torch.Generator(device=device).manual_seed(int(seed))
    out = torch.empty((n, d), device=device)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        z = 24.0 * torch.randn(r1 - r0, intrinsic, generator=g,
                               device=device)
        blk = 64.0 + z @ proj + 2.0 * torch.randn(r1 - r0, d, generator=g,
                                                  device=device)
        out[r0:r1] = blk.clamp_(0.0, 255.0)
    return out


def compare(name, kd, ki, pd, pi, atol=ATOL, join=False,
            hidden=False) -> dict:
    """Kernel output (kd, ki) against the plain version's (pd, pi); raises
    beyond tolerance. ``atol`` may be a per-row tensor. Rows are sorted,
    so a tie is a distance within tolerance of its neighbour in the plain
    row. For the local join and kernel 2's Hopper bodies (``join``),
    whose errors are those of the expanded form and whose
    rows end at K (k), a tie is also one in the
    kernel's row, and in the last column, where the rival past the row's
    end is unseen, two different ids at distances within tolerance of
    each other. With ``hidden`` (the binned arms on the pq4 Hopper body,
    whose sums differ from the plain version's by up to the tolerance) a
    bin lists one (binned_deep: four) of its candidates, so a near-tie
    inside a bin swaps the listed id at any column, its rival unseen in
    the row: two different ids at distances within tolerance count as a
    tie in every column (their number is printed).
    Returns the max distance difference and the number of tie-free keys
    compared."""
    kd = kd.reshape(-1, kd.shape[-1]).float()
    pd = pd.reshape(-1, pd.shape[-1]).float()
    ki = ki.reshape(kd.shape)
    pi = pi.reshape(pd.shape)
    if kd.shape != pd.shape:
        raise SmokeFailure(f"{name}: shapes {tuple(kd.shape)} vs "
                           f"{tuple(pd.shape)}")
    inf_k, inf_p = torch.isinf(kd), torch.isinf(pd)
    if not torch.equal(inf_k, inf_p) or not torch.equal(ki[inf_k],
                                                        pi[inf_p]):
        raise SmokeFailure(f"{name}: invalid slots differ")
    fin = ~inf_p
    diff = (kd - pd).abs()
    diff = torch.where(fin, diff, torch.zeros_like(diff))
    max_err = float(diff.max()) if fin.any() else 0.0
    if isinstance(atol, torch.Tensor):
        atol = atol.reshape(-1, 1).float()
    tol = atol + RTOL * pd.abs().where(fin, torch.zeros_like(pd))
    if bool((diff > tol).any()):
        raise SmokeFailure(f"{name}: distances differ by up to {max_err} "
                           f"(tolerance 1e-4 relative)")
    tied = torch.zeros_like(fin)
    for rd in ((pd, kd) if join else (pd,)):
        gap = (rd[:, 1:] - rd[:, :-1]).abs()
        tied[:, 1:] |= gap <= tol[:, 1:]
        tied[:, :-1] |= gap <= tol[:, :-1]
    if join:
        tied[:, -1] |= (ki[:, -1] != pi[:, -1]) & (diff[:, -1] <= tol[:, -1])
    swaps = 0
    if hidden:
        swapped = fin & ~tied & (ki != pi) & (diff <= tol)
        swaps = int(swapped.sum())
        tied |= swapped
    keyed = fin & ~tied
    n_keyed = int(keyed.sum())
    bad = keyed & (ki != pi)
    n_differ = int(bad.sum())
    log(f"  {name}: max |d| diff {max_err:.3g}, ids differ on {n_differ} "
        f"of {n_keyed} tie-free keys"
        + (f" ({swaps} ids swapped within a bin at distances within "
           f"tolerance)" if hidden else ""))
    if n_differ:
        r, c = [int(v) for v in bad.nonzero()[0]]
        raise SmokeFailure(
            f"{name}: ids differ on tie-free keys, e.g. row {r} column {c}: "
            f"kernel {kd[r, max(c - 1, 0):c + 2].tolist()} "
            f"{ki[r, max(c - 1, 0):c + 2].tolist()}, plain "
            f"{pd[r, max(c - 1, 0):c + 2].tolist()} "
            f"{pi[r, max(c - 1, 0):c + 2].tolist()}")
    return {"max_abs_err": max_err, "tie_free_keys": n_keyed}


def deep_atol(args, kw) -> torch.Tensor:
    """Per-row absolute tolerance of kernel 2's binned_deep Hopper body
    against its plain version under L2, one value a (bucket, query slot)
    row: the tensor cores take each dot's exact products and sum them,
    16 a step, with truncated alignment, so a dot may differ from the
    plain version's by a few f32 ulps of its terms per step, not of the
    (often much smaller) distance. Over 8 steps that stays under 2^-18 of
    the expanded form's terms, ||q - c||^2 + ||x||^2 (the dot's products
    sum to at most their mean): 4e-6 of that scale, with the query's qaux
    and its list's largest norm. Inner product and cosine keep ATOL."""
    from raft_tpu_torch.ops import ivf_scan

    storage, _, _, bl, bq, queries, qaux, norms = args[:8]
    if kw.get("metric_kind") != ivf_scan.L2 or norms is None:
        return torch.full(bq.shape, ATOL, device=bq.device).reshape(-1)
    q = bq.long().clamp_min(0)
    if kw.get("centers") is not None:
        qa = torch.empty(bq.shape, device=bq.device)
        c = kw["centers"].float()
        for b0 in range(0, bq.shape[0], 256):
            r = queries.float()[q[b0:b0 + 256]] - \
                c[bl.long()[b0:b0 + 256]][:, None, :]
            qa[b0:b0 + 256] = (r * r).sum(2)
    else:
        qa = qaux.float()[q]
    xn = norms.float()[bl.long()].amax(1)[:, None]
    return (4e-6 * (qa + xn) + ATOL).reshape(-1)


def pq4_atol(args, kw) -> torch.Tensor:
    """Per-row absolute tolerance of kernel 2's pq4 Hopper body against
    its plain version, one value a (bucket, query slot) row. Each of the
    p k-steps adds one exact bf16 table entry to an f32 sum, in the plain
    version's order, but the tensor cores may truncate that sum where the
    plain version rounds it to nearest: at most 2 ulps of the running sum
    a step, 2^-22 M, where M = sum over s of max over v |lut[q, s, v]|
    bounds every partial sum. By Cauchy-Schwarz M <= ||qv|| W, W =
    sqrt(sum over s of max over v ||pq_centers[s, v]||^2), with 2% for
    the bf16 rounding of qv, the codebook and the entries; qv is q - c of
    the row's list (L2, residual) or q (inner product). A dot then
    differs by at most p 2^-22 M and a distance (2 dot under L2) by p
    2^-21 M, plus ATOL."""
    _, _, _, bl, bq, queries = args[:6]
    q = bq.long().clamp_min(0)
    qf = queries.float()
    c = kw.get("centers")
    rn = torch.empty(bq.shape, device=bq.device)
    for b0 in range(0, bq.shape[0], 256):
        r = qf[q[b0:b0 + 256]]
        if c is not None:
            r = r - c.float()[bl.long()[b0:b0 + 256]][:, None, :]
        rn[b0:b0 + 256] = (r * r).sum(2).sqrt()
    return _pq4_bound(kw["pq_centers"], rn).reshape(-1)


def fold_atol(args, kw) -> torch.Tensor:
    """Per-row absolute tolerance of kernel 1's Hopper fold body against
    its plain version, one value a query, at ``fused_knn_fold``'s ``args``
    (queries, dataset, k) and ``kw``. Each dot's products are exact (bf16
    times bf16 in f32); the tensor cores add them 16 a k-step and may
    truncate where the plain version rounds to nearest: 2 ulps of the
    running sum a step, so d / 16 steps of 2^-22 M, M = sum |q_c x_c| <=
    ||q|| ||x||. The plain version's own sum in its order may round each
    of its d additions, d 2^-24 M. A dot thus differs by at most 1.25 d
    2^-24 ||q|| X, X the dataset's largest row norm (of the bf16 rows the
    body multiplies): twice that for an L2 distance, that for inner
    product, and 1.25 d 2^-24 for cosine (the dot over ||q|| ||x||); plus
    ATOL."""
    from raft_tpu_torch.ops import fused_topk

    queries, dataset = args[:2]
    d = queries.shape[1]
    bound = 1.25 * d * 2.0 ** -24
    mk = kw.get("metric_kind")
    if mk == fused_topk.COSINE:
        return torch.full((queries.shape[0],), bound + ATOL,
                          device=queries.device)
    q = queries.float()
    qn = (q * q).sum(1).sqrt()
    xmax = 0.0
    for r0 in range(0, dataset.shape[0], 1 << 20):
        xb = dataset[r0:r0 + (1 << 20)].to(torch.bfloat16).float()
        xmax = max(xmax, float((xb * xb).sum(1).max()))
    scale = 2.0 if mk == fused_topk.L2 else 1.0       # L2: 2 q.x
    return scale * bound * qn * xmax ** 0.5 + ATOL


def exact_atol(args, kw):
    """Absolute tolerance of kernel 1's exact arm on the Hopper body
    against its plain version, at ``fused_knn_topk``'s ``args`` (queries,
    dataset, k) and ``kw``. Under bf16 queries its dots are the fold
    body's (exact bf16 products, 16 a k-step, sums that may truncate):
    ``fold_atol``, one value a query. Under f32 queries they are 3xTF32:
    each product hi.hi + hi.lo + lo.hi misses lo.lo and the split's own
    rounding, about 2^-22 of |q_c x_c|, and each 16 dims' sum is added to
    the dot at round to nearest, so a dot carries f32 rounding of its
    terms in another order than the plain version's, as the core's dots
    do: compare's ATOL (with 1e-4 relative), no looser."""
    if args[0].dtype == torch.bfloat16:
        return fold_atol(args, kw)
    return ATOL


def scan_tolerance(body: str, args, kw) -> dict:
    """``compare``'s keywords for a launch on ``body`` at ``args``,
    ``kw``: kernel 2's (a key of ``ivf_list_scan_topk.by_body``) or kernel
    1's exact arm on its Hopper body ("exact_hopper", at
    ``fused_knn_topk``'s arguments: ``exact_atol`` under the join rule,
    since a near-tie with the row past the k-th is unseen in the plain
    row) or fold (``fused_knn_topk.by_body``, "fold_hopper", at
    ``fused_knn_fold``'s arguments). The core at ATOL; the Hopper bodies
    over int8, i4 and sign-bit rows (binned_deep "hopper", and the exact
    and binned arms "hopper_exact" and "hopper_binned", whose dots are
    the same) at ``deep_atol``, the pq4 Hopper body at ``pq4_atol`` and
    the fold's Hopper body at ``fold_atol``, all under the join rule; the
    binned arms of the Hopper arms' and pq4 bodies and the fold body (a
    bin, or a lane's stack, lists one or R of its candidates) also hiding
    a near-tied rival (``hidden``)."""
    if body == "core":
        return {"atol": ATOL}
    if body == "exact_hopper":
        return {"atol": exact_atol(args, kw), "join": True}
    atol = {"hopper": deep_atol, "hopper_exact": deep_atol,
            "hopper_binned": deep_atol, "pq4_hopper": pq4_atol,
            "fold_hopper": fold_atol}[body](args, kw)
    return {"atol": atol, "join": True,
            "hidden": body in ("fold_hopper", "hopper_binned") or (
                body == "pq4_hopper" and kw.get("extract", "exact") in (
                    "binned", "binned_deep"))}


def _pq4_bound(pq_centers, rn) -> torch.Tensor:
    """``pq4_atol``'s p 2^-21 1.02 W ||qv|| + ATOL for the residual norms
    ``rn``."""
    pqc = pq_centers.float()
    w = float((pqc * pqc).sum(2).amax(1).sum().sqrt())
    return pqc.shape[0] * 2.0 ** -21 * 1.02 * w * rn + ATOL


def pq4_search_atol(ix, q) -> torch.Tensor:
    """``pq4_atol`` for a pq4 index's search results, one value a query:
    the largest residual norm over the index's lists, in the rotated
    space the search scores in."""
    qr = q.float() @ ix.rotation.float().T
    return _pq4_bound(ix.pq_centers,
                      torch.cdist(qr, ix.centers_rot.float()).amax(1))


def join_atol(q, data, norms, qn, ip) -> torch.Tensor:
    """Per-row absolute tolerance of the local join: its f32 dots are
    summed in other orders by kernel and plain version, so they differ by
    rounding of the terms — ||q||^2 + ||c||^2 for the expanded L2 form,
    ||q|| ||c|| for inner product — not of the (much smaller) distance:
    2e-6 of that scale (about 16 ulps of f32)."""
    cmax = norms.max() if norms is not None else (data * data).sum(1).max()
    if ip:
        qq = (q.float() * q.float()).sum(1)
        return 2e-6 * torch.sqrt(qq * cmax) + ATOL
    return 2e-6 * (qn + cmax) + ATOL


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean milliseconds of ``fn`` on the card (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def scan_with_body(*args, **kw):
    """Kernel 2 on ``args``, ``kw``: (out_d, out_i, the body its launch
    took, a key of ``ivf_list_scan_topk.by_body``)."""
    from raft_tpu_torch.ops import ivf_scan

    before = dict(ivf_scan.ivf_list_scan_topk.by_body)
    kd, ki = ivf_scan.ivf_list_scan_topk(*args, **kw)
    body = next((b for b, c in ivf_scan.ivf_list_scan_topk.by_body.items()
                 if c > before.get(b, 0)), "core")
    return kd, ki, body


def knn_launch(*args, **kw):
    """``fused_knn_topk(*args, **kw)`` and the body its launch took (a key
    of ``fused_knn_topk.by_body``)."""
    from raft_tpu_torch.ops import fused_topk

    counts = fused_topk.fused_knn_topk.by_body
    before = dict(counts)
    out = fused_topk.fused_knn_topk(*args, **kw)
    body = next((b for b, c in counts.items() if c > before.get(b, 0)),
                "core")
    return out, body


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SmokeFailure("no CUDA device: this smoke run needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    log(f"nvidia-smi: {line}")
    return line


def phase_build() -> None:
    from raft_tpu_torch.ops import _build

    stage_set = (_build.FULL, 1, 0)
    secs = _build.build_all(stage_set=stage_set)
    n_libs = sum(len(stage_set) if k in _build.STAGED else 1
                 for k in _build.KERNELS)
    log(f"build: {len(_build.KERNELS)} kernels ({len(_build.STAGED)} also "
        f"by stage), {n_libs} nvcc at once, in {secs:.2f} s")
    for name, out in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))


def phase_small_parity(dev) -> None:
    from raft_tpu_torch.ops import fused_topk, ivf_scan

    g = torch.Generator(device=dev).manual_seed(1)
    log("parity (small, ragged):")
    # (queries, rows) types: f32 x f32, f32 x bf16 (rows widened, queries
    # unrounded) and bf16 x bf16
    for m, n, d, k, mk, qt, dt, filt in [
            (5, 300, 24, 10, fused_topk.L2, F32, F32, False),
            (70, 3000, 33, 100, fused_topk.IP, F32, F32, True),
            (64, 2000, 64, 256, fused_topk.COSINE, F32, F32, False),
            (100, 4000, 128, 10, fused_topk.L2, F32, BF16, True),
            (70, 3000, 40, 64, fused_topk.IP, F32, BF16, False),
            (100, 4000, 128, 10, fused_topk.L2, BF16, BF16, True)]:
        q = torch.randn(m, d, generator=g, device=dev).to(qt)
        x = torch.randn(n, d, generator=g, device=dev).to(dt)
        keep = ((torch.rand(n, generator=g, device=dev) < 0.6).int()
                if filt else None)
        (kd, ki), body = knn_launch(q, x, k, metric_kind=mk, keep=keep)
        pd, pi = fused_topk.fused_knn_topk_plain(q, x, k, metric_kind=mk,
                                                 keep=keep)
        # d 128, k 10 takes the Hopper exact body
        compare(f"fused_knn_topk m={m} n={n} d={d} k={k} metric={mk} "
                f"{str(qt)[6:]} x {str(dt)[6:]} keep={filt} ({body} body)",
                kd, ki, pd, pi,
                **scan_tolerance(body, (q, x, k), {"metric_kind": mk}))

    C, cap, d, nb, G, m = 16, 384, 96, 40, 256, 500
    storage = torch.randn(C, cap, d, generator=g, device=dev)
    ids = torch.arange(C * cap, dtype=torch.int32,
                       device=dev).reshape(C, cap) * 3 + 1
    sizes = torch.randint(0, cap + 1, (C,), generator=g, device=dev,
                          dtype=torch.int32)
    sizes[0], sizes[1] = 0, 3                 # empty list, list shorter than k
    bl = torch.randint(0, C, (nb,), generator=g, device=dev,
                       dtype=torch.int32)
    bl[:2] = torch.tensor([0, 1], device=dev)
    bq = torch.randint(-1, m, (nb, G), generator=g, device=dev,
                       dtype=torch.int32)
    q = torch.randn(m, d, generator=g, device=dev)
    norms = (storage * storage).sum(2)
    qn = (q * q).sum(1)
    keep = (torch.rand(C, cap, generator=g, device=dev) < 0.8).int()
    for mk, qa, xn, kp, k, qt, dt in [
            (ivf_scan.L2, qn, norms, None, 10, F32, F32),
            (ivf_scan.IP, None, None, keep, 50, F32, F32),
            (ivf_scan.COSINE, qn.sqrt(), norms, keep, 256, F32, F32),
            (ivf_scan.L2, qn, norms, keep, 10, F32, BF16),
            (ivf_scan.IP, None, None, None, 64, F32, BF16),
            (ivf_scan.L2, qn, norms, keep, 10, BF16, BF16)]:
        st = storage.to(dt)
        sargs = (st, ids, sizes, bl, bq, q.to(qt), qa, xn, kp)
        kd, ki, body = scan_with_body(*sargs, k=k, metric_kind=mk)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*sargs, k=k,
                                                   metric_kind=mk)
        # bf16 x bf16 at d 96, k 10 takes the Hopper arms' body
        compare(f"ivf_list_scan_topk k={k} metric={mk} {str(qt)[6:]} x "
                f"{str(dt)[6:]} keep={kp is not None} ({body} body)", kd,
                ki, pd, pi, **scan_tolerance(body, sargs,
                                             {"metric_kind": mk}))
    # IVF-Flat's float16 and uint8 rows, scanned as stored
    for dt in (torch.float16, torch.uint8):
        st = (storage.to(dt) if dt == torch.float16 else
              (storage * 30 + 128).clamp(0, 255).to(dt))
        xn = (st.float() ** 2).sum(2)
        for mk, qa, xnorm, kp, k, qt in [
                (ivf_scan.L2, qn, xn, keep, 10, F32),
                (ivf_scan.IP, None, None, None, 64, F32),
                (ivf_scan.L2, qn, xn, None, 10, BF16),
                (ivf_scan.COSINE, qn.sqrt(), xn, keep, 100, BF16)]:
            kd, ki = ivf_scan.ivf_list_scan_topk(st, ids, sizes, bl, bq,
                                                 q.to(qt), qa, xnorm, kp,
                                                 k=k, metric_kind=mk)
            pd, pi = ivf_scan.ivf_list_scan_topk_plain(
                st, ids, sizes, bl, bq, q.to(qt), qa, xnorm, kp, k=k,
                metric_kind=mk)
            compare(f"ivf_list_scan_topk k={k} metric={mk} {str(qt)[6:]} x "
                    f"{str(dt)[6:]} keep={kp is not None}", kd, ki, pd, pi)
    phase_small_parity_int8(dev, g)


def phase_small_parity_int8(dev, g) -> None:
    """Kernel 2's int8 arm with residual queries against its plain
    version: L2 and inner product, with and without keep, k from 1 to
    256, rot off and on multiples of 16, bf16 and f32 operands, empty
    slots, an empty list and one shorter than k."""
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk, int8 rows, residual "
        "queries")
    C, cap, nb, G, m = 12, 384, 30, 256, 400
    for rot, k, mk, filt, cd in [
            (20, 1, ivf_scan.L2, False, "bf16"),
            (20, 10, ivf_scan.IP, True, "f32"),
            (40, 64, ivf_scan.L2, True, "bf16"),
            (40, 256, ivf_scan.IP, False, "bf16"),
            (96, 10, ivf_scan.L2, False, "f32"),
            (96, 10, ivf_scan.L2, True, "bf16"),
            (96, 64, ivf_scan.IP, True, "bf16"),
            (128, 256, ivf_scan.L2, False, "f32"),
            (128, 1, ivf_scan.IP, False, "f32")]:
        cache = torch.randint(-127, 128, (C, cap, rot), generator=g,
                              device=dev, dtype=torch.int8)
        scale = float(torch.rand((), generator=g, device=dev) * 0.05 + 0.01)
        recon = cache.float() * scale
        norms = (recon * recon).sum(2)
        ids = torch.arange(C * cap, dtype=torch.int32,
                           device=dev).reshape(C, cap) * 7 + 3
        sizes = torch.randint(0, cap + 1, (C,), generator=g, device=dev,
                              dtype=torch.int32)
        sizes[0], sizes[1] = 0, 5
        bl = torch.randint(0, C, (nb,), generator=g, device=dev,
                           dtype=torch.int32)
        bl[:2] = torch.tensor([0, 1], device=dev)
        bq = torch.randint(-1, m, (nb, G), generator=g, device=dev,
                           dtype=torch.int32)
        q_rot = torch.randn(m, rot, generator=g, device=dev) * 3
        c_rot = torch.randn(C, rot, generator=g, device=dev)
        kp = ((torch.rand(C, cap, generator=g, device=dev) < 0.8).int()
              if filt else None)
        kw = dict(k=k, metric_kind=mk, compute_dtype=cd, scale=scale)
        if mk == ivf_scan.L2:
            kw["centers"] = c_rot
        xn = norms if mk == ivf_scan.L2 else None
        args = (cache, ids, sizes, bl, bq, q_rot, None, xn, kp)
        kd, ki, body = scan_with_body(*args, **kw)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        # bf16 operands at rot 96 and 128 take the Hopper arms' body
        compare(f"ivf_list_scan_topk int8 rot={rot} k={k} metric={mk} "
                f"keep={filt} {cd} ({body} body)", kd, ki, pd, pi,
                **scan_tolerance(body, args, kw))
    phase_small_parity_packed(dev, g)


def packed_case(g, dev, arm, C, cap, rot, p=0, pl=0):
    """Random storage of one kernel-2 arm on the card with its sidecars:
    (storage, the scan's keyword arguments, the queries' padded width)."""
    def words(nw):
        return torch.randint(-2 ** 31, 2 ** 31 - 1, (C, nw, cap),
                             generator=g, device=dev, dtype=torch.int32)

    if arm == "i8":
        storage = torch.randint(-128, 128, (C, cap, rot), generator=g,
                                device=dev, dtype=torch.int8)
        return storage, dict(scale=torch.rand(
            C, rot, generator=g, device=dev) * 0.05 + 0.01), rot
    if arm == "i4":
        return words(rot // 8), dict(packed_i4=True, scale=torch.rand(
            C, rot, generator=g, device=dev) * 0.2 + 0.05), rot
    if arm == "bits":
        nw = -(-rot // 32)
        return words(nw), dict(packed_bits=True, row_scale=torch.rand(
            C, cap, generator=g, device=dev) + 0.5), nw * 32
    return words(-(-p // 8)), dict(pq_centers=torch.randn(
        p, 16, pl, generator=g, device=dev)), p * pl


def phase_small_parity_packed(dev, g) -> None:
    """Kernel 2's packed arms (i4, RaBitQ sign bits with the row scale,
    pq4) and the int8 arm with per-list scales against their plain
    versions: L2 and inner product, with and without keep, k from 1 to
    256, rot 24 to 128 (RaBitQ at 40 and 100, off a whole word), bf16 and
    f32 operands, empty slots, an empty list and one shorter than k. The
    core's pq4 kernel (f32 operands here) and its plain version sum in
    one order, so they must agree bit for bit; the pq4 Hopper body (bf16
    operands) adds the same entries in the same order but accumulates on
    the tensor cores (``pq4_atol``, with compare's join rule;
    ``phase_small_parity_pq4`` holds its bits on small integers); the
    others sum the dots in other orders (the module's tolerance). A pq4
    call whose tables overflow a block's shared memory must be refused by
    the launch, and the next launch must still run."""
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk packed arms and "
        "per-list scales")
    C, cap, nb, G, m = 12, 384, 30, 256, 400
    L2, IP = ivf_scan.L2, ivf_scan.IP
    for arm, rot, p, pl, k, mk, filt, cd in [
            ("i4", 24, 0, 0, 1, L2, False, "bf16"),
            ("i4", 40, 0, 0, 10, IP, True, "f32"),
            ("i4", 96, 0, 0, 64, L2, True, "bf16"),
            ("i4", 128, 0, 0, 256, L2, False, "f32"),
            ("bits", 40, 0, 0, 10, L2, True, "bf16"),
            ("bits", 96, 0, 0, 256, IP, False, "f32"),
            ("bits", 100, 0, 0, 1, L2, False, "bf16"),
            ("bits", 128, 0, 0, 64, L2, True, "f32"),
            ("pq4", 24, 24, 1, 10, L2, False, "bf16"),
            ("pq4", 96, 96, 1, 256, L2, True, "bf16"),
            ("pq4", 96, 48, 2, 64, IP, False, "f32"),
            ("pq4", 128, 32, 4, 1, L2, True, "f32"),
            ("i8", 40, 0, 0, 10, L2, True, "bf16"),
            ("i8", 96, 0, 0, 256, IP, False, "f32")]:
        storage, kw, width = packed_case(g, dev, arm, C, cap, rot, p, pl)
        ids = torch.arange(C * cap, dtype=torch.int32,
                           device=dev).reshape(C, cap) * 7 + 3
        sizes = torch.randint(0, cap + 1, (C,), generator=g, device=dev,
                              dtype=torch.int32)
        sizes[0], sizes[1] = 0, 5
        bl = torch.randint(0, C, (nb,), generator=g, device=dev,
                           dtype=torch.int32)
        bl[:2] = torch.tensor([0, 1], device=dev)
        bq = torch.randint(-1, m, (nb, G), generator=g, device=dev,
                           dtype=torch.int32)
        pad = width - rot
        q = torch.nn.functional.pad(
            torch.randn(m, rot, generator=g, device=dev) * 3, (0, pad))
        c = torch.nn.functional.pad(
            torch.randn(C, rot, generator=g, device=dev), (0, pad))
        kp = ((torch.rand(C, cap, generator=g, device=dev) < 0.8).int()
              if filt else None)
        kw.update(k=k, metric_kind=mk, compute_dtype=cd)
        xn = None
        if mk == L2:
            kw["centers"] = c
            xn = torch.rand(C, cap, generator=g, device=dev) * 100 + 10
        args = (storage, ids, sizes, bl, bq, q, None, xn, kp)
        kd, ki, body = scan_with_body(*args, **kw)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        name = (f"ivf_list_scan_topk {arm} rot={rot}"
                + (f" p={p}" if arm == "pq4" else "")
                + f" k={k} metric={mk} keep={filt} {cd} ({body} body)")
        compare(name, kd, ki, pd, pi, **scan_tolerance(body, args, kw))
        if arm == "pq4" and body == "core" and \
                not (torch.equal(kd, pd) and torch.equal(ki, pi)):
            raise SmokeFailure(f"{name}: not bit for bit")
    # pq4 tables past a block's shared memory (16 queries x 256 subspaces
    # x 16 f32 entries, k = 256): the launch must refuse with its CUDA
    # error, and leave no error behind for the next launch
    big, big_kw, _ = packed_case(g, dev, "pq4", C, cap, 256, 256, 1)
    try:
        ivf_scan.ivf_list_scan_topk(
            big, ids, sizes, bl, bq, torch.zeros(m, 256, device=dev), None,
            None, None, k=256, metric_kind=IP, compute_dtype="f32", **big_kw)
    except RuntimeError as e:
        log(f"  ivf_list_scan_topk pq4 p=256 k=256 refused: {e}")
    else:
        raise SmokeFailure("ivf_list_scan_topk pq4 p=256 k=256 launched past "
                           "a block's shared memory")
    again = ivf_scan.ivf_list_scan_topk(storage, ids, sizes, bl, bq, q, None,
                                        xn, kp, **kw)
    if not (torch.equal(again[0], kd) and torch.equal(again[1], ki)):
        raise SmokeFailure("ivf_list_scan_topk after the refused launch "
                           "differs from the same call before it")


def binned_case(g, dev, arm, C, cap, rot, p=0, pl=0):
    """Random rows of one storage kind (packed_case's, or dense f32 /
    bf16 rows) with duplicate rows: in every list, position q's row, norm,
    row scale and keep copied to q + 128 and q + 256 (one bin) and to
    q + 1 (the next bin). Returns (storage, keyword arguments, width,
    norms, keep)."""
    if arm in ("f32", "bf16"):
        storage = torch.randn(C, cap, rot, generator=g, device=dev).to(
            F32 if arm == "f32" else BF16)
        kw, width = {}, rot
    else:
        storage, kw, width = packed_case(g, dev, arm, C, cap, rot, p, pl)
    xn = torch.rand(C, cap, generator=g, device=dev) * 100 + 10
    keep = (torch.rand(C, cap, generator=g, device=dev) < 0.8).int()
    rs = kw.get("row_scale")
    for src, dst in ((3, 131), (3, 259), (40, 41), (7, 135), (100, 101)):
        if dst >= cap:
            continue
        if arm in ("f32", "bf16", "i8"):
            storage[:, dst] = storage[:, src]
        else:
            storage[:, :, dst] = storage[:, :, src]
        for side in (xn, keep, rs):
            if side is not None:
                side[:, dst] = side[:, src]
    if arm in ("f32", "bf16"):
        xn = (storage.float() ** 2).sum(2)
    return storage, kw, width, xn, keep


def scan_case(g, dev, arm, cap, rot, p, pl, k, mk, filt, cd, C=12, nb=30,
              G=256, m=400):
    """One small kernel-2 case of the binned and fold phases: binned_case's
    rows of ``arm`` in C lists of capacity ``cap`` (one empty, one of 5
    rows, one full), nb buckets of G query slots (some empty) over m
    queries, residual queries for L2 on the cache kinds. Returns the
    scan's (positional arguments, keyword arguments)."""
    from raft_tpu_torch.ops.ivf_scan import L2

    storage, kw, width, xn, keep = binned_case(g, dev, arm, C, cap, rot, p,
                                               pl)
    ids = torch.arange(C * cap, dtype=torch.int32,
                       device=dev).reshape(C, cap) * 7 + 3
    sizes = torch.randint(0, cap + 1, (C,), generator=g, device=dev,
                          dtype=torch.int32)
    sizes[0], sizes[1], sizes[2] = 0, 5, cap
    bl = torch.randint(0, C, (nb,), generator=g, device=dev,
                       dtype=torch.int32)
    bl[:3] = torch.tensor([0, 1, 2], device=dev)
    bq = torch.randint(-1, m, (nb, G), generator=g, device=dev,
                       dtype=torch.int32)
    pad = width - rot
    q = torch.nn.functional.pad(
        torch.randn(m, rot, generator=g, device=dev) * 3, (0, pad))
    kw.update(k=k, metric_kind=mk, compute_dtype=cd)
    qa = None
    if mk == L2:
        if arm in ("f32", "bf16"):
            qa = (q * q).sum(1)
        else:
            kw["centers"] = torch.nn.functional.pad(
                torch.randn(C, rot, generator=g, device=dev), (0, pad))
    return (storage, ids, sizes, bl, bq, q, qa, xn if mk == L2 else None,
            keep if filt else None), kw


def phase_small_parity_binned(dev) -> None:
    """Kernel 2's binned arms against their plain versions on every
    storage kind (f32, bf16, int8 rows with residual queries and per-list
    scales, i4, sign bits with the row scale, pq4), caps 256 and 384, k 1
    to 64 (binned) and 14 to 256 (binned_deep), L2 and inner product,
    bf16 and f32 operands, a keep filter, empty slots, an empty list and
    one shorter than k, and duplicate rows (equal distances in one bin and
    in neighbouring ones). Each case runs the exact arm too: where the
    exact arm equals its plain version bit for bit, so must the binned
    arm; elsewhere the module's tolerance holds. At cap 128 the arms are
    not eligible: the wrapper refuses them and "auto" routes exact."""
    from raft_tpu_torch.neighbors.common import scan_route
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk binned arms")
    g = torch.Generator(device=dev).manual_seed(11)
    C, nb, G, m = 12, 30, 256, 400
    L2, IP = ivf_scan.L2, ivf_scan.IP
    bit_exact = {}
    for arm, cap, rot, p, pl, k, mk, filt, cd, ex in [
            ("f32", 256, 24, 0, 0, 1, L2, True, "f32", "binned"),
            ("f32", 384, 40, 0, 0, 10, IP, False, "f32", "binned"),
            ("f32", 256, 32, 0, 0, 64, L2, False, "bf16", "binned"),
            ("f32", 384, 128, 0, 0, 256, L2, False, "f32", "binned_deep"),
            ("bf16", 384, 96, 0, 0, 13, L2, True, "bf16", "binned"),
            ("bf16", 256, 64, 0, 0, 30, IP, True, "bf16", "binned_deep"),
            ("i8", 256, 40, 0, 0, 10, L2, True, "bf16", "binned"),
            ("i8", 384, 96, 0, 0, 64, L2, False, "bf16", "binned_deep"),
            ("i4", 384, 96, 0, 0, 10, L2, True, "bf16", "binned"),
            ("i4", 256, 40, 0, 0, 65, IP, False, "f32", "binned_deep"),
            ("bits", 256, 100, 0, 0, 13, L2, True, "bf16", "binned"),
            ("bits", 384, 96, 0, 0, 40, L2, False, "bf16", "binned_deep"),
            ("pq4", 256, 24, 24, 1, 10, L2, True, "bf16", "binned"),
            ("pq4", 384, 96, 96, 1, 30, L2, False, "bf16", "binned_deep"),
            ("pq4", 256, 96, 48, 2, 14, IP, True, "f32", "binned_deep"),
            ("pq4", 256, 96, 96, 1, 256, L2, False, "f32", "binned_deep")]:
        args, kw = scan_case(g, dev, arm, cap, rot, p, pl, k, mk, filt, cd,
                             C, nb, G, m)
        name = (f"ivf_list_scan_topk {ex} {arm} cap={cap} rot={rot}"
                + (f" p={p}" if arm == "pq4" else "")
                + f" k={k} metric={mk} keep={filt} {cd}")
        ed, ei = ivf_scan.ivf_list_scan_topk(*args, **kw)
        epd, epi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        exact_bits = torch.equal(ed, epd) and torch.equal(ei, epi)
        kd, ki, body = scan_with_body(*args, extract=ex, **kw)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, extract=ex, **kw)
        compare(f"{name} ({body} body)", kd, ki, pd, pi,
                **scan_tolerance(body, args, dict(kw, extract=ex)))
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        bit_exact.setdefault(arm, []).append(same)
        # the Hopper bodies accumulate the dots otherwise: their bits are
        # held on small integers (phase_small_parity_deep, _arms, _pq4)
        if exact_bits and not same and body == "core":
            raise SmokeFailure(f"{name}: the exact arm is bit for bit its "
                               "plain version's, the binned arm is not")
    log("  bit for bit per storage kind (binned arm vs plain version): "
        + ", ".join(f"{arm} {sum(v)}/{len(v)}" for arm, v in
                    bit_exact.items()))
    phase_small_parity_deep(dev, g)
    phase_small_parity_arms(dev, g)
    _, ids, sizes, bl, bq = args[:5]
    storage, kw, _, xn, _ = binned_case(g, dev, "f32", C, 128, 24)
    args = (storage, ids[:, :128].contiguous(), sizes.clamp_max(128), bl,
            bq, torch.randn(m, 24, generator=g, device=dev), None, None)
    for ex in ("binned", "binned_deep"):
        try:
            ivf_scan.ivf_list_scan_topk(*args, k=10, metric_kind=IP,
                                        extract=ex)
        except ValueError:
            pass
        else:
            raise SmokeFailure(f"ivf_list_scan_topk {ex} at cap 128 was "
                               "not refused")
    route, arm = scan_route("auto", 10, 128, dev)
    if (route, arm or ivf_scan.resolve_extract(10, 128, G, device=dev)) != \
            ("kernel", "exact"):
        raise SmokeFailure("scan_route at cap 128 did not pick exact")
    log("  cap 128: both arms refused, 'auto' routes the exact kernel")


def small_integers(g, dev, args, kw):
    """The case with every dot exact in any summation order: queries,
    centers, norms and qaux small integers, scales 1, row scales powers of
    two, int8, f32 and bf16 rows in [-20, 20], a pq4 codebook in [-3, 3]
    (i4 and sign words are small already)."""
    def ints(t, lo, hi):
        return torch.randint(lo, hi + 1, t.shape, generator=g,
                             device=dev).to(t.dtype)

    args = list(args)
    # zero columns stay zero (the sign-bit arm's padding)
    args[5] = ints(args[5], -6, 6) * (args[5] != 0)
    for i in (6, 7):
        if args[i] is not None:
            args[i] = ints(args[i], 0, 200)
    if args[0].dtype in (torch.int8, F32, BF16):
        args[0] = ints(args[0], -20, 20)
    if kw.get("centers") is not None:
        kw["centers"] = ints(kw["centers"], -3, 3) * (kw["centers"] != 0)
    if isinstance(kw.get("scale"), torch.Tensor):
        kw["scale"] = torch.ones_like(kw["scale"])
    if kw.get("row_scale") is not None:
        kw["row_scale"] = 2.0 ** ints(kw["row_scale"], -2, 1)
    if kw.get("pq_centers") is not None:
        kw["pq_centers"] = ints(kw["pq_centers"], -3, 3)
    return tuple(args), kw


def phase_small_parity_deep(dev, g) -> None:
    """Kernel 2's binned_deep arm through its Hopper body
    (``csrc/ivf_scan_deep.cuh``) against the plain version: int8 rows with
    residual queries and per-list scales (L2) or scaled queries (inner
    product), one scalar scale and one cosine case, i4 and sign bits with
    the row scale, rot 40 to 128, k 1 to 256, caps 256, 384 and 640,
    with binned_case's duplicate rows, an empty list, one of 5 rows
    (shorter than a 128-row tile), sizes off a multiple of 128, the keep
    filter, empty query slots and G off a multiple of 64. Every launch
    must take the Hopper body. Its dots sum in another order than the
    plain version's, so random cases hold ``compare``'s tolerance with
    equal ids on tie-free keys, and small-integer cases, where every dot
    is exact in any order, must agree bit for bit."""
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk binned_deep, Hopper "
        "body")
    L2, IP, COS = ivf_scan.L2, ivf_scan.IP, ivf_scan.COSINE
    by_body = ivf_scan.ivf_list_scan_topk.by_body
    n_bits = 0
    for arm, cap, rot, k, mk, filt, G, small in [
            ("i8", 256, 96, 14, L2, True, 256, False),
            ("i8", 384, 96, 30, IP, False, 100, False),
            ("i8", 640, 128, 64, L2, True, 200, False),
            ("i8", 384, 128, 256, IP, True, 256, False),
            ("i8 scalar", 640, 96, 40, L2, False, 256, False),
            ("i8 cosine", 384, 128, 30, COS, True, 130, False),
            ("i4", 256, 96, 30, L2, True, 100, False),
            ("i4", 640, 128, 64, IP, False, 256, False),
            ("i4", 384, 40, 256, L2, False, 200, False),
            ("bits", 384, 96, 40, L2, True, 256, False),
            ("bits", 640, 128, 14, IP, False, 100, False),
            ("bits", 256, 100, 64, L2, False, 200, False),
            ("i8", 384, 128, 1, L2, True, 256, False),
            ("i4", 256, 96, 10, IP, False, 100, False),
            ("i8", 384, 96, 10, L2, True, 200, True),
            ("i8", 384, 96, 30, L2, True, 256, True),
            ("i8", 640, 128, 64, IP, False, 100, True),
            ("i8", 256, 128, 256, L2, False, 200, True),
            ("i4", 640, 96, 40, L2, True, 256, True),
            ("i4", 384, 128, 14, IP, False, 100, True),
            ("bits", 384, 96, 40, L2, False, 256, True),
            ("bits", 640, 128, 256, L2, True, 200, True)]:
        kind = arm.split()[0]
        args, kw = scan_case(g, dev, kind, cap, rot, 0, 0, k,
                             IP if mk == COS else mk, filt, "bf16", G=G)
        if arm == "i8 scalar":
            kw["scale"] = 0.0371
        if arm == "i8 cosine":
            q = args[5]
            args = args[:6] + (torch.sqrt((q * q).sum(1)),
                               torch.rand(args[0].shape[:2], generator=g,
                                          device=dev) * 100 + 10, args[8])
            kw["metric_kind"] = COS
        if small:
            args, kw = small_integers(g, dev, args, kw)
        kw["extract"] = "binned_deep"
        name = (f"ivf_list_scan_topk binned_deep (Hopper body) {arm} cap={cap}"
                f" rot={rot} k={k} metric={mk} keep={filt} G={G}"
                + (" small integers" if small else ""))
        before = by_body.get("hopper", 0)
        kd, ki = ivf_scan.ivf_list_scan_topk(*args, **kw)
        if by_body.get("hopper", 0) != before + 1:
            raise SmokeFailure(f"{name}: did not take the Hopper body")
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        compare(name, kd, ki, pd, pi)
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        n_bits += same
        if small and not same:
            raise SmokeFailure(f"{name}: every dot is exact, yet kernel and "
                               "plain version differ")
    log(f"  Hopper body bit for bit on {n_bits} cases (all small-integer "
        "ones among them)")


def phase_small_parity_arms(dev, g) -> None:
    """Kernel 2's exact and binned arms through the Hopper arms' body
    (``csrc/ivf_scan_arms.cuh``) against the plain version: int8 rows with
    residual queries and per-list scales (L2) or scaled queries (inner
    product), one scalar scale and one cosine case a arm, i4 and sign bits
    with the row scale (RaBitQ at rot 100, off a whole word), rot 40 to
    128, k 1 to 64, caps 256, 384 and 640, with binned_case's duplicate
    rows, an empty list, one of 5 rows (shorter than k), sizes off a
    multiple of 128, the keep filter, empty query slots and G off a
    multiple of 64; then IVF-Flat's f32 and bf16 rows with plain queries
    (d 16 to 128, k 1 to 64, L2, inner product and cosine, the same lists,
    slots and filter), on small integers and on f32 rows whose rounding to
    bf16 meets exact ties and values just off them. Every launch must take
    the body ``scan_body`` names: the arms' body, except an exact case at
    cap 390 (not a multiple of 128), one under f32 operands and one at d
    136, which the route leaves to the core. The dots sum in another
    order than the plain version's, so random cases hold ``compare`` at
    ``scan_tolerance`` (for the float kinds too: ``deep_atol`` under L2,
    ATOL else, with the join rule; binned also ``hidden``), and
    small-integer cases, where every dot is exact in any order, must agree
    bit for bit."""
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk exact and binned, "
        "Hopper arms' body")
    L2, IP, COS = ivf_scan.L2, ivf_scan.IP, ivf_scan.COSINE
    by_body = ivf_scan.ivf_list_scan_topk.by_body
    n_bits = n_small = 0
    for ex, arm, cap, rot, k, mk, filt, G, small in [
            ("exact", "i8", 256, 96, 10, L2, True, 256, False),
            ("exact", "i8", 384, 96, 30, IP, False, 100, False),
            ("exact", "i8", 640, 128, 64, L2, True, 200, False),
            ("exact", "i8", 384, 48, 1, L2, False, 130, False),
            ("exact", "i8 scalar", 640, 96, 40, L2, False, 256, False),
            ("exact", "i8 cosine", 384, 128, 30, COS, True, 130, False),
            ("exact", "i4", 256, 96, 10, L2, True, 100, False),
            ("exact", "i4", 640, 128, 64, IP, False, 256, False),
            ("exact", "i4", 384, 40, 1, L2, False, 200, False),
            ("exact", "bits", 384, 96, 40, L2, True, 256, False),
            ("exact", "bits", 640, 128, 14, IP, False, 100, False),
            ("exact", "bits", 256, 100, 64, L2, False, 200, False),
            ("exact", "i8", 390, 96, 10, L2, True, 100, False),
            ("binned", "i8", 256, 96, 10, L2, True, 256, False),
            ("binned", "i8", 384, 128, 13, IP, False, 100, False),
            ("binned", "i8", 640, 96, 64, L2, True, 200, False),
            ("binned", "i8 cosine", 384, 128, 10, COS, False, 130, False),
            ("binned", "i4", 384, 96, 10, L2, True, 256, False),
            ("binned", "i4", 256, 40, 1, IP, False, 100, False),
            ("binned", "bits", 384, 96, 13, L2, False, 200, False),
            ("binned", "bits", 640, 128, 40, IP, True, 256, False),
            ("exact", "i8", 384, 96, 10, L2, True, 200, True),
            ("exact", "i8", 640, 128, 64, IP, False, 100, True),
            ("exact", "i4", 640, 96, 40, L2, True, 256, True),
            ("exact", "i4", 384, 128, 1, IP, False, 130, True),
            ("exact", "bits", 384, 96, 40, L2, False, 256, True),
            ("exact", "bits", 640, 128, 30, L2, True, 200, True),
            ("binned", "i8", 256, 96, 10, L2, True, 256, True),
            ("binned", "i8", 640, 128, 64, IP, False, 100, True),
            ("binned", "i4", 384, 96, 13, L2, False, 200, True),
            ("binned", "i4", 640, 40, 30, IP, True, 130, True),
            ("binned", "bits", 640, 128, 40, L2, True, 256, True),
            ("binned", "bits", 256, 100, 1, IP, False, 100, True),
            # IVF-Flat's f32 and bf16 rows (plain queries)
            ("exact", "f32", 256, 128, 10, L2, True, 256, False),
            ("exact", "f32", 384, 96, 30, IP, False, 100, False),
            ("exact", "f32", 640, 16, 64, L2, True, 200, False),
            ("exact", "f32 cosine", 384, 128, 30, COS, True, 130, False),
            ("exact", "bf16", 384, 128, 10, L2, True, 256, False),
            ("exact", "bf16", 256, 64, 1, IP, False, 100, False),
            ("binned", "f32", 256, 128, 10, L2, True, 256, False),
            ("binned", "f32", 640, 96, 64, IP, False, 200, False),
            ("binned", "f32 cosine", 384, 128, 10, COS, False, 130, False),
            ("binned", "bf16", 384, 128, 13, L2, True, 100, False),
            ("binned", "bf16", 256, 32, 40, IP, True, 256, False),
            ("exact", "f32 nonfinite", 384, 128, 10, L2, True, 200, False),
            ("binned", "f32 nonfinite", 256, 96, 13, L2, True, 130, False),
            ("exact", "f32", 384, 128, 10, L2, True, 200, True),
            ("exact", "bf16", 640, 96, 64, IP, False, 100, True),
            ("exact", "f32 rounding", 384, 128, 30, L2, True, 256, True),
            ("binned", "f32", 256, 128, 10, L2, True, 256, True),
            ("binned", "bf16", 640, 16, 1, L2, False, 130, True),
            ("binned", "f32 rounding", 640, 128, 64, IP, False, 200, True),
            # left to the core: f32 operands; d past 128
            ("exact", "f32 f32-operands", 256, 128, 10, L2, True, 256,
             False),
            ("exact", "f32", 256, 136, 10, L2, True, 256, False)]:
        kind = arm.split()[0]
        cd = "f32" if arm.endswith("f32-operands") else "bf16"
        args, kw = scan_case(g, dev, kind, cap, rot, 0, 0, k,
                             IP if mk == COS else mk, filt, cd, G=G)
        if arm == "i8 scalar":
            kw["scale"] = 0.0371
        if arm.endswith("cosine"):
            q = args[5]
            args = args[:6] + (torch.sqrt((q * q).sum(1)),
                               torch.rand(args[0].shape[:2], generator=g,
                                          device=dev) * 100 + 10, args[8])
            kw["metric_kind"] = COS
        if small:
            args, kw = small_integers(g, dev, args, kw)
        if arm == "f32 nonfinite":
            # filtered rows of NaN, list tails of +inf: each must stay
            # (+inf, -1) whatever its dot
            st, sizes, kp = args[0].clone(), args[2], args[8]
            st[kp == 0] = float("nan")
            tail = torch.arange(cap, device=dev)[None, :] >= \
                sizes.long()[:, None]
            st[tail] = float("inf")
            args = (st,) + args[1:]
        if arm == "f32 rounding":
            # f32 rows whose rounding to bf16 meets exact ties (odd
            # sixteenths in [16, 20], to even) and values just off them
            # (+-2^-9 where |x| >= 8): the rounded rows are multiples of
            # 1/16, so every dot stays exact in any order
            shape = args[0].shape
            x = torch.randint(-320, 321, shape, generator=g,
                              device=dev).float() / 16
            nudge = torch.randint(-1, 2, shape, generator=g,
                                  device=dev).float() * 2.0 ** -9
            args = (x + torch.where(x.abs() >= 8, nudge,
                                    torch.zeros_like(x)),) + args[1:]
        kw["extract"] = ex
        width = args[5].shape[1]
        want = ivf_scan.scan_body(ivf_scan.storage_kind(
            args[0], kw.get("packed_i4", False), kw.get("packed_bits",
                                                        False)),
            cd == "bf16", width, k, ex, cap)
        name = (f"ivf_list_scan_topk {ex} ({want} body) {arm} cap={cap} "
                f"rot={rot} k={k} metric={mk} keep={filt} G={G}"
                + (" small integers" if small else ""))
        if want != ("core" if cap % 128 or cd == "f32" or rot > 128
                    else f"hopper_{ex}"):
            raise SmokeFailure(f"{name}: scan_body routed it to {want}")
        before = by_body.get(want, 0)
        kd, ki = ivf_scan.ivf_list_scan_topk(*args, **kw)
        if by_body.get(want, 0) != before + 1:
            raise SmokeFailure(f"{name}: did not take the {want} body")
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        compare(name, kd, ki, pd, pi, **scan_tolerance(want, args, kw))
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        n_bits += same
        n_small += small
        if small and not same:
            raise SmokeFailure(f"{name}: every dot is exact, yet kernel and "
                               "plain version differ")
    log(f"  Hopper arms' body bit for bit on {n_bits} cases (all {n_small} "
        "small-integer ones among them)")


def phase_small_parity_pq4(dev) -> None:
    """Kernel 2's pq4 arm through its Hopper body
    (``csrc/ivf_scan_pq4.cuh``) against the plain version: the exact,
    binned and binned_deep arms at k 1, 10, 30 and 64, p 24, 48 and 96 at
    pq_len 1 and 2, L2 with residual queries and inner product, caps 256
    to 640 and one off a multiple of 4 (the ring's 4-byte copies), with
    binned_case's duplicate rows, an empty list, one of 5 rows, tails of a
    256-row tile, the keep filter, empty query slots, a padding bucket
    (every slot empty) and G off a multiple of 32. Every launch must take
    the Hopper body. On small integers every table entry and partial sum
    is exact, so kernel and plain version must agree bit for bit; on
    random tables the tensor cores' accumulation holds ``pq4_atol`` with
    compare's join rule. Then a launch past the body's shared memory (p =
    128 at binned_deep, routed to the body by a stand-in for
    ``pq4_body``) must be refused, and the next launch still run."""
    from raft_tpu_torch.ops import ivf_scan

    log("parity (small, ragged): ivf_list_scan_topk pq4, Hopper body")
    g = torch.Generator(device=dev).manual_seed(31)
    L2, IP = ivf_scan.L2, ivf_scan.IP
    by_body = ivf_scan.ivf_list_scan_topk.by_body
    n_bits = 0
    for ex, cap, p, pl, k, mk, filt, G, small in [
            ("exact", 384, 24, 1, 1, L2, True, 256, True),
            ("exact", 256, 48, 2, 64, IP, False, 100, True),
            ("exact", 640, 96, 1, 10, L2, True, 200, True),
            ("exact", 390, 96, 1, 30, L2, True, 130, True),
            ("binned", 384, 96, 1, 10, L2, True, 256, True),
            ("binned", 256, 24, 1, 64, IP, True, 100, True),
            ("binned", 640, 48, 2, 1, L2, False, 200, True),
            ("binned_deep", 384, 96, 1, 30, L2, True, 256, True),
            ("binned_deep", 640, 48, 2, 64, IP, False, 100, True),
            ("binned_deep", 256, 24, 1, 10, L2, True, 200, True),
            ("exact", 384, 96, 1, 10, L2, True, 256, False),
            ("binned", 384, 96, 1, 10, L2, True, 256, False),
            ("binned_deep", 640, 96, 1, 30, L2, True, 200, False),
            ("exact", 256, 48, 2, 64, IP, False, 100, False),
            ("binned_deep", 384, 24, 1, 1, IP, True, 130, False)]:
        args, kw = scan_case(g, dev, "pq4", cap, p * pl, p, pl, k, mk, filt,
                             "bf16", G=G)
        args[4][4] = -1                      # a padding bucket
        if small:
            args, kw = small_integers(g, dev, args, kw)
        kw["extract"] = ex
        name = (f"ivf_list_scan_topk pq4 {ex} (Hopper body) cap={cap} p={p}"
                f" pq_len={pl} k={k} metric={mk} keep={filt} G={G}"
                + (" small integers" if small else ""))
        before = by_body.get("pq4_hopper", 0)
        kd, ki = ivf_scan.ivf_list_scan_topk(*args, **kw)
        if by_body.get("pq4_hopper", 0) != before + 1:
            raise SmokeFailure(f"{name}: did not take the Hopper body")
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        compare(name, kd, ki, pd, pi, **scan_tolerance("pq4_hopper", args,
                                                       kw))
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        n_bits += same
        if small and not same:
            raise SmokeFailure(f"{name}: every table entry and sum is exact, "
                               "yet kernel and plain version differ")
    log(f"  pq4 Hopper body bit for bit on {n_bits} cases (all small-integer "
        "ones among them)")
    big, big_kw = scan_case(g, dev, "pq4", 384, 128, 128, 1, 30, L2, True,
                            "bf16")
    big_kw["extract"] = "binned_deep"
    route = ivf_scan.pq4_body
    ivf_scan.pq4_body = lambda *a: "hopper"
    try:
        ivf_scan.ivf_list_scan_topk(*big, **big_kw)
    except RuntimeError as e:
        log(f"  pq4 Hopper body p=128 binned_deep refused: {e}")
    else:
        raise SmokeFailure("the pq4 Hopper body launched p=128 binned_deep "
                           "past a block's shared memory")
    finally:
        ivf_scan.pq4_body = route
    again = ivf_scan.ivf_list_scan_topk(*args, **kw)
    if not (torch.equal(again[0], kd) and torch.equal(again[1], ki)):
        raise SmokeFailure("the pq4 Hopper body after the refused launch "
                           "differs from the same call before it")


def sorted_rows(d, i):
    """Rows of a fold buffer in (distance, column) order, for ``compare``,
    which reads ties off sorted rows."""
    d2 = d.reshape(-1, d.shape[-1])
    order = torch.sort(d2, dim=1, stable=True).indices
    return d2.gather(1, order), i.reshape(d2.shape).gather(1, order)


def phase_small_parity_fold(dev) -> None:
    """Both fold kernels against their plain versions, unmerged buffers
    bit for bit. Kernel 1: every metric, f32 and bf16 operands, R = 2, 3
    and 4 (k = 10, 130, 200), each tile of ``FUSED_TOPK_TILES``, n off a
    multiple of the tile, with and without a keep filter, on small-integer
    rows and queries (their dots are exact in f32, so any difference is a
    fault of the fold); then random rows, where the exact arm's sums may
    round differently from the plain version's: bit for bit wherever the
    exact arm is, else the merged top-k within tolerance. Kernel 2: every
    storage kind and the pq4 kernel at R = 2 and 4, with an empty list,
    one shorter than k, a keep filter, empty slots and duplicate rows,
    under the same rule as the binned arms (``phase_small_parity_binned``)."""
    from raft_tpu_torch import tuning
    from raft_tpu_torch.neighbors.common import merge_topk
    from raft_tpu_torch.ops import fused_topk, ivf_scan

    log("parity (small, ragged): fold arms")
    g = torch.Generator(device=dev).manual_seed(21)
    n_equal = 0
    for mk in (fused_topk.L2, fused_topk.IP, fused_topk.COSINE):
        for qt in (F32, BF16):
            for k, tile in zip((10, 130, 200), tuning.FUSED_TOPK_TILES):
                m, n, d = 70, 3 * tile + 37, 40
                q = torch.randint(-4, 5, (m, d), generator=g,
                                  device=dev).float().to(qt)
                x = torch.randint(-4, 5, (n, d), generator=g,
                                  device=dev).float().to(qt)
                keep = (torch.rand(n, generator=g, device=dev) < 0.7).int()
                for kp in (None, keep):
                    kw = dict(metric_kind=mk, keep=kp, tile_n=tile)
                    kd, ki = fused_topk.fused_knn_fold(q, x, k, **kw)
                    pd, pi = fused_topk.fused_knn_fold_plain(q, x, k, **kw)
                    name = (f"fused_knn_topk fold m={m} n={n} k={k} tile="
                            f"{tile} metric={mk} {str(qt)[6:]} keep="
                            f"{kp is not None}")
                    if kd.shape != pd.shape or not (
                            torch.equal(kd, pd) and torch.equal(ki, pi)):
                        raise SmokeFailure(f"{name}: the fold buffer is not "
                                           "bit for bit its plain version's")
                    n_equal += 1
    for mk, qt, k, tile in ((fused_topk.L2, F32, 10, 512),
                            (fused_topk.COSINE, BF16, 130, 1024),
                            (fused_topk.IP, F32, 200, 2048)):
        # d = 40: bf16 queries stay on the core's fold here (the Hopper
        # body takes d a multiple of 16; hopper_fold_cases holds it)
        q = torch.randn(100, 40, generator=g, device=dev).to(qt)
        x = torch.randn(5000, 40, generator=g, device=dev).to(qt)
        kd, ki = fused_topk.fused_knn_fold(q, x, k, metric_kind=mk,
                                           tile_n=tile)
        pd, pi = fused_topk.fused_knn_fold_plain(q, x, k, metric_kind=mk,
                                                 tile_n=tile)
        ed = fused_topk.fused_knn_topk(q, x, k, metric_kind=mk)
        ep = fused_topk.fused_knn_topk_plain(q, x, k, metric_kind=mk)
        name = (f"fused_knn_topk fold random rows k={k} tile={tile} "
                f"metric={mk} {str(qt)[6:]}")
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        if torch.equal(ed[0], ep[0]) and torch.equal(ed[1], ep[1]) and \
                not same:
            raise SmokeFailure(f"{name}: the exact arm is bit for bit its "
                               "plain version's, the fold is not")
        compare(name, *merge_topk(kd, ki, k), *merge_topk(pd, pi, k))
        n_equal += same
    log(f"  kernel 1: {n_equal} of {3 * 2 * 3 * 2 + 3} fold buffers equal "
        "bit for bit (every integer case)")
    hopper_fold_cases(dev, g)

    C, nb, G, m = 12, 30, 256, 400
    L2, IP = ivf_scan.L2, ivf_scan.IP
    bit_exact = {}
    for arm, cap, rot, p, pl, k, mk, filt, cd in [
            ("f32", 256, 24, 0, 0, 10, L2, True, "f32"),
            ("f32", 384, 128, 0, 0, 200, IP, False, "bf16"),
            ("bf16", 384, 96, 0, 0, 100, L2, True, "bf16"),
            ("bf16", 256, 64, 0, 0, 256, IP, True, "bf16"),
            ("i8", 256, 40, 0, 0, 10, L2, True, "bf16"),
            ("i8", 384, 96, 0, 0, 200, L2, False, "bf16"),
            ("i4", 384, 96, 0, 0, 30, L2, True, "bf16"),
            ("i4", 256, 40, 0, 0, 200, IP, False, "f32"),
            ("bits", 256, 100, 0, 0, 13, L2, True, "bf16"),
            ("bits", 384, 96, 0, 0, 256, L2, False, "bf16"),
            ("pq4", 256, 24, 24, 1, 10, L2, True, "bf16"),
            ("pq4", 384, 96, 96, 1, 200, L2, False, "bf16"),
            ("pq4", 256, 96, 48, 2, 64, IP, True, "f32")]:
        args, kw = scan_case(g, dev, arm, cap, rot, p, pl, k, mk, filt, cd,
                             C, nb, G, m)
        name = (f"ivf_list_scan_topk fold {arm} cap={cap} rot={rot}"
                + (f" p={p}" if arm == "pq4" else "")
                + f" k={k} metric={mk} keep={filt} {cd}")
        ed, ei = ivf_scan.ivf_list_scan_topk(*args, **kw)
        epd, epi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
        exact_bits = torch.equal(ed, epd) and torch.equal(ei, epi)
        kd, ki = ivf_scan.ivf_list_scan_topk(*args, extract="fold", **kw)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, extract="fold",
                                                   **kw)
        R = fused_topk.fold_depth(k)
        if kd.shape != (nb, G, 128 * R) or kd.shape != pd.shape:
            raise SmokeFailure(f"{name}: shapes {tuple(kd.shape)} vs "
                               f"{tuple(pd.shape)}, want {(nb, G, 128 * R)}")
        same = torch.equal(kd, pd) and torch.equal(ki, pi)
        bit_exact.setdefault(arm, []).append(same)
        if exact_bits and not same:
            raise SmokeFailure(f"{name}: the exact arm is bit for bit its "
                               "plain version's, the fold is not")
        if not same:
            compare(name, *sorted_rows(kd, ki), *sorted_rows(pd, pi))
    log("  kernel 2, bit for bit per storage kind (fold vs plain version): "
        + ", ".join(f"{arm} {sum(v)}/{len(v)}" for arm, v in
                    bit_exact.items()))


def fold_launch(*args, **kw):
    """``fused_knn_fold(*args, **kw)`` and the body its launch took (a
    key of ``fused_knn_topk.by_body``)."""
    from raft_tpu_torch.ops import fused_topk

    counts = fused_topk.fused_knn_topk.by_body
    before = dict(counts)
    out = fused_topk.fused_knn_fold(*args, **kw)
    body = next((b for b, c in counts.items() if c > before.get(b, 0)),
                "core")
    return out, body


def hopper_fold_cases(dev, g) -> None:
    """Kernel 1's fold through the Hopper body against the plain version:
    every metric, bf16 and f32 rows under bf16 queries, R = 2, 3 and 4
    (k = 10, 130, 200), each tile of ``FUSED_TOPK_TILES``, n off a
    multiple of the tile, d = 48 and 128, with and without a keep filter,
    on small-integer rows and queries: buffers bit for bit (their dots are
    exact in f32 in any order). Then random rows at the tolerance of
    ``scan_tolerance("fold_hopper")`` on the buffers' sorted rows, a
    lane's near-tied rival hidden. Every launch must take the body."""
    from raft_tpu_torch import tuning
    from raft_tpu_torch.ops import fused_topk

    n_cases = 0
    for mk in (fused_topk.L2, fused_topk.IP, fused_topk.COSINE):
        for xt in (BF16, F32):
            for k, tile in zip((10, 130, 200), tuning.FUSED_TOPK_TILES):
                for d in (48, 128):
                    m, n = 70, 3 * tile + 37
                    q = torch.randint(-4, 5, (m, d), generator=g,
                                      device=dev).float().to(BF16)
                    x = torch.randint(-4, 5, (n, d), generator=g,
                                      device=dev).float().to(xt)
                    keep = (torch.rand(n, generator=g, device=dev)
                            < 0.7).int()
                    for kp in (None, keep):
                        kw = dict(metric_kind=mk, keep=kp, tile_n=tile)
                        (kd, ki), body = fold_launch(q, x, k, **kw)
                        pd, pi = fused_topk.fused_knn_fold_plain(q, x, k,
                                                                 **kw)
                        name = (f"fused_knn_fold_hopper m={m} n={n} d={d} "
                                f"k={k} tile={tile} metric={mk} rows "
                                f"{str(xt)[6:]} keep={kp is not None}")
                        if body != "fold_hopper":
                            raise SmokeFailure(f"{name}: took the {body} "
                                               "body")
                        if kd.shape != pd.shape or not (
                                torch.equal(kd, pd) and torch.equal(ki, pi)):
                            raise SmokeFailure(f"{name}: the fold buffer is "
                                               "not bit for bit its plain "
                                               "version's")
                        n_cases += 1
    log(f"  kernel 1, Hopper fold body: {n_cases} integer buffers equal bit "
        "for bit")
    for mk, xt, k, tile, d in ((fused_topk.L2, BF16, 10, 2048, 128),
                               (fused_topk.COSINE, BF16, 130, 1024, 64),
                               (fused_topk.IP, F32, 200, 512, 96),
                               (fused_topk.L2, F32, 42, 2048, 128)):
        q = (torch.rand(100, d, generator=g, device=dev) * 255).to(BF16)
        x = (torch.rand(5000, d, generator=g, device=dev) * 255).to(xt)
        if mk != fused_topk.L2:
            q, x = (q.float() - 127.5).to(BF16), (x.float() - 127.5).to(xt)
        kw = dict(metric_kind=mk, tile_n=tile)
        (kd, ki), body = fold_launch(q, x, k, **kw)
        pd, pi = fused_topk.fused_knn_fold_plain(q, x, k, **kw)
        name = (f"fused_knn_fold_hopper random rows d={d} k={k} tile={tile} "
                f"metric={mk} rows {str(xt)[6:]}")
        if body != "fold_hopper":
            raise SmokeFailure(f"{name}: took the {body} body")
        compare(name, *sorted_rows(kd, ki), *sorted_rows(pd, pi),
                **scan_tolerance(body, (q, x, k), kw))


def phase_small_parity_exact(dev) -> None:
    """Kernel 1's exact arm through the Hopper body against the plain
    version: every metric, with and without a keep filter, k = 1, 10, 32,
    33, 42 and 64, f32 queries over f32 and bf16 rows (3xTF32) and bf16
    queries over bf16 and f32 rows (bf16 tensor cores), d from 16 to 128,
    m across a 128-query block's edge and n off any tile or chunk. On
    small integers every product and partial sum is exact (and every lo
    of 3xTF32 0), so outputs equal bit for bit; on random rows (SIFT-like
    magnitudes under L2, normal rows otherwise) within ``exact_atol`` with
    ids equal on tie-free keys. Every launch must take the body; d 136, k
    65 and f16 rows stay on the core."""
    from raft_tpu_torch.ops import fused_topk

    log("parity (small, ragged): kernel 1's exact arm, Hopper body")
    g = torch.Generator(device=dev).manual_seed(31)
    widths = (16, 48, 96, 128, 32, 64, 80, 112)
    types = ((F32, F32), (F32, BF16), (BF16, BF16), (BF16, F32))
    i = 0
    for mk in (fused_topk.L2, fused_topk.IP, fused_topk.COSINE):
        for k in (1, 10, 32, 33, 42, 64):
            for qt, xt in types:
                for filt in (False, True):
                    d, m = widths[i % len(widths)], (70, 131, 200)[i % 3]
                    n = 3000 + 37 * i
                    i += 1
                    q = torch.randint(-4, 5, (m, d), generator=g,
                                      device=dev).float().to(qt)
                    x = torch.randint(-4, 5, (n, d), generator=g,
                                      device=dev).float().to(xt)
                    keep = ((torch.rand(n, generator=g, device=dev) < 0.7)
                            .int() if filt else None)
                    kw = dict(metric_kind=mk, keep=keep)
                    (kd, ki), body = knn_launch(q, x, k, **kw)
                    pd, pi = fused_topk.fused_knn_topk_plain(q, x, k, **kw)
                    name = (f"fused_knn_topk exact m={m} n={n} d={d} k={k} "
                            f"metric={mk} {str(qt)[6:]} x {str(xt)[6:]} "
                            f"keep={filt}")
                    if body != "exact_hopper":
                        raise SmokeFailure(f"{name}: took the {body} body")
                    if not (torch.equal(kd, pd) and torch.equal(ki, pi)):
                        compare(name, kd, ki, pd, pi)
                        raise SmokeFailure(f"{name}: not bit for bit the "
                                           "plain version's")
    log(f"  {i} integer cases equal bit for bit")
    for mk in (fused_topk.L2, fused_topk.IP, fused_topk.COSINE):
        for (qt, xt), k, d in zip(types, (10, 42, 64, 33), (128, 96, 128,
                                                            64)):
            m, n = 300, 20_000 + 13 * d
            if mk == fused_topk.L2:
                q = torch.rand(m, d, generator=g, device=dev) * 255
                x = torch.rand(n, d, generator=g, device=dev) * 255
            else:
                q = torch.randn(m, d, generator=g, device=dev)
                x = torch.randn(n, d, generator=g, device=dev)
            q, x = q.to(qt), x.to(xt)
            keep = (torch.rand(n, generator=g, device=dev) < 0.8).int()
            kw = dict(metric_kind=mk, keep=keep if k == 42 else None)
            (kd, ki), body = knn_launch(q, x, k, **kw)
            pd, pi = fused_topk.fused_knn_topk_plain(q, x, k, **kw)
            name = (f"fused_knn_topk exact random rows d={d} k={k} metric="
                    f"{mk} {str(qt)[6:]} x {str(xt)[6:]}")
            if body != "exact_hopper":
                raise SmokeFailure(f"{name}: took the {body} body")
            compare(name, kd, ki, pd, pi, **scan_tolerance(body, (q, x, k),
                                                           kw))
    for d, k, xt in ((136, 10, F32), (128, 65, F32), (128, 10,
                                                       torch.float16)):
        q = torch.randn(70, d, generator=g, device=dev)
        x = torch.randn(3000, d, generator=g, device=dev).to(xt)
        (kd, ki), body = knn_launch(q, x, k, metric_kind=fused_topk.L2)
        pd, pi = fused_topk.fused_knn_topk_plain(q, x, k,
                                                 metric_kind=fused_topk.L2)
        name = f"fused_knn_topk exact d={d} k={k} rows {str(xt)[6:]}"
        if body != "core":
            raise SmokeFailure(f"{name}: took the {body} body, not the core")
        compare(name + " (core body)", kd, ki, pd, pi)


def compare_exact(name, outs_k, outs_p) -> None:
    """Kernel outputs against the plain version's: every tensor equal."""
    diff = [i for i, (a, b) in enumerate(zip(outs_k, outs_p))
            if a.shape != b.shape or not torch.equal(a, b)]
    log(f"  {name}: {len(outs_k)} outputs, "
        f"{'all equal' if not diff else f'outputs {diff} differ'}")
    if diff or len(outs_k) != len(outs_p):
        raise SmokeFailure(f"{name}: kernel and plain version differ")


def join_case(g, dev, B, C, d, K, n):
    """A local-join input with every hazard planted: empty candidate
    slots, an in-row duplicate, a candidate already on the list, short
    lists, and one row with no valid candidate."""
    x = torch.randn(n, d, generator=g, device=dev)
    q = torch.randn(B, d, generator=g, device=dev)
    cand = torch.randint(-1, n, (B, C), generator=g, device=dev,
                         dtype=torch.int32)
    cur_i = torch.sort(torch.randint(0, n, (B, K), generator=g, device=dev,
                                     dtype=torch.int32), 1).values
    rep = torch.zeros_like(cur_i, dtype=torch.bool)
    rep[:, 1:] = cur_i[:, 1:] == cur_i[:, :-1]
    cur_i[rep] = -1
    live = torch.randint(1, K + 1, (B, 1), generator=g, device=dev)
    cur_i[torch.arange(K, device=dev)[None, :] >= live] = -1
    if C >= 2:
        cand[:, 1] = cand[:, 0]
    if C >= 3:
        cand[:, 2] = cur_i[:, 0]
    cand[-1] = -1
    norms = (x * x).sum(1)
    qn = (q * q).sum(1)
    cur_d = torch.rand(B, K, generator=g, device=dev) * 4.0 * d
    cur_d[cur_i < 0] = float("inf")
    return q, cand, x, norms, cur_d, cur_i, qn


def join_int_case(g, dev, B, C, d, K, n, ip=False):
    """A local-join input on small integers (rows, queries and current
    distances): every dot, norm and distance is an integer that f32 holds
    exactly in any summation order, so kernel and plain version must agree
    bit for bit, ties included. The current lists hold unique ids in no
    order, some of them short."""
    x = torch.randint(-3, 4, (n, d), generator=g, device=dev).float()
    q = torch.randint(-3, 4, (B, d), generator=g, device=dev).float()
    cand = torch.randint(-1, n, (B, C), generator=g, device=dev,
                         dtype=torch.int32)
    cur_i = torch.argsort(torch.rand(B, n, generator=g, device=dev),
                          1)[:, :K].to(torch.int32)
    live = torch.randint(1, K + 1, (B, 1), generator=g, device=dev)
    cur_i[torch.arange(K, device=dev)[None, :] >= live] = -1
    lo = -8 * d if ip else 0
    cur_d = torch.randint(lo, 8 * d, (B, K), generator=g,
                          device=dev).float()
    cur_d[cur_i < 0] = float("inf")
    return q, cand, x, (x * x).sum(1), cur_d, cur_i, (q * q).sum(1)


def join_hazards(g, dev):
    """(name, join_int_case outputs, ip) for the cases a dedup or a
    selection can get wrong."""
    out = []

    def case(name, B, C, d, K, n, ip=False, plant=None):
        q, cand, x, norms, cur_d, cur_i, qn = join_int_case(
            g, dev, B, C, d, K, n, ip)
        if plant is not None:
            plant(q, cand, x, cur_d, cur_i)
            norms, qn = (x * x).sum(1), (q * q).sum(1)
        out.append((f"{name} B={B} C={C} d={d} K={K} n={n} ip={ip}",
                    (q, cand, x, norms, cur_d, cur_i, qn), ip))

    def repeat_list(q, cand, x, cur_d, cur_i):
        K = cur_i.shape[1]
        cand[:, :K] = cur_i[:, torch.randperm(K, generator=g,
                                              device=dev)]

    def twin_rows(q, cand, x, cur_d, cur_i):
        x[x.shape[0] // 2:] = x[:x.shape[0] // 2]

    def zero_rows(q, cand, x, cur_d, cur_i):
        x[:x.shape[0] // 8] = 0.0
        cur_d[:, 0] = torch.where(cur_i[:, 0] >= 0, -0.0, cur_d[:, 0])

    def self_rows(q, cand, x, cur_d, cur_i):
        q.copy_(x[cand[:, 0].long().clamp_min(0)])
        cur_d[:, 0] = torch.where(cur_i[:, 0] >= 0, -0.0, cur_d[:, 0])

    def starved(q, cand, x, cur_d, cur_i):
        cand[::3] = -1

    def sorted_list(name, B, C, d, K, n, ip=False):
        # the list a first join writes: in (distance, id) order, with the
        # distances a join computes; fresh candidates repeat half of it
        from raft_tpu_torch.ops.graph_join import graph_local_join_plain

        q, cand, x, norms, cur_d, cur_i, qn = join_int_case(
            g, dev, B, C, d, K, n, ip)
        cur_d, cur_i = graph_local_join_plain(q, cand, x, norms, cur_d,
                                              cur_i, qn=qn, ip=ip)
        cand = torch.randint(-1, n, (B, C), generator=g, device=dev,
                             dtype=torch.int32)
        cand[:, :K // 2] = cur_i[:, :K // 2]
        out.append((f"{name} B={B} C={C} d={d} K={K} n={n} ip={ip}",
                    (q, cand, x, norms, cur_d, cur_i, qn), ip))

    case("many duplicate ids (n < C)", 32, 200, 32, 32, 48)
    case("candidates repeat the list", 32, 96, 32, 64, 500,
         plant=repeat_list)
    case("equal distances (twin rows)", 32, 100, 32, 32, 300,
         plant=twin_rows)
    case("-0.0 (zero rows)", 32, 100, 32, 32, 300, ip=True,
         plant=zero_rows)
    case("-0.0 (a candidate is the node's row)", 32, 100, 32, 32, 300,
         plant=self_rows)
    case("rows with every candidate -1", 30, 64, 32, 16, 300,
         plant=starved)
    case("C = 0", 16, 0, 32, 24, 300)
    case("K + C = 2048", 8, 1920, 16, 128, 4000)
    case("K + C = 513", 8, 449, 16, 64, 2000)
    case("K + C <= 32", 16, 20, 16, 4, 100)
    case("C off a multiple of 32", 24, 45, 32, 32, 300)
    case("d = 30", 24, 64, 30, 16, 300, plant=repeat_list)
    sorted_list("sorted list (a join's output)", 32, 100, 32, 32, 300)
    sorted_list("sorted list (a join's output)", 32, 100, 32, 32, 300,
                ip=True)
    sorted_list("sorted list (a join's output)", 16, 224, 32, 96, 2000)
    return out


def phase_small_parity_graph(dev) -> None:
    from raft_tpu_torch.ops import beam_step, graph_join

    g = torch.Generator(device=dev).manual_seed(5)
    log("parity (small, ragged): graph_local_join")
    for B, C, d, K, ip, n in [(24, 37, 32, 8, False, 300),
                              (24, 37, 32, 8, True, 300),
                              (9, 5, 16, 32, False, 200),
                              (24, 37, 30, 8, False, 300),
                              (70, 150, 64, 64, False, 900),
                              (20, 40, 16, 1, False, 300),
                              (20, 300, 16, 128, True, 2000)]:
        q, cand, x, norms, cur_d, cur_i, qn = join_case(g, dev, B, C, d, K, n)
        kw = dict(qn=qn, ip=ip)
        kd, ki = graph_join.graph_local_join(q, cand, x, norms, cur_d, cur_i,
                                             **kw)
        pd, pi = graph_join.graph_local_join_plain(q, cand, x, norms, cur_d,
                                                   cur_i, **kw)
        compare(f"graph_local_join B={B} C={C} d={d} K={K} ip={ip}", kd, ki,
                pd, pi, atol=join_atol(q, x, norms, qn, ip), join=True)
    for name, args, ip in join_hazards(g, dev):
        kw = dict(qn=args[-1], ip=ip)
        compare_exact(f"graph_local_join {name}",
                      graph_join.graph_local_join(*args[:-1], **kw),
                      graph_join.graph_local_join_plain(*args[:-1], **kw))

    log("parity (small, ragged): beam_merge_step")
    for L, C, m, width, window in [(16, 32, 128, 4, 2), (12, 20, 100, 3, 2),
                                   (16, 1, 77, 1, 3), (2, 24, 128, 2, 1)]:
        bd = torch.sort(torch.rand(m, L, generator=g, device=dev), 1).values
        bi = torch.randint(0, 5000, (m, L), generator=g, device=dev,
                           dtype=torch.int32)
        be = torch.randint(0, 2, (m, L), generator=g, device=dev,
                           dtype=torch.int32)
        cd = torch.rand(m, C, generator=g, device=dev)
        ci = torch.randint(-1, 5000, (m, C), generator=g, device=dev,
                           dtype=torch.int32)
        r = min(C, L, 3)
        ci[:, :r], cd[:, :r] = bi[:, :r], bd[:, :r]     # duplicate ids
        kw = dict(cand_d=cd, cand_i=ci, width=width, window=window)
        compare_exact(f"beam_merge_step pre-scored L={L} C={C} m={m} "
                      f"width={width} window={window}",
                      beam_step.beam_merge_step(bd, bi, be, **kw),
                      beam_step.beam_merge_step_plain(bd, bi, be, **kw))
    for deg, d, L, m, width, ip, emit, n in [
            (8, 32, 16, 128, 2, False, False, 512),
            (8, 32, 8, 90, 3, True, True, 512),
            (16, 64, 16, 128, 4, False, True, 512),
            (8, 36, 16, 64, 2, False, True, 512),
            (4, 4, 16, 64, 4, False, False, 512),
            (16, 256, 32, 300, 4, True, False, 1000)]:
        _, o_norm, o_id, W = beam_step.packed_row_layout(deg, d, ip)
        pack = torch.randint(-2**31, 2**31 - 1, (n, W), generator=g,
                             device=dev, dtype=torch.int64).to(torch.int32)
        pack[:, o_id:o_id + deg] = torch.randint(
            -1, n, (n, deg), generator=g, device=dev, dtype=torch.int32)
        if not ip:
            pack[:, o_norm:o_norm + deg] = (torch.rand(
                n, deg, generator=g, device=dev) * 100).view(torch.int32)
        qs = (torch.randn(m, d, generator=g, device=dev) * 0.05).to(
            torch.bfloat16)
        par = torch.randint(-1, n, (m, width), generator=g, device=dev,
                            dtype=torch.int32)
        bd = torch.full((m, L), float("inf"), device=dev)
        bi = torch.full((m, L), -1, device=dev, dtype=torch.int32)
        be = torch.zeros((m, L), device=dev, dtype=torch.int32)
        kw = dict(qs=qs, nbr_pack=pack, parents=par, deg=deg, d=d,
                  width=width, ip=ip, emit_cands=emit)
        compare_exact(f"beam_merge_step packed deg={deg} d={d} L={L} m={m} "
                      f"width={width} ip={ip} emit={emit}",
                      beam_step.beam_merge_step(bd, bi, be, **kw),
                      beam_step.beam_merge_step_plain(bd, bi, be, **kw))


def phase_small_search(dev) -> None:
    """The whole search on a small index: the card's kernel path against
    the same index searched on the CPU (plain versions), with the exact
    arm (``local_recall_target=1.0``) and with the binned arm that
    "pallas" takes at the default target on both sides; over f32 rows,
    then over float16 and uint8 datasets, whose rows the index keeps as
    stored (kernel 2's f16 and uint8 storage kinds)."""
    from raft_tpu_torch.neighbors import ivf_flat

    x = sift_like(20_000, 128, seed=3, device=dev)
    q = sift_like(300, 128, seed=4, device=dev)
    log("parity (small IVF-Flat search, card vs CPU):")
    for rows in (torch.float32, torch.float16, torch.uint8):
        data = x.round().to(rows) if rows == torch.uint8 else x.to(rows)
        qr = q.round() if rows == torch.uint8 else q
        ix = ivf_flat.build(ivf_flat.IndexParams(n_lists=64,
                                                 kmeans_n_iters=10),
                            data, device=dev)
        if ix.storage.dtype != rows:
            raise SmokeFailure(f"ivf_flat over {rows} rows stored them as "
                               f"{ix.storage.dtype}")
        cpu_ix = dataclasses.replace(
            ix, **{f: getattr(ix, f).cpu() for f in
                   ("centers", "storage", "indices", "list_sizes",
                    "data_norms")})
        for what, sp in (("exact", ivf_flat.SearchParams(
                n_probes=8, local_recall_target=1.0)),
                         ("binned", ivf_flat.SearchParams(
                             n_probes=8, scan_impl="pallas"))):
            kd, ki = ivf_flat.search(sp, ix, qr, 10)
            pd, pi = ivf_flat.search(sp, cpu_ix, qr.cpu(), 10)
            compare(f"ivf_flat.search 20k x 128 {str(rows)[6:]} rows, 64 "
                    f"lists, {what} arm", kd.cpu(), ki.cpu(), pd, pi)


def phase_small_cagra(dev) -> None:
    """A small CAGRA build on the card through the user's entry point,
    searched on the card (kernels) and, over the same graph, on the CPU
    (plain versions, "pallas_interpret"): recall within 0.01 and most ids equal (one flipped
    near-tie changes the beam's path, so whole searches are compared by
    recall and overlap, not for equality)."""
    from raft_tpu_torch.neighbors import brute_force, cagra

    x = sift_like(20_000, 128, seed=5, device=dev)
    q = sift_like(300, 128, seed=6, device=dev)
    ix = cagra.build(cagra.IndexParams(
        intermediate_graph_degree=64, graph_degree=32,
        graph_build_algo=cagra.build_algo.NN_DESCENT), x, device=dev)
    sp = cagra.SearchParams(n_seeds=64, max_iterations=15)
    _, ki = cagra.search(sp, ix, q, 10)
    cpu_ix = cagra.from_graph(x.cpu(), ix.graph.cpu(), ix.metric,
                              device="cpu")
    # on a CPU index "auto" is the scattered path (the reference's CPU
    # route): the packed path's plain version is named
    _, pi = cagra.search(dataclasses.replace(
        sp, scan_impl="pallas_interpret"), cpu_ix, q.cpu(), 10)
    _, truth = brute_force.knn(q, x, 10, device=dev)
    rk, rp = recall_of(ki, truth), recall_of(pi.to(dev), truth)
    same = float((ki.cpu() == pi).float().mean())
    log(f"parity (small CAGRA search, card vs CPU): 20k x 128, recall@10 "
        f"{rk:.4f} card vs {rp:.4f} CPU, {100 * same:.1f}% of ids equal")
    if abs(rk - rp) > 0.01 or same < 0.9:
        raise SmokeFailure("small CAGRA search: card and CPU disagree")


def recall_of(found, truth) -> float:
    hits = (found.long()[:, :, None] == truth.long()[:, None, :]).any(2)
    return float(hits.sum()) / truth.numel()


def main_path(dev, n=1_000_000, d=128, nq=10_000, n_lists=1024,
              n_probes=64, k=10) -> dict:
    """Build + search + recall, with the kernel inputs captured for the
    per-kernel measurements that follow. The search runs the exact arm
    (``local_recall_target=1.0``); ``default_search`` runs the default."""
    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import fused_topk, ivf_scan

    x = sift_like(n, d, seed=1, device=dev)
    q = sift_like(nq, d, seed=2, device=dev)
    torch.cuda.synchronize()

    # Each kernel wrapper is stood in for by a recorder that keeps the
    # inputs the main path hands it (for the per-kernel measurements).
    # A wrapper counts its launches on the module attribute it is called
    # by, so during the run the recorder carries the count; both counts
    # are set to 0 just before the main path and read just after.
    captured = {}
    wrapped = {}
    for mod, name in ((ivf_scan, "ivf_list_scan_topk"),
                      (fused_topk, "fused_knn_topk")):
        orig = getattr(mod, name)

        def rec(*a, _orig=orig, _name=name, **kw):
            captured[_name] = (a, kw)
            return _orig(*a, **kw)

        rec.launches = 0
        rec.by_body = {}
        orig.launches = 0
        wrapped[name] = (mod, orig, rec)
        setattr(mod, name, rec)
    try:
        t0 = time.perf_counter()
        index = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                               device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sp = ivf_flat.SearchParams(n_probes=n_probes,
                                   local_recall_target=1.0)
        out_d, out_i = ivf_flat.search(sp, index, q, k)
        _, truth = brute_force.knn(q[:1000], x, k, device=dev)
        torch.cuda.synchronize()
        launches = {name: orig.launches + rec.launches
                    for name, (_, orig, rec) in wrapped.items()}
        # kernel 2's launches by body (ivf_list_scan_topk.by_body's keys),
        # and kernel 1's (the recall oracle, fused_knn_topk.by_body's)
        scan_bodies = dict(wrapped["ivf_list_scan_topk"][2].by_body)
        knn_bodies = dict(wrapped["fused_knn_topk"][2].by_body)
    finally:
        for name, (mod, orig, _) in wrapped.items():
            setattr(mod, name, orig)

    log(f"main path: IVF-Flat {n} x {d}, n_lists={n_lists}, cap="
        f"{index.storage.shape[1]}, list sizes {int(index.list_sizes.min())}"
        f"..{int(index.list_sizes.max())}; build {build_s:.2f} s")
    if out_d.shape != (nq, k) or not bool(torch.isfinite(out_d).all()) or \
            bool((out_i < 0).any()):
        raise SmokeFailure("search returned non-finite or missing neighbours")
    found = out_i[:1000].long()
    hits = (found[:, :, None] == truth.long()[:, None, :]).any(2).sum()
    rec = float(hits) / truth.numel()
    log(f"  recall@{k} on 1000 queries vs exact brute force: {rec:.4f}")
    if rec < RECALL_FLOOR:
        raise SmokeFailure(f"recall {rec:.4f} < {RECALL_FLOOR}")
    for name, cnt in launches.items():
        log(f"  {name}: {cnt} launch(es) during the main path")
        if cnt <= 0:
            raise SmokeFailure(f"{name} never launched on the main path")
    log(f"  ivf_list_scan_topk launches by body: {scan_bodies}")
    log(f"  fused_knn_topk launches by body (the recall oracle): "
        f"{knn_bodies}")

    # QPS: median of 5 timed 10k-query batches after a warm-up
    ivf_flat.search(sp, index, q, k)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        ivf_flat.search(sp, index, q, k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  search: {nq} queries in {med * 1e3:.2f} ms (median of 5) -> "
        f"{nq / med:.1f} QPS; batches ms "
        f"{[round(t * 1e3, 3) for t in times]}")
    profile_search(lambda: ivf_flat.search(sp, index, q, k))
    return {"captured": captured, "launches": launches, "build_s": build_s,
            "x": x, "q": q, "truth": truth, "index": index,
            "recall": rec, "qps": nq / med, "scan_bodies": scan_bodies,
            "knn_bodies": knn_bodies}


def profile_search(search) -> None:
    """Where one search batch spends the card's time: device time by
    kernel (torch.profiler) and the device's busy share of the batch's
    wall time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        search()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # kernel rows only (they carry no CPU time), so nothing counts twice
    rows = [(e.key, getattr(e, "self_device_time_total", 0.0))
            for e in prof.key_averages() if e.self_cpu_time_total == 0]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy = sum(t for _, t in rows)
    if not rows:
        log("  profile: the profiler saw no device time (not measured)")
        return
    log(f"  profile of one batch: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({100 * busy / wall_us:.1f}%), idle "
        f"{100 * (1 - busy / wall_us):.1f}%")
    for key, t in rows[:8]:
        log(f"    {t / 1e3:9.3f} ms {100 * t / busy:5.1f}%  {key[:90]}")


def device_ms(fn, symbol: str, reps: int) -> float:
    """Mean device milliseconds of the kernels whose name holds
    ``symbol`` per call of ``fn`` (torch.profiler), free of the host's
    launch overhead that ``cuda_ms`` includes when a kernel is shorter
    than its wrapper; None when the profiler sees no device time."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    if ProfilerActivity.CUDA not in supported_activities():
        return None
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total", 0.0)
             for e in prof.key_averages() if symbol in e.key)
    return us / 1e3 / reps if us > 0 else None


def stage_split(name: str, kern, full_ms: float) -> None:
    """The kernel's time by stage: the builds with only the staging loads
    and epilogue (0) and with the dots too (1), timed on the same inputs
    as the whole kernel."""
    from raft_tpu_torch.ops import _build

    ms = {}
    for st in (0, 1):
        with _build.only_stages(st):
            ms[st] = cuda_ms(kern, reps=10)
    log(f"  {name} by stage: staging loads + epilogue {ms[0]:.3f} ms, "
        f"dots {ms[1] - ms[0]:.3f} ms, top-k selection "
        f"{full_ms - ms[1]:.3f} ms (whole kernel {full_ms:.3f} ms; stage "
        f"builds {ms[0]:.3f} and {ms[1]:.3f} ms)")


# the TPU kernel's arm each kernel-2 storage or extraction arm replaces
_ARM_SITE = {"": "raft_tpu/ops/ivf_scan.py:198",
             "int8": "raft_tpu/ops/ivf_scan.py:302",
             "i4": "raft_tpu/ops/ivf_scan.py:281",
             "raw": "raft_tpu/ops/ivf_scan.py:281",
             "pq4": "raft_tpu/ops/ivf_scan.py:221",
             "rabitq": "raft_tpu/ops/ivf_scan.py:256",
             "binned": "raft_tpu/ops/ivf_scan.py:89",
             "binned_deep": "raft_tpu/ops/ivf_scan.py:123",
             "fold": "raft_tpu/ops/ivf_scan.py:169"}


def scan_work(args, kw):
    """The least work of one kernel-2 call on this run's data: (bytes,
    operations, peak operations per second, what the operations are).
    Probed lists are read once (rows, ids, norms, row scales), queries,
    list sidecars, bucket tables and outputs (k, or the fold's 128 R
    slots, a query row) once; operations count the
    valid (query, row) pairs only: 2 d per pair on the dense, int8, i4 and
    sign-bit arms (bf16 tensor-core rate under bf16 operands, else f32),
    and on the pq4 arm p table adds per pair plus pq_len FMAs per table
    entry of each valid (bucket, query), each at one a lane a clock
    (``H100_F32_ADDS``); the one-hot contraction's tensor-core figure, 2 x
    16 p operations a pair at the bf16 rate, is named beside it."""
    from raft_tpu_torch.ops import ivf_scan

    (storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
     norms, keep) = (list(args) + [None] * 9)[:9]
    pqc = kw.get("pq_centers")
    kind = ivf_scan.storage_kind(storage, kw.get("packed_i4", False),
                                 kw.get("packed_bits", False), pqc)
    C, cap, d = ivf_scan._geometry(storage, kind, pqc)
    w = ivf_scan.out_width(kw["k"], kw.get("extract") or "exact")
    sizes = list_sizes.long()
    valid_q = (bucket_q >= 0).sum(1).long()
    pairs = float((valid_q * sizes[bucket_list.long()]).sum())
    probed = torch.zeros(C, dtype=torch.bool, device=storage.device)
    probed[bucket_list.long()[valid_q > 0]] = True
    probed_rows = int(sizes[probed].sum())
    nb, G = bucket_q.shape
    row_bytes = (d * storage.element_size() if kind in ivf_scan._DENSE
                 else storage.shape[1] * 4)
    row_bytes += 4 + (4 if norms is not None else 0) + (
        4 if kw.get("row_scale") is not None else 0)
    scale = kw.get("scale")
    side = ((C * d * 4 if kw.get("centers") is not None else 0)
            + (C * d * 4 if isinstance(scale, torch.Tensor) else 0)
            + (pqc.numel() * 4 if pqc is not None else 0))
    bytes_ = (probed_rows * row_bytes + queries.shape[0] * d * 4
              + (queries.shape[0] * 4 if qaux is not None else 0) + side
              + nb * 4 + nb * G * 4 + C * 4 + nb * G * w * 8)
    cd = kw.get("compute_dtype") or (
        "bf16" if queries.dtype == torch.bfloat16 else "f32")
    if kind == ivf_scan.PQ4:
        p, _, pl = pqc.shape
        ops = pairs * p + float(valid_q.sum()) * p * 16 * pl
        onehot_ms = 2.0 * 16 * p * pairs / H100_BF16_FLOPS * 1e3
        return bytes_, ops, H100_F32_ADDS, (
            f"{p} table adds a pair at the f32 add rate; the one-hot "
            f"contraction on the bf16 tensor cores {onehot_ms:.3f} ms")
    peak = H100_BF16_FLOPS if cd == "bf16" else H100_F32_FLOPS
    return bytes_, 2.0 * d * pairs, peak, f"{cd} operands"


def measure_ivf(args, kw, launches, arm: str = "",
                plain_reps: int = 2) -> dict:
    """Kernel 2 at a path's captured inputs: agreement with the plain
    version, time, stage split (not for the core's pq4 kernel, which has
    no stage builds; the pq4 Hopper body has them), plain time
    (``plain_reps`` calls after one warm-up) and bound. ``arm`` names the
    storage or extraction arm in the report ("" for the float arm's exact
    extraction); ``"bit_exact"`` says
    whether kernel and plain version agreed bit for bit and ``"body"``
    which body the launch took (neither a key of the JSON line)."""
    from raft_tpu_torch.ops import ivf_scan

    storage, bucket_q, queries = args[0], args[4], args[5]
    k = kw["k"]
    name = "ivf_list_scan_topk" + (f":{arm}" if arm else "")
    log(f"kernel {name} at its path's shapes: storage "
        f"{tuple(storage.shape)} {storage.dtype}, buckets "
        f"{tuple(bucket_q.shape)}, queries {tuple(queries.shape)} "
        f"{queries.dtype}, k={k}, compute {kw.get('compute_dtype')}, "
        f"residual {kw.get('centers') is not None}, extract "
        f"{kw.get('extract', 'exact')}")
    before = ivf_scan.ivf_list_scan_topk.launches
    bodies = dict(ivf_scan.ivf_list_scan_topk.by_body)

    def kern():
        return ivf_scan.ivf_list_scan_topk(*args, **kw)

    def plain():
        return ivf_scan.ivf_list_scan_topk_plain(*args, **kw)

    kd, ki, body = scan_with_body(*args, **kw)
    pd, pi = plain()
    exact = torch.equal(kd, pd) and torch.equal(ki, pi)
    if kw.get("extract") == "fold":
        # the fold's rows are its unextracted slots, sorted for compare
        kd, ki = sorted_rows(kd, ki)
        pd, pi = sorted_rows(pd, pi)
    err = compare(f"{name} (path shapes)", kd, ki, pd, pi,
                  **scan_tolerance(body, args, kw))
    log(f"  {name}: kernel ({body} body) and plain version "
        f"{'equal bit for bit' if exact else 'differ within tolerance'}")
    del kd, ki, pd, pi
    ms = cuda_ms(kern, reps=10)
    if kw.get("pq_centers") is None or body == "pq4_hopper":
        stage_split(name, kern, ms)
    plain_ms = cuda_ms(plain, reps=plain_reps)
    ivf_scan.ivf_list_scan_topk.launches = before   # measurement launches
    ivf_scan.ivf_list_scan_topk.by_body.update(bodies)

    bytes_, ops, peak, what = scan_work(args, kw)
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    log(f"  {name}: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain; "
        f"{ops / 1e9:.1f} G operations ({what}), "
        f"{bytes_ / 1e9:.3f} GB -> bound {max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return {"name": name, "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/" + {
                "hopper": "ivf_scan_deep.cuh",
                "hopper_exact": "ivf_scan_arms.cuh",
                "hopper_binned": "ivf_scan_arms.cuh",
                "pq4_hopper": "ivf_scan_pq4.cuh"}.get(
                    body, "ivf_list_scan_topk.cu"),
            "replaces": _ARM_SITE[arm.split()[0] if arm else ""],
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "bit_exact": exact, "body": body}


def default_search(label: str, first, q, truth, k: int,
                   exact_recall: float, refine=None,
                   exact_refined: float = None, floor: float = None,
                   refined_floor: float = None,
                   raw_floor: float = None) -> dict:
    """One search at the reference's default ``local_recall_target``
    (0.95) on an index an earlier phase built and measured with the exact
    arm: ``first()`` is the search (its first stage where ``refine(cand)``
    re-ranks its candidates to k). Reports recall@k raw (the first k
    columns) and refined, QPS as the median of 5 batches of the whole
    search, launches of kernel 2 by arm during one search (counts set to
    0 just before it, read just after), a profile, and the arm at the
    search's shapes (``measure_ivf``; where the core's arm is not bit for
    bit its plain version, the exact arm on the same inputs must not be
    either; the Hopper bodies, whose dots sum in another order, are held
    to ``scan_tolerance``). Launches are also split by body (the keys of
    ``ivf_list_scan_topk.by_body``).
    Gates, each listed in ``"failed"``: recall within
    ``RECALL_LOSS_BUDGET`` of the exact run's on the same index and
    queries (raw, and refined where refined), and ``floor`` /
    ``refined_floor`` where given; ``raw_floor`` is printed, not held."""
    from raft_tpu_torch.ops import ivf_scan

    captured = {}
    orig, rec = record_scan(captured, lambda a, kw: "scan" not in captured)
    try:
        _, cand = first()
        torch.cuda.synchronize()
        launches = dict(rec.by_arm)
        bodies = dict(rec.by_body)
    finally:
        ivf_scan.ivf_list_scan_topk = orig
    n = truth.shape[0]
    raw = recall_of(cand[:n, :k], truth)

    def run():
        _, c = first()
        return (None, c) if refine is None else refine(c)

    med = statistics.median(timed_batches(run))
    refined = None
    if refine is not None:
        refined = recall_of(run()[1][:n], truth)
    arms = ", ".join(f"{a} {c}" for a, c in launches.items())
    log(f"default search, {label}: {q.shape[0]} queries in "
        f"{med * 1e3:.2f} ms (median of 5) -> {q.shape[0] / med:.1f} QPS; "
        f"kernel 2 launches by arm: {arms}, by body: "
        + ", ".join(f"{b} {c}" for b, c in bodies.items())
        + f"; recall@{k} {raw:.4f} (exact arm "
        f"{exact_recall:.4f})"
        + (f", refined {refined:.4f} (exact arm {exact_refined:.4f})"
           if refine is not None else "")
        + (f"; absolute floor {raw_floor} "
           f"{'met' if raw >= raw_floor else 'not met'} (printed, not held)"
           if raw_floor is not None else ""))
    profile_search(run)
    a, kw = captured["scan"]
    arm = kw.get("extract", "exact")
    if launches.get(arm, 0) <= 0:
        raise SmokeFailure(f"{label}: kernel 2's {arm} arm never launched")
    kern = measure_ivf(a, kw, launches[arm], arm=f"{arm} {label}",
                       plain_reps=1)
    failed = []
    # the Hopper bodies sum the dots in another order (their bits are held
    # on small integers, phase_small_parity_deep, _arms, _pq4); the core's
    # arms keep what the exact arm keeps
    if not kern["bit_exact"] and not any(
            c for b, c in bodies.items() if b != "core"):
        ekw = dict(kw, extract="exact")
        ed, ei = ivf_scan.ivf_list_scan_topk(*a, **ekw)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(*a, **ekw)
        ivf_scan.ivf_list_scan_topk.launches -= 1   # a measurement launch
        if torch.equal(ed, pd) and torch.equal(ei, pi):
            failed.append(f"{label}: the exact arm is bit for bit its plain "
                          f"version's on these inputs, the {arm} arm is not")
        del ed, ei, pd, pi
    if raw < exact_recall - RECALL_LOSS_BUDGET:
        failed.append(f"{label}: recall {raw:.4f} < exact {exact_recall:.4f}"
                      f" - {RECALL_LOSS_BUDGET}")
    if floor is not None and raw < floor:
        failed.append(f"{label}: recall {raw:.4f} < {floor}")
    if refine is not None:
        if refined < exact_refined - RECALL_LOSS_BUDGET:
            failed.append(f"{label}: refined recall {refined:.4f} < exact "
                          f"{exact_refined:.4f} - {RECALL_LOSS_BUDGET}")
        if refined_floor is not None and refined < refined_floor:
            failed.append(f"{label}: refined recall {refined:.4f} < "
                          f"{refined_floor}")
    return {"label": label, "arm": arm, "kernel": kern, "recall": raw,
            "exact_recall": exact_recall, "refined_recall": refined,
            "exact_refined": exact_refined, "qps": q.shape[0] / med,
            "launches": launches, "by_body": bodies, "failed": failed}


def exact_library(queries, dataset, k, kw, block: int = 1024):
    """The bf16 exact arm's yardstick of PyTorch calls, never used by the
    port: in blocks of ``block`` queries, the bf16 distance block
    (``torch.matmul`` of the bf16 operands, the epilogue in f32) and
    ``torch.topk`` of k over it (dots that the bf16 product's output
    rounds to bf16: a yardstick of time, not of the values)."""
    from raft_tpu_torch.ops import fused_topk

    mk = kw["metric_kind"]
    x = dataset.to(torch.bfloat16)
    xn = kw.get("norms")
    if mk != fused_topk.IP and xn is None:
        xn = (x.float() ** 2).sum(1)
    out = []
    for q0 in range(0, queries.shape[0], block):
        qb = queries[q0:q0 + block].to(torch.bfloat16)
        qa = None
        if mk != fused_topk.IP:
            qa = (qb.float() ** 2).sum(1)
            qa = (qa if mk == fused_topk.L2 else qa.sqrt())[:, None]
        dist = fused_topk._epilogue(
            torch.matmul(qb, x.T).float(), mk, qa,
            None if xn is None else xn[None, :])
        if kw.get("keep") is not None:
            dist = torch.where(kw["keep"][None, :] > 0, dist, float("inf"))
        out.append(torch.topk(dist, k, dim=1, largest=False))
        del dist
    return out


def measure_knn(args, kw, launches) -> dict:
    """Kernel 1's exact arm at a path's captured inputs: held against the
    plain version at the tolerance of the body its launch took, timed
    whole and by stage, beside the plain version, the library call (f32:
    ``torch.topk(torch.cdist)``; bf16: ``exact_library``) and the bound:
    the inputs read and the candidates written once against 2 m n d
    operations at the rate of the arithmetic that runs them (bf16 tensor
    cores; f32 operands on the Hopper body three TF32 products at the
    TF32 rate, on the core the f32 CUDA cores; both printed)."""
    from raft_tpu_torch.ops import fused_topk

    queries, dataset, k = args[:3]
    mk = kw["metric_kind"]
    bf16 = queries.dtype == torch.bfloat16
    label = "fused_knn_topk" + (":exact_bf16" if bf16 else "")
    log(f"kernel {label} at its path's shapes: queries "
        f"{tuple(queries.shape)} {queries.dtype}, dataset "
        f"{tuple(dataset.shape)} {dataset.dtype}, k={k}, metric={mk}, "
        f"keep={kw.get('keep') is not None}")
    before = fused_topk.fused_knn_topk.launches

    def kern():
        return fused_topk.fused_knn_topk(*args, **kw)

    def plain():
        return fused_topk.fused_knn_topk_plain(*args, **kw)

    (kd, ki), body = knn_launch(*args, **kw)
    pd, pi = plain()
    err = compare(f"{label} ({body} body, path shapes)", kd, ki, pd, pi,
                  **scan_tolerance(body, args, kw))
    del kd, ki, pd, pi
    reps = 3 if bf16 else 10
    ms = cuda_ms(kern, reps=reps)
    stage_split(label, kern, ms)
    plain_ms = cuda_ms(plain, reps=1 if bf16 else 2)
    fused_topk.fused_knn_topk.launches = before     # measurement launches
    torch.cuda.empty_cache()

    if bf16:
        lib_ms = cuda_ms(lambda: exact_library(queries, dataset, k, kw),
                         reps=1)
    else:
        lib_ms = cuda_ms(lambda: torch.topk(
            torch.cdist(queries.float(), dataset.float()), k,
            largest=False), reps=3)
    torch.cuda.empty_cache()
    m, d = queries.shape
    n = dataset.shape[0]
    bytes_ = (m * d * queries.element_size() + n * d * dataset.element_size()
              + n * 4 + m * 4 + m * k * 8
              + (n * 4 if kw.get("keep") is not None else 0))
    flops = 2.0 * m * n * d
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    if bf16:
        t_ops, arith = flops / H100_BF16_FLOPS * 1e3, "bf16 tensor cores"
    else:
        t_core = flops / H100_F32_FLOPS * 1e3
        t_tf32 = 3 * flops / H100_TF32_FLOPS * 1e3
        log(f"  {label}: the dots' bound {t_core:.3f} ms on the f32 CUDA "
            f"cores, {t_tf32:.3f} ms as 3xTF32 on the tensor cores")
        hopper = body == "exact_hopper"
        t_ops = t_tf32 if hopper else t_core
        arith = "3xTF32" if hopper else "f32 CUDA cores"
    log(f"  {label} ({body}): {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
        f"{lib_ms:.3f} ms library; {flops / 1e9:.1f} GFLOP ({arith}) -> "
        f"{t_ops:.3f} ms, {bytes_ / 1e9:.3f} GB -> {t_bytes:.3f} ms; bound "
        f"{max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    hopper = body == "exact_hopper"
    return {"name": label, "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/" + (
                "fused_exact_hopper.cuh" if hopper else "fused_knn_topk.cu"),
            "replaces": "raft_tpu/ops/fused_topk.py:113",
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "body": body}


def fast_bf_path(dev, x, q, truth, k=10) -> dict:
    """The fast brute force (``brute_force.search(fast=True)``) on the main
    path's rows and queries: bf16 candidates at k_cand = max(4k, k + 32)
    = 42, refined exactly to k. Its default on the card is kernel 1's fold
    at the analytic tile (``fused_fold:2048``) on the Hopper body
    (``fold_hopper``), both asserted from the launch record, counts set to
    0 just before the search and read just after;
    the same call with ``impl="fused_exact"`` runs beside it, then a
    filtered search (kernel 1's exact arm under bf16 with the keep filter),
    whose launch is the one returned for the ``exact_bf16`` row, beside its
    count. Recall@k of each on the truth's queries, QPS (median of 5
    batches), a profile of one fold batch. Gate: the fold's recall no more than 0.01 under the
    exact arm's (the fold's band, tests/test_pallas_parity.py:69-80)."""
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import fused_topk

    index = brute_force.build(x, device=dev)
    captured = {}
    orig = fused_topk.fused_knn_topk

    def rec(*a, **kw):
        impl = f"fused_{kw.get('variant', 'exact')}" + (
            f":{kw['tile_n']}" if kw.get("tile_n") else "")
        captured.setdefault(impl, (a, kw))
        before = rec.launches
        out = orig(*a, **kw)
        rec.by_impl[impl] = rec.by_impl.get(impl, 0) + rec.launches - before
        return out

    # a prefilter keeping ~90% of the rows (the filtered fast search)
    n = x.shape[0]
    kept = torch.rand(n, generator=torch.Generator(device=dev).manual_seed(
        7), device=dev) < 0.9
    bitset = Bitset.from_dense(kept)
    rec.launches = 0
    rec.by_impl = {}
    rec.by_body = {}
    fused_topk.fused_knn_topk = rec
    try:
        _, ids = brute_force.search(index, q, k, fast=True)
        torch.cuda.synchronize()
        launches = dict(rec.by_impl)
        bodies = dict(rec.by_body)
        rec.by_impl.clear()
        rec.by_body.clear()
        _, eids = brute_force.search(index, q, k, fast=True,
                                     impl="fused_exact")
        torch.cuda.synchronize()
        exact_launches = dict(rec.by_impl)
        exact_bodies = dict(rec.by_body)
        rec.by_impl.clear()
        rec.by_body.clear()
        # the bf16 row times the filtered search's launch (with its keep),
        # the one whose launches it reports
        captured.pop("fused_exact")
        _, fids = brute_force.search(index, q, k, fast=True,
                                     prefilter=bitset)
        torch.cuda.synchronize()
        filt_launches = dict(rec.by_impl)
        filt_bodies = dict(rec.by_body)
        rec.by_impl.clear()
        rec.by_body.clear()
        # the filtered exact search (f32, with the keep filter) as truth
        _, ftruth = brute_force.search(index, q[:truth.shape[0]], k,
                                       prefilter=bitset)
        torch.cuda.synchronize()
        ftruth_bodies = dict(rec.by_body)
    finally:
        fused_topk.fused_knn_topk = orig
    log(f"fast brute force (SIFT-1M rows, {q.shape[0]} queries, k={k}): "
        f"default launches {launches} by body {bodies}, impl='fused_exact' "
        f"launches {exact_launches} by body {exact_bodies}, filtered "
        f"launches {filt_launches} by body {filt_bodies}; the filtered "
        f"exact search by body {ftruth_bodies}")
    if launches != {"fused_fold:2048": 1}:
        raise SmokeFailure(f"the default fast brute force took {launches}, "
                           "not one launch of fused_fold:2048")
    if bodies != {"fold_hopper": 1}:
        raise SmokeFailure(f"the default fast brute force's fold took "
                           f"{bodies}, not the Hopper body "
                           "(ops/fused_topk.fold_body)")
    if exact_launches != {"fused_exact": 1}:
        raise SmokeFailure(f"impl='fused_exact' took {exact_launches}")
    if filt_launches != {"fused_exact": 1}:
        raise SmokeFailure(f"the filtered fast search took {filt_launches}")
    nt = truth.shape[0]
    for out in (ids, eids, fids):
        if out.shape != (q.shape[0], k) or bool((out < 0).any()):
            raise SmokeFailure("fast brute force returned missing neighbours")
    if not bool(kept[fids.long()].all()) or not bool(
            kept[ftruth.long().clamp_min(0)].all()):
        raise SmokeFailure("a filtered search returned a filtered-out row")
    rec_fold, rec_exact = recall_of(ids[:nt], truth), recall_of(eids[:nt],
                                                                 truth)
    rec_filt = recall_of(fids[:nt], ftruth)
    runs = {}
    for name, impl in (("fold", "auto"), ("exact", "fused_exact")):
        times = timed_batches(lambda: brute_force.search(
            index, q, k, fast=True, impl=impl))
        runs[name] = q.shape[0] / statistics.median(times)
        log(f"  {name} ({impl}): {q.shape[0]} queries in "
            f"{statistics.median(times) * 1e3:.2f} ms (median of 5) -> "
            f"{runs[name]:.1f} QPS; batches ms "
            f"{[round(t * 1e3, 3) for t in times]}")
    log(f"  recall@{k} on {nt} queries: fold {rec_fold:.4f}, exact arm "
        f"{rec_exact:.4f}; filtered {rec_filt:.4f} against the filtered "
        f"exact search")
    profile_search(lambda: brute_force.search(index, q, k, fast=True))
    failed = []
    if rec_fold < rec_exact - 0.01:
        failed.append(f"fast brute force: fold recall {rec_fold:.4f} < exact"
                      f" arm's {rec_exact:.4f} - 0.01")
    if rec_filt < rec_exact - 0.01:
        failed.append(f"filtered fast brute force: recall {rec_filt:.4f} < "
                      f"the exact arm's unfiltered {rec_exact:.4f} - 0.01")
    # kernel 1's exact arm takes the Hopper body at the fast path's
    # impl="fused_exact" launch, the filtered search's and the filtered
    # exact search's (ops/fused_topk.exact_body)
    for label, got in (("impl='fused_exact'", exact_bodies),
                       ("the filtered fast search", filt_bodies),
                       ("the filtered exact search", ftruth_bodies)):
        if got != {"exact_hopper": 1}:
            failed.append(f"{label}: kernel 1's exact arm took {got}, not "
                          "the Hopper body")
    del index
    torch.cuda.empty_cache()
    return {"captured": captured["fused_fold:2048"],
            "launches": launches["fused_fold:2048"],
            "exact_captured": captured["fused_exact"],
            "exact_launches": filt_launches["fused_exact"],
            "filtered_recall": rec_filt, "recall": rec_fold,
            "exact_recall": rec_exact, "qps": runs["fold"],
            "exact_qps": runs["exact"], "failed": failed}


def fold_library(queries, dataset, k, kw, block: int = 1024):
    """The fold's yardstick of PyTorch calls, never used by the port: in
    blocks of ``block`` queries, the bf16 distance block (``torch.matmul``
    of the bf16 operands, the epilogue in f32), padded to whole tiles with
    +inf, and ``torch.topk`` of R over each lane's chunks: the lane
    stacks' distances, but from dots that the bf16 product's output rounds
    to bf16 (a yardstick of time, not of the values)."""
    from raft_tpu_torch.ops import fused_topk

    mk, tile = kw["metric_kind"], kw["tile_n"]
    R = fused_topk.fold_depth(k)
    x = dataset.to(torch.bfloat16)
    n = x.shape[0]
    pad = -n % tile
    xn = kw.get("norms")
    if mk != fused_topk.IP and xn is None:
        xn = (x.float() ** 2).sum(1)
    out = []
    for q0 in range(0, queries.shape[0], block):
        qb = queries[q0:q0 + block].to(torch.bfloat16)
        qa = None
        if mk != fused_topk.IP:
            qa = (qb.float() ** 2).sum(1)
            qa = qa if mk == fused_topk.L2 else qa.sqrt()
            qa = qa[:, None]
        dist = fused_topk._epilogue(
            torch.matmul(qb, x.T).float(), mk, qa,
            None if xn is None else xn[None, :])
        dist = torch.nn.functional.pad(dist, (0, pad), value=float("inf"))
        dist = dist.reshape(qb.shape[0], -1, tile // 128, 128)
        out.append(torch.topk(dist, R, dim=2, largest=False).values)
        del dist
    return out


def measure_knn_fold(args, kw, launches) -> dict:
    """Kernel 1's fold at the fast path's captured inputs: its unmerged
    buffer against the plain version's, held at the tolerance of the body
    its launch took (``scan_tolerance``): bit for bit, else -- where the
    core's fold is not bit for bit and its exact arm is not either, or on
    the Hopper body, whose sums take another order -- the merged top-k
    within tolerance. Time, stage split, plain time, bound and the
    library yardstick (``fold_library``). The bound's bytes are the
    inputs read once plus the candidate buffer written once; its
    operations 2 d a (query, row) pair at the operands' rate."""
    from raft_tpu_torch.neighbors.common import merge_topk
    from raft_tpu_torch.ops import fused_topk

    queries, dataset, k = args[:3]
    fkw = {key: v for key, v in kw.items() if key != "variant"}
    log(f"kernel fused_knn_topk:fold at the fast path's shapes: queries "
        f"{tuple(queries.shape)} {queries.dtype}, dataset "
        f"{tuple(dataset.shape)} {dataset.dtype}, k={k}, tile_n="
        f"{fkw['tile_n']}, R={fused_topk.fold_depth(k)}")
    before = fused_topk.fused_knn_topk.launches

    def kern():
        return fused_topk.fused_knn_fold(*args, **fkw)

    def plain():
        return fused_topk.fused_knn_fold_plain(*args, **fkw)

    (kd, ki), body = fold_launch(*args, **fkw)
    pd, pi = plain()
    exact = kd.shape == pd.shape and torch.equal(kd, pd) and \
        torch.equal(ki, pi)
    width = kd.shape[1]
    if exact:
        err = {"max_abs_err": 0.0}
        log(f"  fused_knn_topk:fold ({body}): [{queries.shape[0]}, {width}] "
            "buffer equal bit for bit to the plain version's")
    else:
        if body == "core":
            ed, ei = fused_topk.fused_knn_topk(*args, **dict(fkw,
                                                             tile_n=None))
            epd, epi = fused_topk.fused_knn_topk_plain(*args, **dict(
                fkw, tile_n=None))
            if torch.equal(ed, epd) and torch.equal(ei, epi):
                raise SmokeFailure("fused_knn_topk:fold: the exact arm is "
                                   "bit for bit its plain version's, the "
                                   "fold is not")
            del ed, ei, epd, epi
        err = compare(f"fused_knn_topk:fold ({body}, path shapes, merged)",
                      *merge_topk(kd, ki, k), *merge_topk(pd, pi, k),
                      **scan_tolerance(body, args, fkw))
    del kd, ki, pd, pi
    torch.cuda.empty_cache()
    ms = cuda_ms(kern, reps=5)
    stage_split("fused_knn_topk:fold", kern, ms)
    plain_ms = cuda_ms(plain, reps=1)
    fused_topk.fused_knn_topk.launches = before     # measurement launches
    torch.cuda.empty_cache()
    lib_ms = cuda_ms(lambda: fold_library(queries, dataset, k, fkw), reps=1)
    torch.cuda.empty_cache()

    m, d = queries.shape
    n = dataset.shape[0]
    bytes_ = (m * d * queries.element_size() + n * d * dataset.element_size()
              + n * 4 + m * 4 + m * width * 8
              + (n * 4 if fkw.get("keep") is not None else 0))
    flops = 2.0 * m * n * d
    bf16 = torch.bfloat16 in (queries.dtype, dataset.dtype)
    peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    log(f"  fused_knn_topk:fold ({body}): {ms:.3f} ms kernel, {plain_ms:.3f}"
        f" ms plain, {lib_ms:.3f} ms torch.matmul+topk(R); "
        f"{flops / 1e9:.1f} GFLOP ({'bf16' if bf16 else 'f32'}) -> "
        f"{t_ops:.3f} ms, {bytes_ / 1e9:.3f} GB ({m * width * 8 / 1e9:.3f} GB"
        f" of candidates) -> {t_bytes:.3f} ms; bound "
        f"{max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    hopper = body == "fold_hopper"
    return {"name": "fused_knn_topk:fold" + ("_hopper" if hopper else ""),
            "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/" + (
                "fused_fold_hopper.cuh" if hopper else "fused_knn_topk.cu"),
            "replaces": "raft_tpu/ops/fused_topk.py:102",
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "body": body}


def fold_table_searches(runs) -> list:
    """Searches under a dispatch table that names kernel 2's fold: a table
    written to a temporary file (backend "cuda", one ``ivf_scan_extract``
    entry a search key {cap, k, g}, winner "fold", no times) is made the
    active table, each ``(label, key, kwargs)`` of ``runs`` is run by
    ``default_search`` (its arm recorded, which must be the fold), and the
    default table path is restored."""
    import os
    import shutil
    import tempfile

    from raft_tpu_torch import tuning
    from raft_tpu_torch.tuning.table import DispatchTable

    tmp = tempfile.mkdtemp(prefix="fold_table_")
    path = os.path.join(tmp, "cuda_fold.json")
    DispatchTable({"version": 1, "backend": "cuda", "ops": {
        "ivf_scan_extract": {"entries": [
            {"key": key, "winner": "fold", "times_ms": {}}
            for _, key, _ in runs]}}, "budgets": {}}).save(path)
    out = []
    tuning.set_table_path(path)
    try:
        for label, key, kw in runs:
            log(f"fold table entry {key}:")
            res = default_search(label, **kw)
            if res["arm"] != "fold":
                raise SmokeFailure(f"{label}: took {res['arm']} under the "
                                   "fold table")
            out.append(res)
            torch.cuda.empty_cache()
    finally:
        tuning.set_table_path(None)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def cagra_path(dev, x, q, truth, k=10) -> dict:
    """CAGRA on the main path's rows: nn-descent build -> optimize ->
    packed layout through ``cagra.build``, each part timed; one search of
    the 10k queries, recall, QPS and a profile; the kernels' inputs
    captured for the per-kernel measurements."""
    from raft_tpu_torch.neighbors import cagra, nn_descent
    from raft_tpu_torch.ops import beam_step, graph_join

    join, beam = graph_join.graph_local_join, beam_step.beam_merge_step
    captured, secs, packed_calls = {}, {}, [0]

    def rec_join(*a, **kw):
        # the last full-size block (the join's, not the init's)
        if a[1].numel() >= captured.get("join_size", 0):
            captured["join"] = (a, kw)
            captured["join_size"] = a[1].numel()
        return join(*a, **kw)

    def rec_beam(*a, **kw):
        if kw.get("qs") is not None:
            packed_calls[0] += 1
            if packed_calls[0] == 8:        # a step in mid-search
                captured["beam"] = (a, kw)
        return beam(*a, **kw)

    def timed(name, fn):
        def run(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            secs[name] = time.perf_counter() - t0
            captured[name] = out
            return out
        return run

    patches = [(nn_descent, "graph_local_join", rec_join),
               (cagra, "beam_merge_step", rec_beam),
               (nn_descent, "build", timed("nn-descent", nn_descent.build)),
               (cagra, "optimize", timed("optimize", cagra.optimize)),
               (cagra, "_attach_inline", timed("pack", cagra._attach_inline))]
    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
    for mod, name, fn in patches:
        setattr(mod, name, fn)
    sp = cagra.SearchParams(n_seeds=64, max_iterations=15)
    params = cagra.IndexParams(
        intermediate_graph_degree=64, graph_degree=32,
        graph_build_algo=cagra.build_algo.NN_DESCENT,
        nn_descent_niter=NN_DESCENT_NITER)
    try:
        join.launches = beam.launches = 0
        t0 = time.perf_counter()
        index = cagra.build(params, x, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        join_build, beam_build = join.launches, beam.launches
        out_d, out_i = cagra.search(sp, index, q, k)
        torch.cuda.synchronize()
        launches = {"graph_local_join": join.launches,
                    "beam_merge_step": beam.launches}
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    log(f"CAGRA path: {x.shape[0]} x {x.shape[1]}, nn-descent (degree 64, "
        f"{NN_DESCENT_NITER} iterations at most) -> graph_degree "
        f"{index.graph_degree}, packed rows of {index.nbr_pack.shape[1]} "
        f"words; build {build_s:.2f} s (nn-descent {secs['nn-descent']:.2f} "
        f"s, optimize {secs['optimize']:.2f} s, pack {secs['pack']:.2f} s)")
    log(f"  launches: graph_local_join {join_build} per build, "
        f"beam_merge_step {launches['beam_merge_step'] - beam_build} per "
        f"search of {q.shape[0]} queries")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise SmokeFailure(f"{name} never launched on the CAGRA path")
    if out_d.shape != (q.shape[0], k) or \
            not bool(torch.isfinite(out_d).all()) or bool((out_i < 0).any()):
        raise SmokeFailure("CAGRA search returned non-finite or missing "
                           "neighbours")
    rec = recall_of(out_i[:truth.shape[0]], truth)
    log(f"  recall@{k} on {truth.shape[0]} queries vs exact brute force: "
        f"{rec:.4f}")
    if rec < RECALL_FLOOR:
        raise SmokeFailure(f"CAGRA recall {rec:.4f} < {RECALL_FLOOR}")

    cagra.search(sp, index, q, k)
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        cagra.search(sp, index, q, k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times)
    log(f"  search: {q.shape[0]} queries in {med * 1e3:.2f} ms (median of 5) "
        f"-> {q.shape[0] / med:.1f} QPS; batches ms "
        f"{[round(t * 1e3, 3) for t in times]}")
    profile_search(lambda: cagra.search(sp, index, q, k))

    # the nn-descent graph's own recall against the exact neighbours of
    # 1,000 sampled nodes, and the same build at the reference's default
    # of 20 iterations (reported, not gated)
    g_rec = graph_recall(x, captured.pop("nn-descent").graph)
    del captured["optimize"], captured["pack"]
    # cagra.build at nn_descent_niter=20, its parts called one by one
    t0 = time.perf_counter()
    nd20 = nn_descent.build(nn_descent.IndexParams(
        graph_degree=params.intermediate_graph_degree, max_iterations=20),
        x, device=dev)
    ix20 = cagra.from_graph(x, cagra.optimize(nd20.graph,
                                              params.graph_degree),
                            device=dev)
    torch.cuda.synchronize()
    b20 = time.perf_counter() - t0
    _, i20 = cagra.search(sp, ix20, q[:truth.shape[0]], k)
    log(f"  nn-descent graph recall@64 on 1000 sampled nodes: {g_rec:.4f}; "
        f"at 20 iterations (the reference's default, not gated): graph "
        f"recall@64 {graph_recall(x, nd20.graph):.4f}, build {b20:.2f} s, "
        f"search recall@{k} {recall_of(i20, truth):.4f}")
    del ix20, nd20
    return {"captured": captured, "launches": launches, "build_s": build_s,
            "secs": secs, "recall": rec, "qps": q.shape[0] / med,
            "graph_recall": g_rec}


def measure_join(args, kw, launches) -> dict:
    from raft_tpu_torch.ops import _build, graph_join

    q, cand, data, norms, cur_d, cur_i = args
    B, C = cand.shape
    K = cur_d.shape[1]
    d = data.shape[1]
    log(f"kernel graph_local_join at the main path's shapes: block of {B} "
        f"rows, C={C} candidates, K={K}, d={d}, data {tuple(data.shape)}")
    fn = graph_join.graph_local_join
    before = fn.launches

    def kern():
        return graph_join.graph_local_join(*args, **kw)

    def plain():
        return graph_join.graph_local_join_plain(*args, **kw)

    kd, ki = kern()
    pd, pi = plain()
    err = compare("graph_local_join (main-path shapes)", kd, ki, pd, pi,
                  atol=join_atol(q, data, norms, kw["qn"], kw["ip"]),
                  join=True)
    call_ms = cuda_ms(kern, reps=10)
    dev_ms = device_ms(kern, "graph_local_join_kernel", reps=10)
    ms = call_ms if dev_ms is None else dev_ms
    plain_ms = cuda_ms(plain, reps=2)
    split = {}
    for st in (0, 1):
        with _build.only_stages(st):
            split[st] = cuda_ms(kern, reps=10)
    fn.launches = before                        # measurement launches
    log(f"  graph_local_join by stage: candidate rows gathered "
        f"{split[0]:.3f} ms, scores {split[1] - split[0]:.3f} ms, merge "
        f"{call_ms - split[1]:.3f} ms (a call {call_ms:.3f} ms; stage "
        f"builds {split[0]:.3f} and {split[1]:.3f} ms)")

    # the least time for this block: node rows, candidate ids and lists
    # read once, every referenced data row and norm read once, the merged
    # lists written once; dots for the valid candidates
    valid = cand[cand >= 0].long()
    rows = int(torch.unique(valid).numel())
    bytes_ = (B * d * 4 + B * 4 + B * C * 4 + rows * (d * 4 + 4)
              + 2 * B * K * 8)
    flops = 2.0 * d * valid.numel()
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_F32_FLOPS * 1e3
    gather = valid.numel() * d * 4
    log(f"  graph_local_join: {ms:.3f} ms kernel on the device "
        f"({call_ms:.3f} ms a call, launch included), {plain_ms:.3f} ms "
        f"plain; {flops / 1e9:.2f} GFLOP f32, {bytes_ / 1e9:.3f} GB ({rows} "
        f"distinct data rows) -> bound {max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}); a row read per "
        f"reference would be {gather / 1e9:.2f} GB = "
        f"{gather / H100_HBM_BYTES_PER_S * 1e3:.3f} ms")
    return {"name": "graph_local_join", "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/graph_local_join.cu",
            "replaces": "raft_tpu/ops/graph_join.py:106",
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def measure_beam(args, kw, launches) -> dict:
    from raft_tpu_torch.ops import beam_step

    buf_d = args[0]
    m, L = buf_d.shape
    qs, pack, par = kw["qs"], kw["nbr_pack"], kw["parents"]
    deg, d, width, ip = kw["deg"], kw["d"], kw["width"], kw["ip"]
    log(f"kernel beam_merge_step at the main path's shapes: m={m}, L={L}, "
        f"width={width}, deg={deg}, d={d}, packed rows {tuple(pack.shape)}")
    fn = beam_step.beam_merge_step
    before = fn.launches

    def kern():
        return beam_step.beam_merge_step(*args, **kw)

    def plain():
        return beam_step.beam_merge_step_plain(*args, **kw)

    outs_k, outs_p = kern(), plain()
    compare_exact("beam_merge_step (main-path shapes)", outs_k, outs_p)
    fin = torch.isfinite(outs_p[0])
    err = float((outs_k[0] - outs_p[0]).abs()[fin].max()) if fin.any() \
        else 0.0
    call_ms = cuda_ms(kern, reps=20)
    dev_ms = device_ms(kern, "beam_step_kernel", reps=20)
    ms = call_ms if dev_ms is None else dev_ms
    plain_ms = cuda_ms(plain, reps=3)
    fn.launches = before                        # measurement launches

    # the least time: buffers in and out, the query, the parents, and the
    # used words (codes, norms, ids) of every distinct parent row once;
    # two operations per byte product for each (query, valid parent)
    dw, _, _, _ = beam_step.packed_row_layout(deg, d, ip)
    used = dw + deg * (1 if ip else 2)
    rows = int(torch.unique(par[par >= 0]).numel())
    n_par = int((par >= 0).sum())
    bytes_ = (2 * m * L * 12 + m * d * 2 + 2 * m * width * 4
              + rows * used * 4)
    flops = 2.0 * deg * d * n_par
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / H100_BF16_FLOPS * 1e3
    gather = n_par * pack.shape[1] * 4
    log(f"  beam_merge_step: {ms:.4f} ms kernel on the device "
        f"({call_ms:.4f} ms a call, launch included), {plain_ms:.3f} ms "
        f"plain; {flops / 1e9:.2f} GFLOP (bf16 products), "
        f"{bytes_ / 1e9:.4f} GB "
        f"({rows} distinct parent rows of {n_par}) -> bound "
        f"{max(t_bytes, t_ops):.4f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'}); a row read per "
        f"(query, parent) would be {gather / 1e9:.3f} GB = "
        f"{gather / H100_HBM_BYTES_PER_S * 1e3:.4f} ms")
    return {"name": "beam_merge_step", "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/cagra_beam_step.cu",
            "replaces": "raft_tpu/ops/beam_step.py:192",
            "launches": launches, "max_abs_err": err,
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def phase_small_ivf_pq(dev) -> None:
    """IVF-PQ built on the card through the user's entry point and
    searched there (kernel 2's int8 arm) and, over the same index, on the
    CPU (its plain version, "pallas_interpret"): L2 and inner product,
    the exact arm and the binned one. Both paths compute the same residual queries; the kernel
    and the plain version sum the f32 products in other orders, so the
    tolerance is the module's."""
    from raft_tpu_torch.distance.types import DistanceType
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_scan

    x = sift_like(20_000, 96, seed=7, device=dev)
    q = sift_like(300, 96, seed=8, device=dev)
    log("parity (small IVF-PQ search, card vs CPU):")
    for metric in (DistanceType.L2Expanded, DistanceType.InnerProduct):
        ix = ivf_pq.build(ivf_pq.IndexParams(
            n_lists=64, pq_dim=48, kmeans_n_iters=10, metric=metric), x,
            device=dev)
        if ix.cache_kind != "i8":
            raise SmokeFailure(f"small IVF-PQ: cache {ix.cache_kind}, not i8")
        for what, sp in (("exact", ivf_pq.SearchParams(
                n_probes=8, local_recall_target=1.0)),
                         ("binned", ivf_pq.SearchParams(
                             n_probes=8, scan_impl="pallas"))):
            before = ivf_scan.ivf_list_scan_topk.launches
            bodies = dict(ivf_scan.ivf_list_scan_topk.by_body)
            kd, ki = ivf_pq.search(sp, ix, q, 10)
            if ivf_scan.ivf_list_scan_topk.launches != before + 1:
                raise SmokeFailure("small IVF-PQ search did not launch "
                                   "kernel 2")
            body = next((b for b, c in
                         ivf_scan.ivf_list_scan_topk.by_body.items()
                         if c > bodies.get(b, 0)), "core")
            # on a CPU index "auto" is the decode body (the reference's
            # CPU route): the kernel's plain version is named
            pd, pi = ivf_pq.search(dataclasses.replace(
                sp, scan_impl="pallas_interpret"), cpu_copy(ix), q.cpu(), 10)
            # the Hopper arms' body (rot 96, bf16) sums the dots in another
            # order: compare's join rule, and a bin's hidden rival
            compare(f"ivf_pq.search 20k x 96, 64 lists, {metric.name}, "
                    f"{what} arm ({body} body)", kd.cpu(), ki.cpu(), pd, pi,
                    join=body != "core", hidden=body == "hopper_binned")


def cpu_copy(ix):
    """The index with every tensor field moved to the CPU."""
    return dataclasses.replace(ix, **{
        f.name: getattr(ix, f.name).cpu() for f in dataclasses.fields(ix)
        if isinstance(getattr(ix, f.name), torch.Tensor)})


def phase_small_ivf_pq_rungs(dev) -> None:
    """Each compressed cache rung built on the card through the user's
    entry points (``build(cache_dtype=...)``, ``attach_rabitq_cache``,
    ``attach_raw_residual_cache``), searched there (kernel 2's arm) and,
    over the same index, on the CPU (its plain version,
    "pallas_interpret"), with the exact and the binned extraction."""
    from raft_tpu_torch.neighbors import ivf_pq
    from raft_tpu_torch.ops import ivf_scan

    x = sift_like(20_000, 96, seed=9, device=dev)
    q = sift_like(300, 96, seed=10, device=dev)
    kw = dict(n_lists=64, kmeans_n_iters=10)
    base = ivf_pq.build(ivf_pq.IndexParams(pq_dim=48, **kw), x, device=dev)
    log("parity (small IVF-PQ search per cache rung, card vs CPU):")
    for kind, make in [
            ("i4", lambda: ivf_pq.build(ivf_pq.IndexParams(
                pq_dim=48, cache_dtype="i4", **kw), x, device=dev)),
            ("pq4", lambda: ivf_pq.build(ivf_pq.IndexParams(
                pq_dim=96, pq_bits=4, cache_dtype="pq4", **kw), x,
                device=dev)),
            ("rabitq", lambda: ivf_pq.attach_rabitq_cache(base)),
            ("raw i4", lambda: ivf_pq.attach_raw_residual_cache(
                base, x, dtype="i4")),
            ("raw i8", lambda: ivf_pq.attach_raw_residual_cache(
                base, x, dtype="i8"))]:
        ix = make()
        if ix.cache_kind != kind.split()[-1]:
            raise SmokeFailure(f"small IVF-PQ {kind}: cache "
                               f"{ix.cache_kind}")
        cpu_ix = cpu_copy(ix)
        for what, sp in (("exact", ivf_pq.SearchParams(
                n_probes=8, local_recall_target=1.0)),
                         ("binned", ivf_pq.SearchParams(
                             n_probes=8, scan_impl="pallas"))):
            before = ivf_scan.ivf_list_scan_topk.launches
            bodies = dict(ivf_scan.ivf_list_scan_topk.by_body)
            kd, ki = ivf_pq.search(sp, ix, q, 10)
            if ivf_scan.ivf_list_scan_topk.launches != before + 1:
                raise SmokeFailure(f"small IVF-PQ {kind} search did not "
                                   "launch kernel 2")
            body = next((b for b, c in
                         ivf_scan.ivf_list_scan_topk.by_body.items()
                         if c > bodies.get(b, 0)), "core")
            pd, pi = ivf_pq.search(dataclasses.replace(
                sp, scan_impl="pallas_interpret"), cpu_ix, q.cpu(), 10)
            # bf16 pq4 searches take the pq4 Hopper body, the others at rot
            # 96 the Hopper arms' body
            pq4 = kind == "pq4"
            compare(f"ivf_pq.search 20k x 96, 64 lists, {kind} cache, "
                    f"{what} arm ({body} body)", kd.cpu(), ki.cpu(), pd, pi,
                    atol=pq4_search_atol(ix, q).cpu() if pq4 else ATOL,
                    join=body != "core",
                    hidden=body != "core" and what == "binned")


def timed_patches(secs: dict, patches):
    """Stand-ins for module functions that add each call's seconds (the
    card synchronised on both sides) to ``secs[name]``; returns the
    (module, attribute, original) list to restore."""
    saved = []
    for mod, attr, name in patches:
        fn = getattr(mod, attr)

        def run(*a, _fn=fn, _name=name, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = _fn(*a, **kw)
            torch.cuda.synchronize()
            secs[_name] = secs.get(_name, 0.0) + time.perf_counter() - t0
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, run)
    return saved


def record_scan(captured: dict, pick):
    """Stand-in for kernel 2's wrapper that keeps the inputs of the call
    ``pick(args, kwargs)`` selects. The wrapper counts its launches on the
    module attribute it is called by, so while the stand-in is in place
    the count lands on the stand-in, which starts at 0; ``by_arm`` splits
    it by extraction arm, and the wrapper splits it by body into
    ``by_body`` ("core", "hopper"). Returns (the original to restore, the
    stand-in)."""
    from raft_tpu_torch.ops import ivf_scan

    orig = ivf_scan.ivf_list_scan_topk

    def rec(*a, **kw):
        if pick(a, kw):
            captured["scan"] = (a, kw)
        before = rec.launches
        out = orig(*a, **kw)
        arm = kw.get("extract", "exact")
        rec.by_arm[arm] = rec.by_arm.get(arm, 0) + rec.launches - before
        return out

    rec.launches = 0
    rec.by_arm = {}
    rec.by_body = {}
    ivf_scan.ivf_list_scan_topk = rec
    return orig, rec


def timed_batches(fn, n: int = 5):
    """Warm-up, then ``n`` timed calls (host clock around a synchronised
    card); returns the seconds of each."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return times


def ivf_pq_path(dev, n=10_000_000, d=96, nq=10_000, n_lists=1024,
                pq_dim=48, n_probes=128, k=10, batch_size=2_000_000) -> dict:
    """IVF-PQ at the JAX package's DEEP-10M configuration (bench.py:283-343)
    on SIFT-like rows made on the card: the streamed build with its
    default int8 cache, split into its parts; search with the exact arm
    (``local_recall_target=1.0``; recall, QPS, the kernel's launches, a
    profile); the refined search (3k candidates, exact refine to k)."""
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.neighbors.ivf_flat import adaptive_query_group
    from raft_tpu_torch.ops import ivf_scan

    x = sift_like(n, d, seed=3, device=dev)
    q = sift_like(nq, d, seed=4, device=dev)
    torch.cuda.synchronize()
    secs, captured = {}, {}
    saved = timed_patches(secs, [
        (ivf_pq, "_quantizer_index", "train"), (ivf_pq, "encode", "encode"),
        (ivf_pq, "_pack_lists", "pack"), (ivf_pq, "_rec_norms", "rec_norms"),
        (ivf_pq, "_attach_cache", "cache")])
    params = ivf_pq.IndexParams(n_lists=n_lists, pq_dim=pq_dim, pq_bits=8,
                                kmeans_trainset_fraction=0.1,
                                cache_dtype="auto")
    sp = ivf_pq.SearchParams(n_probes=n_probes, local_recall_target=1.0)
    orig, rec = record_scan(captured, lambda a, kw: True)
    try:
        t0 = time.perf_counter()
        index = ivf_pq.build(params, x, batch_size=batch_size, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        out_d, out_i = ivf_pq.search(sp, index, q, k)
        _, truth = brute_force.knn(q[:1000], x, k, device=dev)
        torch.cuda.synchronize()
        launches = rec.launches
        by_arm, by_body = dict(rec.by_arm), dict(rec.by_body)
    finally:
        ivf_scan.ivf_list_scan_topk = orig
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    C, cap = index.indices.shape
    sizes = index.list_sizes
    log(f"IVF-PQ path (DEEP-10M config): {n} x {d} SIFT-like rows, "
        f"n_lists={n_lists}, pq_dim={pq_dim}, pq_bits=8, rot "
        f"{index.rot_dim}, cap={cap}, list sizes {int(sizes.min())}.."
        f"{int(sizes.max())}, cache {index.cache_kind} "
        f"({index.recon_cache.numel() / 1e9:.3f} GB); build {build_s:.2f} s "
        f"= " + " + ".join(f"{name} {secs[name]:.2f}" for name in
                           ("train", "encode", "pack", "rec_norms", "cache")))
    if index.cache_kind != "i8":
        raise SmokeFailure(f"cache_dtype='auto' gave {index.cache_kind!r}, "
                           "not the int8 cache")
    if launches <= 0:
        raise SmokeFailure("ivf_list_scan_topk never launched on the IVF-PQ "
                           "path")
    if out_d.shape != (nq, k) or not bool(torch.isfinite(out_d).all()) or \
            bool((out_i < 0).any()):
        raise SmokeFailure("IVF-PQ search returned non-finite or missing "
                           "neighbours")
    rec = recall_of(out_i[:1000], truth)
    log(f"  kernel launches during the path: ivf_list_scan_topk {launches}; "
        f"recall@{k} on {truth.shape[0]} queries vs exact brute force: "
        f"{rec:.4f}")
    if rec < IVF_PQ_RECALL_FLOOR:
        raise SmokeFailure(f"IVF-PQ recall {rec:.4f} < {IVF_PQ_RECALL_FLOOR}")

    before = ivf_scan.ivf_list_scan_topk.launches
    times = timed_batches(lambda: ivf_pq.search(sp, index, q, k))
    per_search = (ivf_scan.ivf_list_scan_topk.launches - before) / 6
    med = statistics.median(times)
    log(f"  search: {nq} queries in {med * 1e3:.2f} ms (median of 5) -> "
        f"{nq / med:.1f} QPS; batches ms "
        f"{[round(t * 1e3, 3) for t in times]}; kernel launches per search "
        f"{per_search:g}")
    profile_search(lambda: ivf_pq.search(sp, index, q, k))

    def refined():
        _, cand = ivf_pq.search(sp, index, q, 3 * k)
        return refine.refine(x, q, cand, k, device=dev)

    rtimes = timed_batches(refined)
    rmed = statistics.median(rtimes)
    # the refined search's exact first stage (k 30), its launches recorded
    orig, rec30 = record_scan({}, lambda a, kw: False)
    try:
        _, rid = refined()
        torch.cuda.synchronize()
        first30 = {"launches": dict(rec30.by_arm),
                   "by_body": dict(rec30.by_body)}
    finally:
        ivf_scan.ivf_list_scan_topk = orig
    rrec = recall_of(rid[:1000], truth)
    log(f"  refined search (3k = {3 * k} candidates, exact refine to {k}): "
        f"{nq} queries in {rmed * 1e3:.2f} ms (median of 5) -> "
        f"{nq / rmed:.1f} QPS; recall@{k} {rrec:.4f}")
    if rrec < REFINED_RECALL_FLOOR:
        raise SmokeFailure(f"refined IVF-PQ recall {rrec:.4f} < "
                           f"{REFINED_RECALL_FLOOR}")

    # the default searches on the same index: binned at k, binned_deep at
    # the refined search's 3k
    dsp = ivf_pq.SearchParams(n_probes=n_probes)
    defaults = [
        default_search("int8 (IVF-PQ, DEEP-10M)",
                       lambda: ivf_pq.search(dsp, index, q, k), q, truth, k,
                       rec, raw_floor=IVF_PQ_RECALL_FLOOR),
        default_search("int8 (IVF-PQ refined first stage)",
                       lambda: ivf_pq.search(dsp, index, q, 3 * k), q, truth,
                       k, rec, refine=lambda c: refine.refine(
                           x, q, c, k, device=dev), exact_refined=rrec,
                       refined_floor=REFINED_RECALL_FLOOR)]
    # the same two searches under a table that names kernel 2's fold
    group = adaptive_query_group(nq, n_probes, index.n_lists,
                                 dsp.query_group)
    folds = fold_table_searches([
        ("int8 (IVF-PQ, DEEP-10M), fold table",
         {"cap": cap, "k": k, "g": group},
         dict(first=lambda: ivf_pq.search(dsp, index, q, k), q=q,
              truth=truth, k=k, exact_recall=rec,
              raw_floor=IVF_PQ_RECALL_FLOOR)),
        ("int8 (IVF-PQ refined first stage), fold table",
         {"cap": cap, "k": 3 * k, "g": group},
         dict(first=lambda: ivf_pq.search(dsp, index, q, 3 * k), q=q,
              truth=truth, k=k, exact_recall=rec,
              refine=lambda c: refine.refine(x, q, c, k, device=dev),
              exact_refined=rrec, refined_floor=REFINED_RECALL_FLOOR))])
    return {"captured": captured["scan"], "launches": launches,
            "by_arm": by_arm, "by_body": by_body, "first30": first30,
            "build_s": build_s, "secs": secs, "recall": rec,
            "qps": nq / med, "refined_recall": rrec, "refined_qps": nq / rmed,
            "x": x, "q": q, "truth": truth, "index": index,
            "defaults": defaults, "folds": folds}


def ivf_pq_rungs_path(dev, x, q, truth, base, k=10, n_probes=128,
                      batch_size=2_000_000) -> dict:
    """IVF-PQ's compressed cache rungs at the DEEP-10M configuration, on
    the IVF-PQ path's rows and queries, one index at a time (each freed
    before the next): (a) ``cache_dtype="i4"``, the decoded i4 cache;
    (b) ``attach_raw_residual_cache(dtype="i4")`` on the default index;
    (c) ``pq_dim=96, pq_bits=4, cache_dtype="pq4"`` (EQUAL_BYTES_r05.json's
    pq4 index); (d) ``attach_rabitq_cache`` on the default index, searched
    at 4k = 40 (bench.py:428-450). For each, with the exact arm
    (``local_recall_target=1.0``): build or attach seconds by part and
    cache GB, recall@k raw and refined (3k candidates; RaBitQ each width
    of ``RABITQ_REFINE_RATIOS``; exact refine), QPS (median of 5), kernel
    launches per search and a profile; the arm measured at the path's
    shapes; then ``default_search`` on the same index. A rung under its
    recall gate is listed in ``"failed"`` (the run fails after its report,
    so every other phase still runs)."""
    from raft_tpu_torch.neighbors import ivf_pq, refine
    from raft_tpu_torch.ops import ivf_scan

    sp = ivf_pq.SearchParams(n_probes=n_probes, local_recall_target=1.0)
    dsp = ivf_pq.SearchParams(n_probes=n_probes)       # the default target
    n_lists = base.n_lists
    # the rungs share the default index's codes; its int8 cache goes
    base = dataclasses.replace(base, recon_cache=None)
    torch.cuda.empty_cache()
    build_parts = [(ivf_pq, "_quantizer_index", "train"),
                   (ivf_pq, "encode", "encode"), (ivf_pq, "_pack_lists",
                                                  "pack"),
                   (ivf_pq, "_rec_norms", "rec_norms"),
                   (ivf_pq, "_attach_cache", "cache")]

    def build(**kw):
        return ivf_pq.build(ivf_pq.IndexParams(
            n_lists=n_lists, kmeans_trainset_fraction=0.1, **kw), x,
            batch_size=batch_size, device=dev)

    rungs = [
        ("i4", "i4", build_parts,
         lambda: build(pq_dim=48, pq_bits=8, cache_dtype="i4")),
        ("raw i4", "i4", [(ivf_pq, "attach_raw_residual_cache", "attach")],
         lambda: ivf_pq.attach_raw_residual_cache(base, x, dtype="i4")),
        ("pq4", "pq4", build_parts,
         lambda: build(pq_dim=96, pq_bits=4, cache_dtype="pq4")),
        ("rabitq", "rabitq", [(ivf_pq, "attach_rabitq_cache", "attach")],
         lambda: ivf_pq.attach_rabitq_cache(base)),
    ]
    out = {"failed": []}
    for name, kind, parts, make in rungs:
        kc = 4 * k if kind == "rabitq" else k          # first-stage width
        secs, captured = {}, {}
        saved = timed_patches(secs, parts)
        orig, rec = record_scan(captured, lambda a, kw: True)
        try:
            t0 = time.perf_counter()
            index = make()
            torch.cuda.synchronize()
            make_s = time.perf_counter() - t0
            out_d, out_i = ivf_pq.search(sp, index, q, kc)
            torch.cuda.synchronize()
            launches = rec.launches
            arms, bodies = dict(rec.by_arm), dict(rec.by_body)
        finally:
            ivf_scan.ivf_list_scan_topk = orig
            for mod, attr, fn in saved:
                setattr(mod, attr, fn)
        if index.cache_kind != kind:
            raise SmokeFailure(f"IVF-PQ rung {name}: cache "
                               f"{index.cache_kind!r}, not {kind!r}")
        cache_gb = sum(t.numel() * t.element_size() for t in (
            index.recon_cache, index.cache_scales, index.cache_qnorms,
            index.cache_fac) if t is not None) / 1e9
        log(f"IVF-PQ rung {name} (DEEP-10M config): cache {kind} "
            f"{tuple(index.recon_cache.shape)} {index.recon_cache.dtype}, "
            f"{cache_gb:.3f} GB with its sidecars; "
            f"{'build' if len(parts) > 1 else 'attach'} {make_s:.2f} s = "
            + " + ".join(f"{part} {secs.get(part, 0.0):.2f}"
                         for _, _, part in parts))
        if launches <= 0:
            raise SmokeFailure(f"ivf_list_scan_topk never launched on the "
                               f"IVF-PQ {name} path")
        if out_d.shape != (q.shape[0], kc) or \
                not bool(torch.isfinite(out_d).all()) or \
                bool((out_i < 0).any()):
            raise SmokeFailure(f"IVF-PQ {name} search returned non-finite "
                               "or missing neighbours")
        raw = recall_of(out_i[:truth.shape[0], :k], truth)
        before = ivf_scan.ivf_list_scan_topk.launches
        times = timed_batches(lambda: ivf_pq.search(sp, index, q, kc))
        per_search = (ivf_scan.ivf_list_scan_topk.launches - before) / 6
        med = statistics.median(times)
        refined_by = {}
        for ratio in (RABITQ_REFINE_RATIOS if kind == "rabitq" else (3,)):
            def refined(rk=ratio * k):
                _, cand = ivf_pq.search(sp, index, q, rk)
                return refine.refine(x, q, cand, k, device=dev)

            rmed = statistics.median(timed_batches(refined))
            _, rid = refined()
            refined_by[ratio] = (recall_of(rid[:truth.shape[0]], truth),
                                 q.shape[0] / rmed)
            del rid
        log(f"  search at k={kc}: {q.shape[0]} queries in {med * 1e3:.2f} ms "
            f"(median of 5) -> {q.shape[0] / med:.1f} QPS; batches ms "
            f"{[round(t * 1e3, 3) for t in times]}; kernel launches per "
            f"search {per_search:g} ({launches} during the path); "
            f"recall@{k} {raw:.4f}")
        for ratio, (rrec, rqps) in refined_by.items():
            log(f"  refined ({ratio * k} candidates, exact refine to {k}): "
                f"{rqps:.1f} QPS (median of 5); recall@{k} {rrec:.4f}")
        profile_search(lambda: ivf_pq.search(sp, index, q, kc))
        rrec, rqps = next(iter(refined_by.values()))
        matched = None
        if kind == "rabitq":
            matched = next((r for r, (rr, _) in refined_by.items()
                            if rr >= RABITQ_REFINED_RECALL_FLOOR), None)
            if matched is None:
                out["failed"].append(
                    f"IVF-PQ {name} refined recall " + ", ".join(
                        f"{rr:.4f} from {r * k}" for r, (rr, _)
                        in refined_by.items())
                    + f" < {RABITQ_REFINED_RECALL_FLOOR}")
        elif raw < IVF_PQ_RECALL_FLOOR or rrec < REFINED_RECALL_FLOOR:
            out["failed"].append(
                f"IVF-PQ {name} recall {raw:.4f} (floor "
                f"{IVF_PQ_RECALL_FLOOR}), refined {rrec:.4f} (floor "
                f"{REFINED_RECALL_FLOOR})")
        a, kw = captured["scan"]
        kern = measure_ivf(a, kw, launches, arm=name)
        del a, kw
        # the default search on the same index: binned at k = 10, RaBitQ's
        # first stage of 40 binned_deep, refined to k (at 80 "auto" keeps
        # the exact arm, measured above)
        if kind == "rabitq":
            dflt = default_search(
                f"{name} (DEEP-10M rung)", lambda: ivf_pq.search(
                    dsp, index, q, kc), q, truth, k, raw,
                refine=lambda c: refine.refine(x, q, c, k, device=dev),
                exact_refined=refined_by[RABITQ_REFINE_RATIOS[0]][0])
        else:
            dflt = default_search(
                f"{name} (DEEP-10M rung)", lambda: ivf_pq.search(
                    dsp, index, q, k), q, truth, k, raw,
                raw_floor=IVF_PQ_RECALL_FLOOR)
        # pq4's refined search at the default target: its first stage of
        # 3k binned_deep (the pq4 Hopper body), refined to k
        refined_dflt = None
        if kind == "pq4":
            refined_dflt = default_search(
                f"{name} refined (DEEP-10M rung)", lambda: ivf_pq.search(
                    dsp, index, q, 3 * k), q, truth, k, raw,
                refine=lambda c: refine.refine(x, q, c, k, device=dev),
                exact_refined=rrec, refined_floor=REFINED_RECALL_FLOOR)
        out[name] = {"kernel": kern, "make_s": make_s, "secs": secs,
                     "cache_gb": cache_gb, "recall": raw, "qps": q.shape[0]
                     / med, "refined_recall": rrec, "refined_qps": rqps,
                     "refined_by": refined_by, "matched": matched,
                     "default": dflt, "default_refined": refined_dflt,
                     "launches": launches, "by_arm": arms, "by_body": bodies}
        del index, captured, out_d, out_i
        torch.cuda.empty_cache()
    return out


def cagra_ivf_pq_path(dev, x, q, truth, k=10) -> dict:
    """CAGRA built the reference's default way (IVF-PQ self-search +
    exact refine -> optimize -> packed layout) on the main path's rows,
    each part timed; search, recall, QPS and a profile as in the other
    CAGRA path."""
    from raft_tpu_torch.neighbors import cagra, ivf_pq, refine
    from raft_tpu_torch.ops import beam_step, ivf_scan

    secs, captured = {}, {}
    knn = {}
    build_knn_graph = cagra.build_knn_graph

    def keep_graph(*a, **kw):
        knn["graph"] = build_knn_graph(*a, **kw)
        return knn["graph"]

    saved = timed_patches(secs, [
        (ivf_pq, "build", "ivf_pq_build"), (ivf_pq, "search", "self_search"),
        (refine, "refine", "refine"), (cagra, "optimize", "optimize"),
        (cagra, "_attach_inline", "pack")])
    saved.append((cagra, "build_knn_graph", build_knn_graph))
    cagra.build_knn_graph = keep_graph
    beam = beam_step.beam_merge_step
    params = cagra.IndexParams(intermediate_graph_degree=64, graph_degree=32)
    sp = cagra.SearchParams(n_seeds=64, max_iterations=15)
    # keep the first self-search batch's scan inputs
    orig, rec = record_scan(captured, lambda a, kw: "scan" not in captured)
    try:
        beam.launches = 0
        t0 = time.perf_counter()
        index = cagra.build(params, x, device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        scan_build, beam_build = rec.launches, beam.launches
        by_arm, by_body = dict(rec.by_arm), dict(rec.by_body)
    finally:
        ivf_scan.ivf_list_scan_topk = orig
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    out_d, out_i = cagra.search(sp, index, q, k)
    torch.cuda.synchronize()
    launches = {"ivf_list_scan_topk": scan_build,
                "beam_merge_step": beam.launches}
    log(f"CAGRA path, IVF-PQ build (the default): {x.shape[0]} x "
        f"{x.shape[1]}, intermediate degree 64 -> graph_degree "
        f"{index.graph_degree}; build {build_s:.2f} s = IVF-PQ build "
        f"{secs['ivf_pq_build']:.2f} + self-search "
        f"{secs['self_search']:.2f} + refine {secs['refine']:.2f} + "
        f"optimize {secs['optimize']:.2f} + pack {secs['pack']:.2f} (the "
        f"rest: self-edge drop)")
    log(f"  launches: ivf_list_scan_topk {scan_build} per build ("
        + ", ".join(f"{a} {c}" for a, c in by_arm.items()) + "; by body "
        + ", ".join(f"{b} {c}" for b, c in by_body.items())
        + f"), beam_merge_step {launches['beam_merge_step'] - beam_build} "
        f"per search of {q.shape[0]} queries")
    for name, cnt in launches.items():
        if cnt <= 0:
            raise SmokeFailure(f"{name} never launched on the CAGRA IVF-PQ "
                               "path")
    graph = knn.pop("graph")
    g_rec = graph_recall(x, graph)
    log(f"  the self-search graph's recall@{graph.shape[1]} on 1000 sampled "
        f"nodes: {g_rec:.4f}")
    del graph
    if out_d.shape != (q.shape[0], k) or \
            not bool(torch.isfinite(out_d).all()) or bool((out_i < 0).any()):
        raise SmokeFailure("CAGRA (IVF-PQ build) search returned non-finite "
                           "or missing neighbours")
    rec = recall_of(out_i[:truth.shape[0]], truth)
    log(f"  recall@{k} on {truth.shape[0]} queries vs exact brute force: "
        f"{rec:.4f}")
    if rec < RECALL_FLOOR:
        raise SmokeFailure(f"CAGRA (IVF-PQ build) recall {rec:.4f} < "
                           f"{RECALL_FLOOR}")
    times = timed_batches(lambda: cagra.search(sp, index, q, k))
    med = statistics.median(times)
    log(f"  search: {q.shape[0]} queries in {med * 1e3:.2f} ms (median of 5)"
        f" -> {q.shape[0] / med:.1f} QPS; batches ms "
        f"{[round(t * 1e3, 3) for t in times]}")
    profile_search(lambda: cagra.search(sp, index, q, k))
    return {"captured": captured["scan"], "launches": launches,
            "build_s": build_s, "secs": secs, "recall": rec,
            "qps": q.shape[0] / med, "by_arm": by_arm, "by_body": by_body,
            "graph_recall": g_rec}


def graph_recall(x, graph, n_sample: int = 1000) -> float:
    """A KNN graph's recall against the exact neighbours (self excluded) of
    ``n_sample`` evenly spaced nodes."""
    from raft_tpu_torch.neighbors import brute_force

    sample = torch.arange(0, x.shape[0], x.shape[0] // n_sample,
                          device=x.device)[:n_sample]
    width = graph.shape[1]
    _, exact = brute_force.knn(x[sample], x, width + 1, device=x.device)
    return recall_of(graph[sample].long(), exact[:, 1:width + 1])


def fold_flat(index, q, truth, exact_recall, n_probes=64, k=10) -> dict:
    """The IVF-Flat main path's default search under a table that names
    kernel 2's fold (``fold_table_searches``), held as the default search
    is (within 0.05 of the exact run's recall, and 0.90)."""
    from raft_tpu_torch.neighbors import ivf_flat

    sp = ivf_flat.SearchParams(n_probes=n_probes)
    key = {"cap": int(index.storage.shape[1]), "k": k,
           "g": ivf_flat.adaptive_query_group(q.shape[0], n_probes,
                                              index.n_lists,
                                              sp.query_group)}
    return fold_table_searches([(
        "IVF-Flat (SIFT-1M), fold table", key,
        dict(first=lambda: ivf_flat.search(sp, index, q, k), q=q,
             truth=truth, k=k, exact_recall=exact_recall,
             floor=RECALL_FLOOR))])[0]


def default_flat(index, q, truth, exact_recall, n_probes=64, k=10) -> dict:
    """The IVF-Flat main path's default search (the binned arm at k = 10)
    on its index, queries and truth (``default_search``), held to 0.90
    too."""
    from raft_tpu_torch.neighbors import ivf_flat

    sp = ivf_flat.SearchParams(n_probes=n_probes)
    return default_search("IVF-Flat (SIFT-1M)",
                          lambda: ivf_flat.search(sp, index, q, k), q, truth,
                          k, exact_recall, floor=RECALL_FLOOR)


def arms_body_failures(dres, rres, res, fres) -> list:
    """The exact and binned launches of the IVF-Flat main path's exact
    search (``res``, k 10) and default search (``fres``, binned at k 10),
    of the DEEP-10M int8 searches (exact at k 10 and the refined search's
    30, the default binned at 10), of the i4 and raw i4 rungs (exact,
    default binned) and RaBitQ's exact search (k 40) must take the Hopper
    arms' body (``ops/ivf_scan.scan_body``): each search's launches by arm
    and by body printed, a failure listed for each that did not."""
    failed = []
    for label, arms, bodies, arm in [
            ("IVF-Flat exact search (k 10)",
             {"exact": res["launches"]["ivf_list_scan_topk"]},
             res["scan_bodies"], "exact"),
            (fres["label"], fres["launches"], fres["by_body"], "binned"),
            ("IVF-PQ int8 exact search (k 10)", dres["by_arm"],
             dres["by_body"], "exact"),
            ("IVF-PQ int8 refined search's exact first stage (k 30)",
             dres["first30"]["launches"], dres["first30"]["by_body"],
             "exact"),
            *((d["label"], d["launches"], d["by_body"], "binned")
              for d in (dres["defaults"][0], rres["i4"]["default"],
                        rres["raw i4"]["default"])),
            *((f"IVF-PQ rung {name} exact search", rres[name]["by_arm"],
               rres[name]["by_body"], "exact")
              for name in ("i4", "raw i4", "rabitq"))]:
        log(f"{arm} arm's body, {label}: launches by arm {arms}, by body "
            f"{bodies}")
        if not arms.get(arm) or bodies.get(f"hopper_{arm}", 0) != arms[arm]:
            failed.append(f"{label}: its {arm} launches did not all take "
                          f"the Hopper arms' body ({bodies})")
    return failed


def main() -> int:
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this run needs the card",
              file=sys.stderr)
        return 2
    try:
        import raft_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: cannot import the port ({e}); run from the "
              "repository root", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    try:
        smi = phase_device()
        phase_build()
        phase_small_parity(dev)
        phase_small_parity_binned(dev)
        phase_small_parity_pq4(dev)
        phase_small_parity_fold(dev)
        phase_small_parity_exact(dev)
        phase_small_parity_graph(dev)
        phase_small_search(dev)
        phase_small_ivf_pq(dev)
        phase_small_ivf_pq_rungs(dev)
        phase_small_cagra(dev)
        res = main_path(dev)
        x, q, truth = res.pop("x"), res.pop("q"), res.pop("truth")
        index = res.pop("index")
        fres = default_flat(index, q, truth, res["recall"])
        flat_fold = fold_flat(index, q, truth, res["recall"])
        del index
        bres = fast_bf_path(dev, x, q, truth)
        fold_row = measure_knn_fold(*bres.pop("captured"), bres["launches"])
        exact_bf16_row = measure_knn(*bres.pop("exact_captured"),
                                     bres["exact_launches"])
        cres = cagra_path(dev, x, q, truth)
        pres = cagra_ivf_pq_path(dev, x, q, truth)
        del x, q, truth
        dres = ivf_pq_path(dev)
        rres = ivf_pq_rungs_path(dev, dres.pop("x"), dres.pop("q"),
                                 dres.pop("truth"), dres.pop("index"))
        cap, ccap = res["captured"], cres["captured"]
        kernels = [measure_ivf(*cap["ivf_list_scan_topk"],
                               res["launches"]["ivf_list_scan_topk"]),
                   measure_ivf(*dres["captured"], dres["launches"],
                               arm="int8"),
                   measure_knn(*cap["fused_knn_topk"],
                               res["launches"]["fused_knn_topk"]),
                   measure_join(*ccap["join"],
                                cres["launches"]["graph_local_join"]),
                   measure_beam(*ccap["beam"],
                                cres["launches"]["beam_merge_step"])]
        # the int8 arm at the CAGRA self-search's shapes, with the arm the
        # default search takes there (reported only)
        arm = pres["captured"][1].get("extract", "exact")
        measure_ivf(*pres["captured"], pres["by_arm"].get(arm, 0),
                    arm=f"{arm} int8 (CAGRA self-search)")
        # one row per packed arm, from its DEEP-10M rung (the raw i4
        # cache's run of the i4 arm is reported above it, not listed); the
        # pq4 rung's binned and binned_deep arms from its default searches
        kernels += [rres[name]["kernel"] for name in ("i4", "pq4", "rabitq")]
        kernels += [dict(rres["pq4"][key]["kernel"],
                         name=f"ivf_list_scan_topk:pq4 {arm}")
                    for key, arm in (("default", "binned"),
                                     ("default_refined", "binned_deep"))]
        # the binned arm on the Hopper arms' body, from the default int8
        # and i4 searches at DEEP-10M
        kernels += [dict(run["kernel"], name=f"ivf_list_scan_topk:binned "
                         f"{cache}") for cache, run in (
                             ("int8", dres["defaults"][0]),
                             ("i4", rres["i4"]["default"]))]
        # one row per binned arm: binned from the IVF-Flat main path's
        # default search, binned_deep from the refined IVF-PQ search's
        # first stage; the other default runs are reported above
        for arm, run in (("binned", fres), ("binned_deep",
                                            dres["defaults"][1])):
            if run["arm"] != arm:
                raise SmokeFailure(f"{run['label']}: took {run['arm']}, not "
                                   f"{arm}")
            kernels.append(dict(run["kernel"],
                                name=f"ivf_list_scan_topk:{arm}"))
        # the fold arms: kernel 1's from the default fast brute force,
        # kernel 2's from the IVF-Flat search under the fold table
        kernels.append(fold_row)
        # kernel 1's exact arm under bf16: the filtered fast search's launch
        kernels.append(exact_bf16_row)
        kernels.append(dict(flat_fold["kernel"],
                            name="ivf_list_scan_topk:fold"))
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"IVF-Flat path: build {res['build_s']:.3f} s, QPS {res['qps']:.1f}, "
        f"recall@10 {res['recall']:.4f}")
    log(f"CAGRA path (nn-descent): build {cres['build_s']:.3f} s, QPS "
        f"{cres['qps']:.1f}, recall@10 {cres['recall']:.4f}")
    log(f"CAGRA path (IVF-PQ build): build {pres['build_s']:.3f} s, QPS "
        f"{pres['qps']:.1f}, recall@10 {pres['recall']:.4f}")
    log(f"IVF-PQ path (DEEP-10M config): build {dres['build_s']:.3f} s, QPS "
        f"{dres['qps']:.1f}, recall@10 {dres['recall']:.4f}; refined QPS "
        f"{dres['refined_qps']:.1f}, recall@10 {dres['refined_recall']:.4f}; "
        f"total {time.perf_counter() - t_start:.1f} s")
    log(f"fast brute force (SIFT-1M, k_cand 42): default (fused_fold:2048)"
        f" QPS {bres['qps']:.1f}, recall@10 {bres['recall']:.4f}; "
        f"impl='fused_exact' QPS {bres['exact_qps']:.1f}, recall@10 "
        f"{bres['exact_recall']:.4f}; filtered recall@10 "
        f"{bres['filtered_recall']:.4f}")
    failed = rres.pop("failed") + bres["failed"]
    # the recall oracle (the default exact search) takes kernel 1's exact
    # arm on its Hopper body (ops/fused_topk.exact_body); fast_bf_path
    # holds the fast path's impl="fused_exact" and filtered launches
    log(f"exact body, the recall oracle: launches by body "
        f"{res['knn_bodies']}")
    if res["knn_bodies"] != {"exact_hopper": 1}:
        failed.append(f"the recall oracle: kernel 1's exact arm took "
                      f"{res['knn_bodies']}, not the Hopper body")
    # the binned_deep launches of these three paths must take the Hopper
    # body (ops/ivf_scan.binned_deep_body)
    for label, arms, bodies in [
            ("CAGRA (IVF-PQ build) self-search", pres["by_arm"],
             pres["by_body"]),
            (dres["defaults"][1]["label"], dres["defaults"][1]["launches"],
             dres["defaults"][1]["by_body"]),
            (rres["rabitq"]["default"]["label"],
             rres["rabitq"]["default"]["launches"],
             rres["rabitq"]["default"]["by_body"])]:
        log(f"binned_deep body, {label}: launches by arm {arms}, by body "
            f"{bodies}")
        if not arms.get("binned_deep") or \
                bodies.get("hopper", 0) != arms["binned_deep"]:
            failed.append(f"{label}: its binned_deep launches did not all "
                          f"take the Hopper body ({bodies})")
    failed += arms_body_failures(dres, rres, res, fres)
    # the fold under its table keeps the core's body (IVF-Flat's f32 rows)
    log(f"fold body, {flat_fold['label']}: launches by body "
        f"{flat_fold['by_body']}")
    if any(c for b, c in flat_fold["by_body"].items() if b != "core"):
        failed.append(f"{flat_fold['label']}: a fold launch left the core "
                      f"({flat_fold['by_body']})")
    # every bf16 pq4 launch of the pq4 rung's path must take the pq4
    # Hopper body (ops/ivf_scan.pq4_body): the exact search, the default
    # (binned at k) and the refined default (binned_deep at 3k)
    pq4 = rres["pq4"]
    for label, n, bodies in [
            ("IVF-PQ rung pq4 exact search", pq4["launches"],
             pq4["by_body"]),
            *((d["label"], sum(d["launches"].values()), d["by_body"])
              for d in (pq4["default"], pq4["default_refined"]))]:
        log(f"pq4 body, {label}: {n} launches, by body {bodies}")
        if n <= 0 or bodies.get("pq4_hopper", 0) != n:
            failed.append(f"{label}: its pq4 launches did not all take the "
                          f"pq4 Hopper body ({bodies})")
    defaults = ([fres] + dres["defaults"] + [r["default"] for r in
                                              rres.values()]
                + [pq4["default_refined"]] + [flat_fold] + dres["folds"])
    for d in defaults:
        failed += d["failed"]
        k = d["kernel"]
        log(f"default search, {d['label']}: {d['arm']}, QPS {d['qps']:.1f}, "
            f"recall@10 {d['recall']:.4f} (exact {d['exact_recall']:.4f})"
            + (f", refined {d['refined_recall']:.4f} (exact "
               f"{d['exact_refined']:.4f})" if d["refined_recall"] is not None
               else "")
            + f"; arm {k['ms']:.3f} ms, plain {k['plain_ms']:.3f} ms, bound "
            f"{k['bound_ms']:.3f} ms")
    log(f"CAGRA (IVF-PQ build) self-search graph recall@63: "
        f"{pres['graph_recall']:.4f}, launches by arm {pres['by_arm']}")
    for name, r in rres.items():
        log(f"IVF-PQ rung {name} (DEEP-10M config): cache {r['cache_gb']:.3f}"
            f" GB, made in {r['make_s']:.3f} s, QPS {r['qps']:.1f}, recall@10"
            f" {r['recall']:.4f}; refined QPS {r['refined_qps']:.1f}, "
            f"recall@10 {r['refined_recall']:.4f}; arm {r['kernel']['ms']:.3f}"
            f" ms vs bound {r['kernel']['bound_ms']:.3f} ms"
            + "".join(f"; refined from {ratio * 10}: QPS {rq:.1f}, recall@10 "
                      f"{rr:.4f}" for ratio, (rr, rq)
                      in list(r["refined_by"].items())[1:])
            + (f"; gate met from {r['matched'] * 10} candidates"
               if r["matched"] else ""))
    log(smi)
    log(json.dumps({"kernels": [{key: v for key, v in row.items()
                                 if key not in ("bit_exact", "body")}
                                for row in kernels]}))
    if failed:
        print("chip_smoke: FAILED: " + "; ".join(failed), file=sys.stderr)
        return 1
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
