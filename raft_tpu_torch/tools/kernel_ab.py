"""Times kernels of several checkouts of the repository on one card.

    python3 -m raft_tpu_torch.tools.kernel_ab DIR_A DIR_B [DIR_C ...]
                                              [--order ABBA] [--out FILE]
                                              [--kernels 12|3|2d|2q|2e|2b|2f|1f|1e]

Each DIR is the root of a checkout (for example a parent commit unpacked
with ``git archive``). For each letter of ``--order`` (A the first DIR, B
the second, ...) a fresh process runs that checkout's own port and
``chip_smoke.py`` helpers on the card. Kernels 1 and 2 (``--kernels`` 1
or 2, the default ``12``): the kernel build, the IVF-Flat main path
(SIFT-like 1M x 128, 1024 lists, 10,000 queries, n_probes 64, k 10) with
its QPS, then kernel 2 (``ivf_list_scan_topk``) and kernel 1
(``fused_knn_topk``) timed at the shapes that path gives them, each split
by stage (staging loads + epilogue, dots, top-k selection). Kernel 3
(``--kernels 3``): kernel 3 built alone at its three stage builds, the
nn-descent build of CAGRA's main path (the same rows, graph degree 64, so
K 96, 80 iterations) timed, and its last full block of node rows (65,536
x C 224) handed to ``graph_local_join``: held against the plain version,
then timed whole and by stage (candidate rows gathered, plus the scores,
plus the merge; a checkout whose source has no stage builds times the
whole kernel three times). Kernel 2's binned_deep arm (``--kernels
2d``): kernel 2 built at its three stage builds; CAGRA's default build on
the same rows (``chip_smoke.cagra_ivf_pq_path``: the IVF-PQ self-search
at k 64, its seconds, the graph's recall@63 and CAGRA's recall@10) with
the first self-search batch's scan inputs captured; IVF-PQ at the
DEEP-10M configuration (10M x 96, 1024 lists, pq_dim 48, n_probes 128)
with its default int8 cache, whose refined first stage (k 30, refined to
10) is timed as a pipeline with its recall, and the RaBitQ cache on the
same index, searched at k 40 and refined to 10; each of the three scans
handed to ``ivf_list_scan_topk`` at the binned_deep arm, held against the
plain version, and timed whole, by stage and with every list emptied (the
launch, the queries' preparation and the extraction), with the launches'
body where the checkout records one and the Hopper body's registers and
spills where the checkout builds it. Kernel 2's pq4 arm (``--kernels
2q``): kernel 2 built at its three stage builds; IVF-PQ's pq4 rung at the
DEEP-10M configuration (10M x 96 SIFT-like rows, 1024 lists, pq_dim 96
at 4 bits, the pq4 cache, n_probes 128, 10,000 queries) and three of its
searches: exact at k 10 (``local_recall_target`` 1.0), the default at k
10 (binned) and the default refined first stage at k 30 (binned_deep,
refined to 10), each timed as a pipeline (QPS, median of 5) with its
recall@10 (raw, refined for the last), its first scan captured and handed
to ``ivf_list_scan_topk`` at the arm the search took: held against the
plain version, timed whole, by stage and with every list emptied, with
the launch's body and the pq4 kernels' registers and spills. Kernel 2's
exact and binned arms over int8 rows (``--kernels 2e`` and ``2b``, which
may be given together): kernel 2 built at its three stage builds (with the
Hopper arms' body's registers and spills where the checkout builds it);
IVF-PQ at the DEEP-10M configuration with its default int8 cache (as for
``2d``) and, for ``2e``, its RaBitQ cache; the searches, each timed as a
pipeline (QPS, median of 5) with its recall@10: ``2e`` the exact arm
(``local_recall_target`` 1.0) at k 10 and 30 on the int8 cache and at k
40 on RaBitQ's, ``2b`` the default search at k 10 (binned); each first
scan captured and handed to ``ivf_list_scan_topk`` at the arm the search
took: held against the plain version, timed whole, by stage and with
every list emptied, with the launch's body. Kernel 2's exact and binned
arms over f32 rows (``--kernels 2f``): kernel 2 built at its three stage
builds (with the Hopper arms' body's registers and spills where the
checkout builds it); the IVF-Flat main path (SIFT-like 1M x 128 f32 rows,
1024 lists, 10,000 queries, n_probes 64, k 10) and its exact
(``local_recall_target`` 1.0) and default (binned) searches, each timed as
a pipeline (QPS, median of 5) with its recall@10, its first scan captured
and handed to ``ivf_list_scan_topk`` at the arm the search took: held
against the plain version, timed whole, by stage and with every list
emptied, with the launch's body. Each scan is
held at the tolerance of the body its launch took (``chip_smoke``'s
``scan_tolerance``); a disagreement ends the run. Kernel 1's fold arm
(``--kernels 1f``): kernel 1 built at its three stage builds (with the
fold's Hopper body's registers and spills where the checkout builds it);
the fast brute force (``chip_smoke.fast_bf_path``: SIFT-like 1M x 128
rows, 10,000 queries, k 10, bf16 candidates at k_cand 42 refined exactly)
with its QPS and recall@10 beside the exact arm's, its fold launch
captured and handed to ``fused_knn_fold``: held against the plain
version (merged top-k) at the tolerance of the body it took through the
same table, and timed whole and by stage (staging loads, epilogue and
write-out; plus the dots; plus the lane-stack cascade). Kernel 1's exact arm (``--kernels 1e``): kernel 1 built at its
three stage builds (with the exact Hopper body's registers and spills
where the checkout builds it); the IVF-Flat main path
(``chip_smoke.main_path``: SIFT-like 1M x 128, 10,000 queries, n_probes
64, k 10) with its recall@10 against the exact brute force of 1,000
queries, whose launch (f32 operands, k 10) is captured; the exact search
of all 10,000 queries (``brute_force.search``, QPS, median of 5); and the
fast path's ``impl="fused_exact"`` launch (bf16 operands, 10,000 x 1M,
k_cand 42) captured; each launch held against the plain version at the
tolerance of the body it took and timed whole and by stage (staging
loads and epilogue; plus the dots; plus the selection). Alternating
the checkouts (A B B A)
on one card keeps the comparison free of the card's power limit and clocks,
which differ between machines. Each run prints one JSON line; the last
line is the list of all runs, also written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

JOIN = "graph_local_join"


def _child(root: str, kernels: str) -> dict:
    """One run in this process: ``root``'s chip_smoke phases, its port."""
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    run = {"root": root, "card": cs.phase_device(), "kernels": {}}
    if "1f" in kernels:
        run.update(_fold(cs, dev, run["kernels"]))
        kernels = kernels.replace("1f", "")
    if "1e" in kernels:
        run.update(_exact(cs, dev, run["kernels"]))
        kernels = kernels.replace("1e", "")
    if "2d" in kernels:
        run.update(_deep(cs, dev, run["kernels"]))
        kernels = kernels.replace("2d", "")
    if "2q" in kernels:
        run.update(_pq4(cs, dev, run["kernels"]))
        kernels = kernels.replace("2q", "")
    if "2f" in kernels:
        run.update(_flat(cs, dev, run["kernels"]))
        kernels = kernels.replace("2f", "")
    if "2e" in kernels or "2b" in kernels:
        run.update(_arms(cs, dev, run["kernels"], exact="2e" in kernels,
                         binned="2b" in kernels))
        kernels = kernels.replace("2e", "").replace("2b", "")
    if "1" in kernels or "2" in kernels:
        run.update(_scan_kernels(cs, dev, run["kernels"]))
    if "3" in kernels:
        run["kernels"][JOIN] = _join(cs, dev)
    return run


def _tolerance(cs, body, args, kw) -> dict:
    """``compare``'s keywords for the body the launch took: the
    checkout's ``scan_tolerance``; a checkout older than that table has at
    most the binned_deep Hopper body ("hopper"), at ``deep_atol`` under
    the join rule."""
    if hasattr(cs, "scan_tolerance"):
        return cs.scan_tolerance(body, args, kw)
    if body == "hopper":
        return {"atol": cs.deep_atol(args, kw), "join": True}
    return {"atol": cs.ATOL}


def _scan_ab(cs, name, args, kw) -> dict:
    """One captured scan of kernel 2 at the arm ``kw`` names: held against
    the plain version at the tolerance of the body the launch took, timed
    whole, by stage and with every list emptied (the launch, the queries'
    preparation and the extraction), its bound, and the launch's body
    where the checkout records one."""
    import torch

    from raft_tpu_torch.ops import ivf_scan

    fn = ivf_scan.ivf_list_scan_topk
    before = dict(getattr(fn, "by_body", {}))

    def kern():
        return ivf_scan.ivf_list_scan_topk(*args, **kw)

    kd, ki = kern()
    body = next((b for b, c in getattr(fn, "by_body", {}).items()
                 if c > before.get(b, 0)), "core")
    pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
    exact = torch.equal(kd, pd) and torch.equal(ki, pi)
    extract = kw.get("extract", "exact")
    err = cs.compare(f"{extract} {name}", kd, ki, pd, pi,
                     **_tolerance(cs, body, args, kw))
    del kd, ki, pd, pi
    whole, ms = _stage_ms(cs, kern, reps=10)
    empty = (args[0], args[1], torch.zeros_like(args[2])) + tuple(args[3:])
    empty_ms = cs.cuda_ms(lambda: ivf_scan.ivf_list_scan_topk(*empty, **kw),
                          reps=10)
    bytes_, ops, peak, _ = cs.scan_work(args, kw)
    return {"shape": [list(args[0].shape), list(args[4].shape),
                      list(args[5].shape), kw["k"]],
            "extract": extract, "body": body, "bit_exact": exact,
            "max_abs_err": err["max_abs_err"],
            "tie_free_keys": err["tie_free_keys"], "ms": whole,
            "staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
            "topk_ms": whole - ms[1], "empty_lists_ms": empty_ms,
            "bound_ms": max(bytes_ / cs.H100_HBM_BYTES_PER_S,
                            ops / peak) * 1e3}


def _stage_ms(cs, kern, reps: int):
    """(whole ms, {0: ms, 1: ms}): ``kern`` timed whole and at the stage
    builds 0 and 1 (``_build.only_stages``)."""
    from raft_tpu_torch.ops import _build

    whole = cs.cuda_ms(kern, reps=reps)
    ms = {}
    for st in (0, 1):
        with _build.only_stages(st):
            ms[st] = cs.cuda_ms(kern, reps=reps)
    return whole, ms


def _fold(cs, dev, kernels: dict) -> dict:
    """Kernel 1's fold arm at the fast brute force's captured launch, and
    the fast path around it (module docstring)."""
    import torch

    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.neighbors.common import merge_topk
    from raft_tpu_torch.ops import _build, fused_topk

    _build.build_all(names=("fused_knn_topk",),
                     stage_set=(_build.FULL, 1, 0))
    log = _build.BUILD_LOG.get("fused_knn_topk", "").splitlines()
    out = {"ptxas": [" ".join(log[i:i + 4]) for i, ln in enumerate(log)
                     if "Compiling entry function" in ln and
                     "fold_hopper" in ln]}
    x = cs.sift_like(1_000_000, 128, seed=1, device=dev)
    q = cs.sift_like(10_000, 128, seed=2, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    res = cs.fast_bf_path(dev, x, q, truth)
    out["fast_bf"] = {key: res[key] for key in ("qps", "recall",
                                                "exact_qps",
                                                "exact_recall")}
    args, kw = res["captured"]
    del x, q, truth, res
    torch.cuda.empty_cache()
    fkw = {key: v for key, v in kw.items() if key != "variant"}
    fn = fused_topk.fused_knn_topk
    before = dict(getattr(fn, "by_body", {}))

    def kern():
        return fused_topk.fused_knn_fold(*args, **fkw)

    kd, ki = kern()
    body = next((b for b, c in getattr(fn, "by_body", {}).items()
                 if c > before.get(b, 0)), "core")
    pd, pi = fused_topk.fused_knn_fold_plain(*args, **fkw)
    exact = torch.equal(kd, pd) and torch.equal(ki, pi)
    queries, dataset, k = args[:3]
    err = cs.compare(f"fold ({body}, merged)", *merge_topk(kd, ki, k),
                     *merge_topk(pd, pi, k),
                     **_tolerance(cs, body, args, fkw))
    width = kd.shape[1]
    del kd, ki, pd, pi
    torch.cuda.empty_cache()
    whole, ms = _stage_ms(cs, kern, reps=5)
    m, d = queries.shape
    n = dataset.shape[0]
    bytes_ = (m * d * queries.element_size()
              + n * d * dataset.element_size() + n * 4 + m * 4
              + m * width * 8)
    kernels["fold"] = {
        "shape": [m, n, d, k, fkw["tile_n"]], "body": body,
        "bit_exact": exact, "max_abs_err": err["max_abs_err"],
        "tie_free_keys": err["tie_free_keys"], "ms": whole,
        "staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
        "topk_ms": whole - ms[1],
        "bytes_bound_ms": bytes_ / cs.H100_HBM_BYTES_PER_S * 1e3,
        "ops_bound_ms": 2.0 * m * n * d / cs.H100_BF16_FLOPS * 1e3}
    return out


def _exact(cs, dev, kernels: dict) -> dict:
    """Kernel 1's exact arm at the recall oracle's and the fast path's
    captured launches, and the searches around them (module docstring)."""
    import statistics

    import torch

    from raft_tpu_torch.neighbors import brute_force
    from raft_tpu_torch.ops import _build, fused_topk

    _build.build_all(names=("fused_knn_topk",),
                     stage_set=(_build.FULL, 1, 0))
    log = _build.BUILD_LOG.get("fused_knn_topk", "").splitlines()
    out = {"ptxas": [" ".join(log[i:i + 4]) for i, ln in enumerate(log)
                     if "Compiling entry function" in ln and
                     "exact_hopper" in ln]}
    res = cs.main_path(dev)
    x, q = res["x"], res["q"]
    out["ivf_flat"] = {"recall": res["recall"], "qps": res["qps"]}
    index = brute_force.build(x, device=dev)
    times = []
    for i in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        brute_force.search(index, q, 10)
        torch.cuda.synchronize()
        if i:
            times.append(time.perf_counter() - t0)
    out["exact_search"] = {"qps": q.shape[0] / statistics.median(times),
                           "batch_ms": [t * 1e3 for t in times]}
    captured = {}
    orig = fused_topk.fused_knn_topk

    def rec(*a, **kw):
        captured.setdefault("fast", (a, kw))
        return orig(*a, **kw)

    rec.launches = 0
    rec.by_body = {}
    fused_topk.fused_knn_topk = rec
    try:
        brute_force.search(index, q, 10, fast=True, impl="fused_exact")
        torch.cuda.synchronize()
    finally:
        fused_topk.fused_knn_topk = orig
    launches = {"oracle": res["captured"]["fused_knn_topk"],
                "fast": captured["fast"]}
    del index, res
    torch.cuda.empty_cache()
    for name, (args, kw) in launches.items():
        fn = fused_topk.fused_knn_topk
        before = dict(getattr(fn, "by_body", {}))

        def kern(args=args, kw=kw):
            return fused_topk.fused_knn_topk(*args, **kw)

        kd, ki = kern()
        body = next((b for b, c in getattr(fn, "by_body", {}).items()
                     if c > before.get(b, 0)), "core")
        pd, pi = fused_topk.fused_knn_topk_plain(*args, **kw)
        exact = torch.equal(kd, pd) and torch.equal(ki, pi)
        err = cs.compare(f"exact arm, {name} ({body})", kd, ki, pd, pi,
                         **_tolerance(cs, body, args, kw))
        del kd, ki, pd, pi
        torch.cuda.empty_cache()
        queries, dataset, k = args[:3]
        whole, ms = _stage_ms(cs, kern, reps=3 if name == "fast" else 10)
        m, d = queries.shape
        n = dataset.shape[0]
        flops = 2.0 * m * n * d
        bf16 = queries.dtype == torch.bfloat16
        kernels[f"exact_{name}"] = {
            "shape": [m, n, d, k], "dtype": str(queries.dtype)[6:],
            "body": body, "bit_exact": exact,
            "max_abs_err": err["max_abs_err"],
            "tie_free_keys": err["tie_free_keys"], "ms": whole,
            "staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
            "topk_ms": whole - ms[1],
            "ops_bound_ms": (flops / cs.H100_BF16_FLOPS if bf16 else
                             3 * flops / 495e12) * 1e3,
            "f32_cores_bound_ms": None if bf16 else
            flops / cs.H100_F32_FLOPS * 1e3}
    return out


def _build_scan(match: str) -> list:
    """Kernel 2 built at its three stage builds; ptxas' lines (registers,
    spills) of the entry functions whose name holds ``match``, where this
    checkout builds them."""
    from raft_tpu_torch.ops import _build

    _build.build_all(names=("ivf_list_scan_topk",),
                     stage_set=(_build.FULL, 1, 0))
    log = _build.BUILD_LOG.get("ivf_list_scan_topk", "").splitlines()
    return [" ".join(log[i:i + 4]) for i, ln in enumerate(log)
            if "Compiling entry function" in ln and match in ln]


def _pq4(cs, dev, kernels: dict) -> dict:
    """Kernel 2's pq4 arm at the DEEP-10M pq4 rung's exact, default and
    refined default searches (module docstring)."""
    import statistics

    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import ivf_scan

    out = {"ptxas": _build_scan("pq4")}
    x = cs.sift_like(10_000_000, 96, seed=3, device=dev)
    q = cs.sift_like(10_000, 96, seed=4, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    index = ivf_pq.build(ivf_pq.IndexParams(
        n_lists=1024, pq_dim=96, pq_bits=4, kmeans_trainset_fraction=0.1,
        cache_dtype="pq4"), x, batch_size=2_000_000, device=dev)
    if index.cache_kind != "pq4":
        raise RuntimeError(f"pq4 rung: cache {index.cache_kind}")
    for name, target, kc in (("exact", 1.0, 10), ("binned", 0.95, 10),
                             ("binned_deep", 0.95, 30)):
        sp = ivf_pq.SearchParams(n_probes=128, local_recall_target=target)
        captured = {}
        orig, _ = cs.record_scan(captured,
                                 lambda a, kw: "scan" not in captured)
        try:
            ivf_pq.search(sp, index, q, kc)
        finally:
            ivf_scan.ivf_list_scan_topk = orig

        def pipeline(sp=sp, kc=kc):
            d, cand = ivf_pq.search(sp, index, q, kc)
            if kc == 10:
                return d, cand
            return refine.refine(x, q, cand, 10, device=dev)

        med = statistics.median(cs.timed_batches(pipeline))
        _, ids = pipeline()
        out[f"pq4_{name}"] = {"qps": q.shape[0] / med,
                              "recall": cs.recall_of(ids[:1000, :10], truth),
                              "refined": kc != 10}
        a, kw = captured["scan"]
        if kw.get("extract", "exact") != name:
            raise RuntimeError(f"pq4 {name} search took "
                               f"{kw.get('extract')}")
        kernels[f"pq4:{name}"] = _scan_ab(cs, name, a, kw)
        del captured, a, kw, ids
    return out


def _arms(cs, dev, kernels: dict, exact: bool, binned: bool) -> dict:
    """Kernel 2's exact and binned arms at the DEEP-10M int8 searches
    (and RaBitQ's exact search), and the searches around them (module
    docstring)."""
    import dataclasses
    import statistics

    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_pq
    from raft_tpu_torch.ops import ivf_scan

    out = {"ptxas": _build_scan("ivf_arm_scan_kernel")}
    x = cs.sift_like(10_000_000, 96, seed=3, device=dev)
    q = cs.sift_like(10_000, 96, seed=4, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    index = ivf_pq.build(ivf_pq.IndexParams(
        n_lists=1024, pq_dim=48, pq_bits=8, kmeans_trainset_fraction=0.1,
        cache_dtype="auto"), x, batch_size=2_000_000, device=dev)
    del x
    torch.cuda.empty_cache()
    searches = []
    if exact:
        rabitq = ivf_pq.attach_rabitq_cache(dataclasses.replace(
            index, recon_cache=None))
        searches += [("exact", "int8_k10", index, 1.0, 10),
                     ("exact", "int8_k30", index, 1.0, 30),
                     ("exact", "rabitq_k40", rabitq, 1.0, 40)]
    if binned:
        searches.append(("binned", "int8_k10", index, 0.95, 10))
    for arm, name, ix, target, kc in searches:
        sp = ivf_pq.SearchParams(n_probes=128, local_recall_target=target)
        captured = {}
        orig, _ = cs.record_scan(captured,
                                 lambda a, kw: "scan" not in captured)
        try:
            ivf_pq.search(sp, ix, q, kc)
        finally:
            ivf_scan.ivf_list_scan_topk = orig

        def search(sp=sp, ix=ix, kc=kc):
            return ivf_pq.search(sp, ix, q, kc)

        med = statistics.median(cs.timed_batches(search))
        _, ids = search()
        out[f"{arm}_{name}"] = {"qps": q.shape[0] / med,
                                "recall": cs.recall_of(ids[:1000, :10],
                                                       truth)}
        a, kw = captured["scan"]
        if kw.get("extract", "exact") != arm:
            raise RuntimeError(f"{name} search took {kw.get('extract')}")
        kernels[f"{arm}:{name}"] = _scan_ab(cs, name, a, kw)
        del captured, a, kw, ids
    return out


def _flat(cs, dev, kernels: dict) -> dict:
    """Kernel 2's exact and binned arms over f32 rows at the IVF-Flat main
    path's exact and default searches, and the searches around them
    (module docstring)."""
    import statistics

    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_flat
    from raft_tpu_torch.ops import ivf_scan

    out = {"ptxas": _build_scan("ivf_arm_scan_kernel")}
    x = cs.sift_like(1_000_000, 128, seed=1, device=dev)
    q = cs.sift_like(10_000, 128, seed=2, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=1024), x,
                           device=dev)
    del x
    torch.cuda.empty_cache()
    for arm, sp in (("exact", ivf_flat.SearchParams(
            n_probes=64, local_recall_target=1.0)),
                    ("binned", ivf_flat.SearchParams(n_probes=64))):
        captured = {}
        orig, _ = cs.record_scan(captured,
                                 lambda a, kw: "scan" not in captured)
        try:
            ivf_flat.search(sp, index, q, 10)
        finally:
            ivf_scan.ivf_list_scan_topk = orig

        def search(sp=sp):
            return ivf_flat.search(sp, index, q, 10)

        med = statistics.median(cs.timed_batches(search))
        _, ids = search()
        out[f"{arm}_ivf_flat_k10"] = {"qps": q.shape[0] / med,
                                      "recall": cs.recall_of(ids[:1000],
                                                             truth)}
        a, kw = captured["scan"]
        if kw.get("extract", "exact") != arm:
            raise RuntimeError(f"IVF-Flat {arm} search took "
                               f"{kw.get('extract')}")
        kernels[f"{arm}:ivf_flat_k10"] = _scan_ab(cs, "IVF-Flat k10", a, kw)
        del captured, a, kw, ids
    return out


def _deep(cs, dev, kernels: dict) -> dict:
    """Kernel 2's binned_deep arm at the CAGRA self-search, the refined
    DEEP-10M first stage and the RaBitQ first stage, and the paths around
    them (module docstring)."""
    import dataclasses
    import statistics

    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import ivf_scan

    out = {"ptxas": _build_scan("ivf_deep_scan_kernel")}
    x = cs.sift_like(1_000_000, 128, seed=1, device=dev)
    q = cs.sift_like(10_000, 128, seed=2, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    pres = cs.cagra_ivf_pq_path(dev, x, q, truth)
    out["cagra"] = {key: pres[key] for key in ("build_s", "recall", "qps",
                                               "graph_recall", "by_arm")}
    out["cagra"]["self_search_s"] = pres["secs"]["self_search"]
    a, kw = pres["captured"]
    kernels["binned_deep:cagra_self_search"] = _scan_ab(
        cs, "CAGRA self-search", a, dict(kw, extract="binned_deep"))
    del x, q, truth, pres, a, kw
    torch.cuda.empty_cache()

    x = cs.sift_like(10_000_000, 96, seed=3, device=dev)
    q = cs.sift_like(10_000, 96, seed=4, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    index = ivf_pq.build(ivf_pq.IndexParams(
        n_lists=1024, pq_dim=48, pq_bits=8, kmeans_trainset_fraction=0.1,
        cache_dtype="auto"), x, batch_size=2_000_000, device=dev)
    sp = ivf_pq.SearchParams(n_probes=128)
    for name, ix, kc in (
            ("deep10m_refined", index, 30),
            ("rabitq", ivf_pq.attach_rabitq_cache(dataclasses.replace(
                index, recon_cache=None)), 40)):
        captured = {}
        orig, _ = cs.record_scan(captured,
                                 lambda a, kw: "scan" not in captured)
        try:
            ivf_pq.search(sp, ix, q, kc)
        finally:
            ivf_scan.ivf_list_scan_topk = orig

        def pipeline(ix=ix, kc=kc):
            _, cand = ivf_pq.search(sp, ix, q, kc)
            return refine.refine(x, q, cand, 10, device=dev)

        med = statistics.median(cs.timed_batches(pipeline))
        _, rid = pipeline()
        out[name] = {"qps": q.shape[0] / med,
                     "refined_recall": cs.recall_of(rid[:1000], truth)}
        a, kw = captured["scan"]
        kernels[f"binned_deep:{name}"] = _scan_ab(
            cs, name, a, dict(kw, extract="binned_deep"))
        del captured, rid, a, kw
    return out


def _join(cs, dev) -> dict:
    """Kernel 3 at the nn-descent build's block shape, whole and by
    stage, and the build's seconds."""
    import torch

    from raft_tpu_torch.neighbors import nn_descent
    from raft_tpu_torch.ops import _build, graph_join

    if JOIN not in _build.STAGED:           # a checkout before the stages
        _build.STAGED = _build.STAGED + (JOIN,)
    _build.build_all(names=(JOIN,), stage_set=(_build.FULL, 1, 0))
    x = cs.sift_like(1_000_000, 128, seed=1, device=dev)
    join, cap = graph_join.graph_local_join, {}

    def rec(*a, **kw):
        if a[1].numel() >= cap.get("size", 0):
            cap.update(args=a, kw=kw, size=a[1].numel())
        return join(*a, **kw)

    nn_descent.graph_local_join = rec
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nn_descent.build(nn_descent.IndexParams(
            graph_degree=64, max_iterations=cs.NN_DESCENT_NITER), x,
            device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
    finally:
        nn_descent.graph_local_join = join
    a, kw = cap["args"], cap["kw"]

    def kern():
        return join(*a, **kw)

    kd, ki = kern()
    pd, pi = graph_join.graph_local_join_plain(*a, **kw)
    err = cs.compare("graph_local_join (block shape)", kd, ki, pd, pi,
                     atol=cs.join_atol(a[0], a[2], a[3], kw["qn"],
                                       kw["ip"]), join=True)
    ms = {}
    for st in (0, 1):
        with _build.only_stages(st):
            ms[st] = cs.cuda_ms(kern, reps=20)
    whole = cs.cuda_ms(kern, reps=20)
    B, C = a[1].shape
    return {"shape": [B, C, a[4].shape[1], a[2].shape[1]],
            "nn_descent_build_s": build_s,
            "max_abs_err": err["max_abs_err"], "gathers_ms": ms[0],
            "scores_ms": ms[1] - ms[0], "merge_ms": whole - ms[1],
            "ms": whole}


def _scan_kernels(cs, dev, stages: dict) -> dict:
    """Kernels 2 and 1 at the IVF-Flat main path's shapes, by stage into
    ``stages``; the path's QPS and recall."""
    def stage_split(name, kern, full_ms):
        from raft_tpu_torch.ops import _build

        ms = {}
        for st in (0, 1):
            with _build.only_stages(st):
                ms[st] = cs.cuda_ms(kern, reps=10)
        stages[name] = {"staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
                        "topk_ms": full_ms - ms[1], "ms": full_ms}

    cs.stage_split = stage_split
    cs.phase_build()
    res = cs.main_path(dev)
    cap = res["captured"]
    cs.measure_ivf(*cap["ivf_list_scan_topk"],
                   res["launches"]["ivf_list_scan_topk"])
    cs.measure_knn(*cap["fused_knn_topk"], res["launches"]["fused_knn_topk"])
    return {"qps": res["qps"], "recall": res["recall"]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--kernels", default="12")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.roots[0], args.kernels)),
              flush=True)
        return 0
    runs = []
    for letter in args.order:
        root = os.path.abspath(args.roots[ord(letter) - ord("A")])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--child",
             "--kernels", args.kernels],
            env=dict(os.environ, PYTHONPATH=root), capture_output=True,
            text=True, cwd=root)
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-2000:])
        if proc.returncode != 0:
            print(f"kernel_ab: run {letter} ({root}) failed",
                  file=sys.stderr)
            return 1
        run = json.loads(proc.stdout.strip().splitlines()[-1])
        run["label"] = letter
        runs.append(run)
        print(json.dumps(run), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(runs, f, indent=1)
    print(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
