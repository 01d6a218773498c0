"""Times kernels of several checkouts of the repository on one card.

    python3 -m raft_tpu_torch.tools.kernel_ab DIR_A DIR_B [DIR_C ...]
                                              [--order ABBA] [--out FILE]
                                              [--kernels 12|3|2d|...]

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
spills where the checkout builds it. Alternating the checkouts (A B B A)
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
    if "2d" in kernels:
        run.update(_deep(cs, dev, run["kernels"]))
        kernels = kernels.replace("2d", "")
    if "1" in kernels or "2" in kernels:
        run.update(_scan_kernels(cs, dev, run["kernels"]))
    if "3" in kernels:
        run["kernels"][JOIN] = _join(cs, dev)
    return run


def _deep_scan(cs, name, args, kw) -> dict:
    """One captured scan at kernel 2's binned_deep arm: held against the
    plain version, timed whole, by stage and with every list emptied, its
    bound, and the launch's body where the checkout records one."""
    import torch

    from raft_tpu_torch.ops import _build, ivf_scan

    kw = dict(kw, extract="binned_deep")
    fn = ivf_scan.ivf_list_scan_topk
    before = dict(getattr(fn, "by_body", {}))

    def kern():
        return ivf_scan.ivf_list_scan_topk(*args, **kw)

    kd, ki = kern()
    body = [b for b, c in getattr(fn, "by_body", {}).items()
            if c > before.get(b, 0)]
    pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, **kw)
    exact = torch.equal(kd, pd) and torch.equal(ki, pi)
    # the Hopper body as chip_smoke.measure_ivf holds it (a checkout
    # without it compares at the module's tolerance)
    hopper = "hopper" in body and hasattr(cs, "deep_atol")
    err = cs.compare(f"binned_deep {name}", kd, ki, pd, pi,
                     atol=cs.deep_atol(args, kw) if hopper else cs.ATOL,
                     join=hopper)
    del kd, ki, pd, pi
    whole = cs.cuda_ms(kern, reps=10)
    ms = {}
    for st in (0, 1):
        with _build.only_stages(st):
            ms[st] = cs.cuda_ms(kern, reps=10)
    # every list empty: the launch, the queries' preparation and the
    # extraction alone (which for the sort does not depend on the data)
    empty = (args[0], args[1], torch.zeros_like(args[2])) + tuple(args[3:])
    empty_ms = cs.cuda_ms(lambda: ivf_scan.ivf_list_scan_topk(*empty, **kw),
                          reps=10)
    bytes_, ops, peak, _ = cs.scan_work(args, kw)
    return {"shape": [list(args[0].shape), list(args[4].shape),
                      list(args[5].shape), kw["k"]],
            "body": body[0] if body else "core", "bit_exact": exact,
            "max_abs_err": err["max_abs_err"],
            "tie_free_keys": err["tie_free_keys"], "ms": whole,
            "staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
            "topk_ms": whole - ms[1], "empty_lists_ms": empty_ms,
            "bound_ms": max(bytes_ / cs.H100_HBM_BYTES_PER_S,
                            ops / peak) * 1e3}


def _deep(cs, dev, kernels: dict) -> dict:
    """Kernel 2's binned_deep arm at the CAGRA self-search, the refined
    DEEP-10M first stage and the RaBitQ first stage, and the paths around
    them (module docstring)."""
    import dataclasses
    import statistics

    import torch

    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine
    from raft_tpu_torch.ops import _build, ivf_scan

    _build.build_all(names=("ivf_list_scan_topk",),
                     stage_set=(_build.FULL, 1, 0))
    # registers and spills of the Hopper body's kernels, where built here
    log = _build.BUILD_LOG.get("ivf_list_scan_topk", "").splitlines()
    out = {"ptxas": [" ".join(log[i:i + 4]) for i, ln in enumerate(log)
                     if "Compiling entry function" in ln and
                     "ivf_deep_scan_kernel" in ln]}
    x = cs.sift_like(1_000_000, 128, seed=1, device=dev)
    q = cs.sift_like(10_000, 128, seed=2, device=dev)
    _, truth = brute_force.knn(q[:1000], x, 10, device=dev)
    pres = cs.cagra_ivf_pq_path(dev, x, q, truth)
    out["cagra"] = {key: pres[key] for key in ("build_s", "recall", "qps",
                                               "graph_recall", "by_arm")}
    out["cagra"]["self_search_s"] = pres["secs"]["self_search"]
    kernels["binned_deep:cagra_self_search"] = _deep_scan(
        cs, "CAGRA self-search", *pres["captured"])
    del x, q, truth, pres
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
        kernels[f"binned_deep:{name}"] = _deep_scan(cs, name,
                                                    *captured["scan"])
        del captured, rid
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
        print(json.dumps(_child(args.roots[0], args.kernels)), flush=True)
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
