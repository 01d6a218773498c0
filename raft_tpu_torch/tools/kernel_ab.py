"""Times kernels of several checkouts of the repository on one card.

    python3 -m raft_tpu_torch.tools.kernel_ab DIR_A DIR_B [DIR_C ...]
                                              [--order ABBA] [--out FILE]
                                              [--kernels 12|3|123]

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
whole kernel three times). Alternating the checkouts (A B B A) on one
card keeps the comparison free of the card's power limit and clocks,
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
    if "1" in kernels or "2" in kernels:
        run.update(_scan_kernels(cs, dev, run["kernels"]))
    if "3" in kernels:
        run["kernels"][JOIN] = _join(cs, dev)
    return run


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
