"""Times kernels 1 and 2 of several checkouts of the repository on one card.

    python3 -m raft_tpu_torch.tools.kernel_ab DIR_A DIR_B [DIR_C ...]
                                              [--order ABBA] [--out FILE]

Each DIR is the root of a checkout (for example a parent commit unpacked
with ``git archive``). For each letter of ``--order`` (A the first DIR, B the second, ...) a
fresh process runs
that checkout's own ``chip_smoke.py`` phases on the card: the kernel build,
the IVF-Flat main path (SIFT-like 1M x 128, 1024 lists, 10,000 queries,
n_probes 64, k 10) with its QPS, then kernel 2 (``ivf_list_scan_topk``)
and kernel 1 (``fused_knn_topk``) timed at the shapes that path gives them,
each split by stage (staging loads + epilogue, dots, top-k selection).
Alternating the checkouts (A B B A) on one card keeps the comparison free
of the card's power limit and clocks, which differ between machines. Each
run prints one JSON line; the last line is the list of all runs, also
written to ``--out``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def _child(root: str) -> dict:
    """One run in this process: ``root``'s chip_smoke phases, its port."""
    os.chdir(root)
    sys.path.insert(0, root)
    import torch

    import chip_smoke as cs

    stages = {}

    def stage_split(name, kern, full_ms):
        from raft_tpu_torch.ops import _build

        ms = {}
        for st in (0, 1):
            with _build.only_stages(st):
                ms[st] = cs.cuda_ms(kern, reps=10)
        stages[name] = {"staging_ms": ms[0], "dots_ms": ms[1] - ms[0],
                        "topk_ms": full_ms - ms[1], "ms": full_ms}

    cs.stage_split = stage_split
    dev = torch.device("cuda", 0)
    smi = cs.phase_device()
    cs.phase_build()
    res = cs.main_path(dev)
    cap = res["captured"]
    cs.measure_ivf(*cap["ivf_list_scan_topk"],
                   res["launches"]["ivf_list_scan_topk"])
    cs.measure_knn(*cap["fused_knn_topk"], res["launches"]["fused_knn_topk"])
    return {"root": root, "card": smi, "qps": res["qps"],
            "recall": res["recall"], "kernels": stages}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--order", default="ABBA")
    ap.add_argument("--out", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(_child(args.roots[0])), flush=True)
        return 0
    runs = []
    for letter in args.order:
        root = os.path.abspath(args.roots[ord(letter) - ord("A")])
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), root, "--child"],
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
