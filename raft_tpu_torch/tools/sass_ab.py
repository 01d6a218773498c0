"""Compares the machine code of kernels 1 and 2 in two checkouts.

    python3 -m raft_tpu_torch.tools.sass_ab DIR_A DIR_B [--out FILE]
                                            [--sources NAME ...]
                                            [--stages 0 1 2]

For ``fused_knn_topk.cu`` and ``ivf_list_scan_topk.cu`` (or the
``--sources`` named) of each checkout, at each ``RTT_STAGES`` build (0,
1, 2, or ``--stages``), nvcc compiles a cubin (all twelve at once) for
``sm_90a`` with the flags of ``ops/_build.py`` and ``cuobjdump -sass``
lists its functions; each instruction is kept without its address and
encoding (functions only DIR_B has, such as a new kernel, are listed
apart and not compared). Every function of DIR_A is matched to DIR_B's
of the same name, where a kernel that gained an extraction-arm template
argument in DIR_B is matched at the exact arm (0):
``ivf_list_scan_topk_kernel<..., (int)0>`` to
``ivf_list_scan_topk_kernel<...>``,
``fused_knn_topk_kernel<T, (int)0>`` to ``fused_knn_topk_kernel<T>`` and
``ivf_pq4_scan_topk_kernel<(int)0>`` to the untemplated kernel; and the
Hopper arms' kernel that gained a queries-a-block argument is matched at
its 64: ``ivf_arm_scan_kernel<..., (int)64>`` to
``ivf_arm_scan_kernel<...>``; branch labels are numbered anew in each
function. Prints, per function, whether
the instruction lists are equal, and one JSON line of the totals (also to
``--out``).
Needs nvcc, cuobjdump and cu++filt (the CUDA toolkit).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import tempfile

SOURCES = ("fused_knn_topk", "ivf_list_scan_topk")
_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/")
_ENC = re.compile(r"/\* 0x[0-9a-f]{16} \*/")
_LABEL = re.compile(r"\.L_x_\d+")


def _tool(name: str) -> str:
    found = shutil.which(name)
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", name)


def _key(name: str) -> str:
    """A demangled kernel name with the exact extraction arm's template
    argument dropped; other arms keep theirs (and match nothing)."""
    name = re.sub(r"((?:ivf_list_scan_topk|fused_knn_topk)_kernel<[^<>]*), "
                  r"\(int\)0>", r"\1>", name)
    # the arms' kernel at the 64 queries a block it had before its Q
    name = re.sub(r"(ivf_arm_scan_kernel<[^<>]*), \(int\)64>", r"\1>",
                  name)
    # a template's name carries its return type, a plain function's not
    return name.replace("void ivf_pq4_scan_topk_kernel<(int)0>",
                        "ivf_pq4_scan_topk_kernel")


def _compile(root: str, src: str, stages: int, tmp: str, tag: str):
    """Start nvcc on one source at one stage build; (cubin, process)."""
    cubin = os.path.join(tmp, f"{tag}-{src}-{stages}.cubin")
    csrc = os.path.join(root, "raft_tpu_torch", "ops", "csrc")
    proc = subprocess.Popen(
        [_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
         "-std=c++17", "-O3", f"-DRTT_STAGES={stages}", "-cubin", "-o",
         cubin, os.path.join(csrc, f"{src}.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return cubin, proc


def sass(cubin: str) -> dict:
    """{function key: [instructions]} of one cubin."""
    out = subprocess.run([_tool("cuobjdump"), "-sass", cubin], check=True,
                         capture_output=True, text=True).stdout
    funcs, cur = {}, None
    for line in out.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            cur = m.group(1)
            funcs[cur] = []
            continue
        if cur is None or not _ADDR.search(line):
            continue
        ins = _ENC.sub("", _ADDR.sub("", line)).strip().rstrip(";").strip()
        if ins:
            funcs[cur].append(ins)
    for name, ins in funcs.items():
        labels = {}
        funcs[name] = [_LABEL.sub(
            lambda m: labels.setdefault(m.group(0), f".L{len(labels)}"), i)
            for i in ins]
    names = list(funcs)
    demangled = subprocess.run([_tool("cu++filt")], input="\n".join(names),
                               check=True, capture_output=True,
                               text=True).stdout.splitlines()
    return {_key(d): funcs[n] for n, d in zip(names, demangled)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("dir_a")
    ap.add_argument("dir_b")
    ap.add_argument("--out")
    ap.add_argument("--sources", nargs="+", default=list(SOURCES))
    ap.add_argument("--stages", nargs="+", type=int, default=[0, 1, 2])
    args = ap.parse_args()
    total = {"functions": 0, "equal": 0, "differ": [], "missing": [],
             "only_in_b": []}
    with tempfile.TemporaryDirectory() as tmp:
        # every build at once, one nvcc each
        jobs = {(tag, src, st): _compile(root, src, st, tmp, tag)
                for tag, root in (("a", args.dir_a), ("b", args.dir_b))
                for src in args.sources for st in args.stages}
        for key, (_, proc) in jobs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed for {key}:\n{out}")
        for src in args.sources:
            for st in args.stages:
                a = sass(jobs["a", src, st][0])
                b = sass(jobs["b", src, st][0])
                total["only_in_b"] += [f"{src} RTT_STAGES={st} {key[:100]}"
                                       for key in b if key not in a]
                for key, ins in a.items():
                    total["functions"] += 1
                    tag = f"{src} RTT_STAGES={st} {key[:100]}"
                    if key not in b:
                        total["missing"].append(tag)
                        print(f"missing in B: {tag}")
                    elif b[key] == ins:
                        total["equal"] += 1
                        print(f"equal ({len(ins)} instructions): {tag}")
                    else:
                        total["differ"].append(tag)
                        print(f"DIFFER ({len(ins)} vs {len(b[key])} "
                              f"instructions): {tag}")
    line = json.dumps(total)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0 if total["equal"] == total["functions"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
