"""Builds the CUDA kernels in ``csrc/`` with nvcc and loads them with ctypes.

Each ``csrc/<name>.cu`` becomes ``_kernels/lib<name>-<hash>.so`` beside this
file (the directory is git-ignored), where the hash covers the sources, the
shared header and the flags, so an edited source builds anew and an
unchanged one is reused. Building happens at first use or through
:func:`build_all`, which starts one nvcc per library at once. Nothing
here runs at import time.

A kernel of ``STAGED`` can also be built with only its first stages
(``RTT_STAGES``; for the scan kernels, ``scan_topk.cuh``: 0 = the staging
loads and the epilogue, 1 = plus the dots, 2 = plus the top-k selection,
the whole kernel; for the local join: 0 = the candidate rows gathered, 1
= plus the scores, 2 = plus the merge). The partial builds exist to split
a kernel's time by stage;
inside :func:`only_stages` the wrappers launch them instead of the whole
kernel, and their outputs are not results.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

_HERE = Path(__file__).resolve().parent
CSRC = _HERE / "csrc"
BUILD_DIR = _HERE / "_kernels"
KERNELS = ("fused_knn_topk", "ivf_list_scan_topk", "graph_local_join",
           "cagra_beam_step")
# the kernels whose source takes RTT_STAGES (the others build whole only)
STAGED = ("fused_knn_topk", "ivf_list_scan_topk", "graph_local_join")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

FULL = 2        # RTT_STAGES of the whole kernel

# (name, stages) -> loaded library; one load per process
_LOADED: Dict[Tuple[str, int], ctypes.CDLL] = {}
# name -> what nvcc printed for the whole kernel (registers / spills)
BUILD_LOG: Dict[str, str] = {}
# the stages load() builds and loads; FULL except inside only_stages()
_stages = FULL


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels build only where the CUDA toolkit "
        "is installed (PATH or $CUDA_HOME/bin)")


def _flags(stages: int):
    return NVCC_FLAGS + [f"-DRTT_STAGES={int(stages)}"]


def _lib_path(name: str, stages: int = FULL) -> Path:
    h = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(_flags(stages)).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str, stages: int = FULL):
    """Start nvcc for ``name`` unless its library exists; returns
    (path, tmp path, process or None)."""
    path = _lib_path(name, stages)
    if path.exists():
        return path, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *_flags(stages), "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return path, tmp, proc


def _finish(name: str, path: Path, tmp, proc,
            stages: int = FULL) -> Path:
    if proc is None:
        return path
    out, _ = proc.communicate()
    if stages == FULL:
        BUILD_LOG[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{out}")
    os.replace(tmp, path)       # atomic: a concurrent builder sees all or none
    return path


def build_all(names: Iterable[str] = KERNELS,
              stage_set: Iterable[int] = (FULL,)) -> float:
    """Build every named kernel at each of ``stage_set`` (a kernel not in
    ``STAGED`` whole only), one nvcc per library, all at once. Returns
    the wall seconds."""
    t0 = time.perf_counter()
    started = {(n, st): _start(n, st) for n in names
               for st in (stage_set if n in STAGED else (FULL,))}
    for (n, st), (path, tmp, proc) in started.items():
        _finish(n, path, tmp, proc, st)
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built at first use (with the stages
    that :func:`only_stages` selects, by default the whole kernel)."""
    key = (name, _stages if name in STAGED else FULL)
    lib = _LOADED.get(key)
    if lib is None:
        path = _finish(name, *_start(*key), key[1])
        lib = ctypes.CDLL(str(path))
        lib.rtt_error_string.argtypes = [ctypes.c_int]
        lib.rtt_error_string.restype = ctypes.c_char_p
        _LOADED[key] = lib
    return lib


@contextlib.contextmanager
def only_stages(n: int):
    """Within the block, :func:`load` gives the kernels built with only
    their first ``n`` stages (module docstring) — for stage timings."""
    global _stages
    prev, _stages = _stages, int(n)
    try:
        yield
    finally:
        _stages = prev


def aligned(t):
    """``t``, or a copy where its address is not 16-byte aligned (the
    Hopper bodies' cp.async loads); None passes through."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def ptr(t):
    """A tensor's device address for a ``ctypes.c_void_p`` argument (None
    passes a null pointer)."""
    return None if t is None else t.data_ptr()


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise when a launch returned a CUDA error code."""
    if rc != 0:
        msg = lib.rtt_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")
