"""Smoke run of the PyTorch/CUDA port (raft_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit, no result line):

1. device  — a CUDA card is required; prints the card's name and power
             limit as nvidia-smi reports them;
2. build   — compiles every CUDA kernel of the main path with nvcc, one
             process per library, all at once: each kernel whole, and
             again with only its first stages (for the stage timings);
3. parity  — holds each kernel against its plain PyTorch version on the
             card, first on small ragged shapes (lists shorter than k, a
             keep filter, all three metrics, f32 and bf16), then at the
             main path's own shapes;
4. main path — IVF-Flat on 1,000,000 x 128 f32 SIFT-like rows made on the
             card from a seed: build with n_lists=1024, search 10,000
             queries with n_probes=64 and k=10, recall@10 against the
             port's exact brute force on 1,000 queries (>= 0.90), QPS as
             the median of 5 timed batches after a warm-up, and a
             profiler breakdown of one batch; every kernel must have
             launched during the main path's run;
5. report  — each kernel timed at the main path's shapes beside its plain
             version and its bound, and split by stage (the staging loads
             and epilogue, the dots, the top-k selection: the builds with
             fewer stages timed on the same inputs); then the nvidia-smi
             line, one JSON line of per-kernel numbers, and last the
             result line.

Tolerances: kernel and plain version both sum exact products in f32, in
different orders, so distances agree to 1e-4 relative (plus 1e-4
absolute) and ids agree exactly wherever a distance is not within that
tolerance of its neighbour in the row (a tie).

The script imports nothing of JAX or of the JAX package.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import torch

H100_HBM_BYTES_PER_S = 3.35e12        # NVIDIA data sheet, SXM
H100_F32_FLOPS = 67e12                 # f32 on the CUDA cores
H100_BF16_FLOPS = 989e12               # bf16 tensor cores, dense
RTOL = ATOL = 1e-4
RECALL_FLOOR = 0.90


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


def compare(name, kd, ki, pd, pi) -> dict:
    """Kernel output (kd, ki) against the plain version's (pd, pi); raises
    beyond tolerance. Returns the max distance difference and the number
    of tie-free keys compared."""
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
    tol = ATOL + RTOL * pd.abs().where(fin, torch.zeros_like(pd))
    if bool((diff > tol).any()):
        raise SmokeFailure(f"{name}: distances differ by up to {max_err} "
                           f"(tolerance 1e-4 relative)")
    # tie-free keys: rows are sorted, so a tie is with a neighbour
    gap = (pd[:, 1:] - pd[:, :-1]).abs()
    tied = torch.zeros_like(fin)
    tied[:, 1:] |= gap <= tol[:, 1:]
    tied[:, :-1] |= gap <= tol[:, :-1]
    keyed = fin & ~tied
    n_keyed = int(keyed.sum())
    n_differ = int((ki[keyed] != pi[keyed]).sum())
    log(f"  {name}: max |d| diff {max_err:.3g}, ids differ on {n_differ} "
        f"of {n_keyed} tie-free keys")
    if n_differ:
        raise SmokeFailure(f"{name}: ids differ on tie-free keys")
    return {"max_abs_err": max_err, "tie_free_keys": n_keyed}


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
    log(f"build: {len(_build.KERNELS)} kernels x {len(stage_set)} stage sets, "
        f"{len(_build.KERNELS) * len(stage_set)} nvcc at once, in "
        f"{secs:.2f} s")
    for name, out in _build.BUILD_LOG.items():
        regs = [ln.strip() for ln in out.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}: " + " | ".join(regs))


def phase_small_parity(dev) -> None:
    from raft_tpu_torch.ops import fused_topk, ivf_scan

    g = torch.Generator(device=dev).manual_seed(1)
    log("parity (small, ragged):")
    for m, n, d, k, mk, dt, filt in [
            (5, 300, 24, 10, fused_topk.L2, torch.float32, False),
            (70, 3000, 33, 100, fused_topk.IP, torch.float32, True),
            (64, 2000, 64, 256, fused_topk.COSINE, torch.float32, False),
            (100, 4000, 128, 10, fused_topk.L2, torch.bfloat16, True)]:
        q = torch.randn(m, d, generator=g, device=dev)
        x = torch.randn(n, d, generator=g, device=dev).to(dt)
        keep = ((torch.rand(n, generator=g, device=dev) < 0.6).int()
                if filt else None)
        kd, ki = fused_topk.fused_knn_topk(q, x, k, metric_kind=mk,
                                           keep=keep)
        pd, pi = fused_topk.fused_knn_topk_plain(q, x, k, metric_kind=mk,
                                                 keep=keep)
        compare(f"fused_knn_topk m={m} n={n} d={d} k={k} metric={mk} "
                f"{str(dt)[6:]} keep={filt}", kd, ki, pd, pi)

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
    for mk, qa, xn, kp, k, dt in [
            (ivf_scan.L2, qn, norms, None, 10, torch.float32),
            (ivf_scan.IP, None, None, keep, 50, torch.float32),
            (ivf_scan.COSINE, qn.sqrt(), norms, keep, 256, torch.float32),
            (ivf_scan.L2, qn, norms, keep, 10, torch.bfloat16)]:
        st = storage.to(dt)
        kd, ki = ivf_scan.ivf_list_scan_topk(st, ids, sizes, bl, bq, q, qa,
                                             xn, kp, k=k, metric_kind=mk)
        pd, pi = ivf_scan.ivf_list_scan_topk_plain(st, ids, sizes, bl, bq, q,
                                                   qa, xn, kp, k=k,
                                                   metric_kind=mk)
        compare(f"ivf_list_scan_topk k={k} metric={mk} {str(dt)[6:]} "
                f"keep={kp is not None}", kd, ki, pd, pi)


def phase_small_search(dev) -> None:
    """The whole search on a small index: the card's kernel path against
    the same index searched on the CPU (plain versions)."""
    import dataclasses

    from raft_tpu_torch.neighbors import ivf_flat

    x = sift_like(20_000, 128, seed=3, device=dev)
    q = sift_like(300, 128, seed=4, device=dev)
    ix = ivf_flat.build(ivf_flat.IndexParams(n_lists=64, kmeans_n_iters=10),
                        x, device=dev)
    sp = ivf_flat.SearchParams(n_probes=8)
    kd, ki = ivf_flat.search(sp, ix, q, 10)
    cpu_ix = dataclasses.replace(
        ix, **{f: getattr(ix, f).cpu() for f in
               ("centers", "storage", "indices", "list_sizes",
                "data_norms")})
    pd, pi = ivf_flat.search(sp, cpu_ix, q.cpu(), 10)
    log("parity (small IVF-Flat search, card vs CPU):")
    compare("ivf_flat.search 20k x 128, 64 lists", kd.cpu(), ki.cpu(), pd,
            pi)


def main_path(dev, n=1_000_000, d=128, nq=10_000, n_lists=1024,
              n_probes=64, k=10) -> dict:
    """Build + search + recall, with the kernel inputs captured for the
    per-kernel measurements that follow."""
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
        orig.launches = 0
        wrapped[name] = (mod, orig, rec)
        setattr(mod, name, rec)
    try:
        t0 = time.perf_counter()
        index = ivf_flat.build(ivf_flat.IndexParams(n_lists=n_lists), x,
                               device=dev)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        sp = ivf_flat.SearchParams(n_probes=n_probes)
        out_d, out_i = ivf_flat.search(sp, index, q, k)
        _, truth = brute_force.knn(q[:1000], x, k, device=dev)
        torch.cuda.synchronize()
        launches = {name: orig.launches + rec.launches
                    for name, (_, orig, rec) in wrapped.items()}
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
            "recall": rec, "qps": nq / med}


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


def measure_ivf(args, kw, launches) -> dict:
    from raft_tpu_torch.ops import ivf_scan

    (storage, indices, list_sizes, bucket_list, bucket_q, queries, qaux,
     norms, keep) = (list(args) + [None] * 9)[:9]
    k, mk = kw["k"], kw["metric_kind"]
    log(f"kernel ivf_list_scan_topk at the main path's shapes: storage "
        f"{tuple(storage.shape)} {storage.dtype}, buckets "
        f"{tuple(bucket_q.shape)}, queries {tuple(queries.shape)} "
        f"{queries.dtype}, k={k}")
    before = ivf_scan.ivf_list_scan_topk.launches

    def kern():
        return ivf_scan.ivf_list_scan_topk(*args, **kw)

    def plain():
        return ivf_scan.ivf_list_scan_topk_plain(*args, **kw)

    kd, ki = kern()
    pd, pi = plain()
    err = compare("ivf_list_scan_topk (main-path shapes)", kd, ki, pd, pi)
    ms = cuda_ms(kern, reps=10)
    stage_split("ivf_list_scan_topk", kern, ms)
    plain_ms = cuda_ms(plain, reps=2)
    ivf_scan.ivf_list_scan_topk.launches = before   # measurement launches

    # the least time for this run's data: probed lists read once (rows,
    # ids, norms), queries, bucket tables and outputs once; dots for the
    # valid (query, list) pairs only
    C, cap, d = storage.shape
    sizes = list_sizes.long()
    valid_q = (bucket_q >= 0).sum(1).long()
    rows_scanned = (valid_q * sizes[bucket_list.long()]).sum()
    probed = torch.zeros(C, dtype=torch.bool, device=storage.device)
    probed[bucket_list.long()[valid_q > 0]] = True
    probed_rows = int(sizes[probed].sum())
    nb, G = bucket_q.shape
    bytes_ = (probed_rows * (d * storage.element_size() + 4
                             + (4 if norms is not None else 0))
              + queries.shape[0] * d * 4 + queries.shape[0] * 4
              + nb * 4 + nb * G * 4 + C * 4 + nb * G * k * 8)
    flops = 2.0 * d * float(rows_scanned)
    bf16 = torch.bfloat16 in (storage.dtype, queries.dtype)
    peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    log(f"  ivf_list_scan_topk: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain; "
        f"{flops / 1e9:.1f} GFLOP ({'bf16' if bf16 else 'f32'} operands), "
        f"{bytes_ / 1e9:.3f} GB -> bound {max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return {"name": "ivf_list_scan_topk", "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/ivf_list_scan_topk.cu",
            "replaces": "raft_tpu/ops/ivf_scan.py:198",
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


def measure_knn(args, kw, launches) -> dict:
    from raft_tpu_torch.ops import fused_topk

    queries, dataset, k = args[:3]
    mk = kw["metric_kind"]
    log(f"kernel fused_knn_topk at the main path's shapes: queries "
        f"{tuple(queries.shape)} {queries.dtype}, dataset "
        f"{tuple(dataset.shape)} {dataset.dtype}, k={k}, metric={mk}")
    before = fused_topk.fused_knn_topk.launches

    def kern():
        return fused_topk.fused_knn_topk(*args, **kw)

    def plain():
        return fused_topk.fused_knn_topk_plain(*args, **kw)

    kd, ki = kern()
    pd, pi = plain()
    err = compare("fused_knn_topk (main-path shapes)", kd, ki, pd, pi)
    ms = cuda_ms(kern, reps=10)
    stage_split("fused_knn_topk", kern, ms)
    plain_ms = cuda_ms(plain, reps=2)
    fused_topk.fused_knn_topk.launches = before     # measurement launches

    def library():
        return torch.topk(torch.cdist(queries.float(), dataset.float()), k,
                          largest=False)

    lib_ms = cuda_ms(library, reps=3)
    m, d = queries.shape
    n = dataset.shape[0]
    bytes_ = (m * d * 4 + n * d * dataset.element_size() + n * 4 + m * 4
              + m * k * 8 + (n * 4 if kw.get("keep") is not None else 0))
    flops = 2.0 * m * n * d
    bf16 = torch.bfloat16 in (queries.dtype, dataset.dtype)
    peak = H100_BF16_FLOPS if bf16 else H100_F32_FLOPS
    t_bytes = bytes_ / H100_HBM_BYTES_PER_S * 1e3
    t_ops = flops / peak * 1e3
    log(f"  fused_knn_topk: {ms:.3f} ms kernel, {plain_ms:.3f} ms plain, "
        f"{lib_ms:.3f} ms torch.cdist+torch.topk; {flops / 1e9:.1f} GFLOP "
        f"({'bf16' if bf16 else 'f32'}), {bytes_ / 1e9:.3f} GB -> bound "
        f"{max(t_bytes, t_ops):.3f} ms "
        f"({'bytes' if t_bytes >= t_ops else 'operations'})")
    return {"name": "fused_knn_topk", "route": "cuda",
            "source": "raft_tpu_torch/ops/csrc/fused_knn_topk.cu",
            "replaces": "raft_tpu/ops/fused_topk.py:113",
            "launches": launches, "max_abs_err": err["max_abs_err"],
            "ms": ms, "plain_ms": plain_ms,
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms}


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
        phase_small_search(dev)
        res = main_path(dev)
        cap = res["captured"]
        kernels = [measure_ivf(*cap["ivf_list_scan_topk"],
                               res["launches"]["ivf_list_scan_topk"]),
                   measure_knn(*cap["fused_knn_topk"],
                               res["launches"]["fused_knn_topk"])]
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    log(f"main path: build {res['build_s']:.3f} s, QPS {res['qps']:.1f}, "
        f"recall@10 {res['recall']:.4f}; total {time.perf_counter() - t_start:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
