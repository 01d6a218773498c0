"""RaBitQ's refined recall as the rows grow, in the reference and the port.

    JAX_PLATFORMS=cpu python3 -m tests.torch_rung_scaling N_ROWS N_LISTS \
        N_PROBES [--queries 500] [--batch-size 200000]

Runs on the CPU, from the repository root. Makes SIFT-like rows of 96
dimensions with numpy (the manifold recipe of ``raft_tpu/bench/run.py``:
16 intrinsic dimensions, spread 24 around 64, noise 2, clipped to [0,
255]; rows from seed 3, queries from seed 4), then runs ``bench.py``'s
RaBitQ recipe (bench.py:428-450) — the default IVF-PQ build (pq_dim 48,
8 bits, trainset fraction 0.1), ``attach_rabitq_cache``, a first stage
of ``4 k`` candidates and an exact refine to ``k = 10`` — three ways on
the same rows:

* ``reference``: ``raft_tpu`` builds, attaches, searches (``scan_impl=
  "xla"``) and refines;
* ``port on the reference's index``: the same index carried into
  ``raft_tpu_torch`` by ``convert``, searched and refined by the port;
* ``port``: ``raft_tpu_torch`` builds, attaches, searches and refines.

Each line gives recall@10 of the first stage alone and refined from 40
and from 80 candidates, against the exact neighbours. The recall is the
algorithm's, so a run at a reduced scale (the same share of lists
probed) shows how the recipe's recall moves with the rows; the two
packages draw other random numbers, so their own builds differ a
little. It is a measurement, not a test: pytest does not collect it.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def sift_like(n: int, d: int, seed: int, intrinsic: int = 16,
              block: int = 1 << 18) -> np.ndarray:
    proj = np.random.default_rng(12345).standard_normal(
        (intrinsic, d)).astype(np.float32) / np.float32(intrinsic ** 0.5)
    rng = np.random.default_rng(seed)
    out = np.empty((n, d), np.float32)
    for r0 in range(0, n, block):
        r1 = min(n, r0 + block)
        z = 24.0 * rng.standard_normal((r1 - r0, intrinsic), np.float32)
        blk = 64.0 + z @ proj + 2.0 * rng.standard_normal((r1 - r0, d),
                                                          np.float32)
        np.clip(blk, 0.0, 255.0, out=out[r0:r1])
    return out


def recall(ids, truth) -> float:
    ids, truth = np.asarray(ids), np.asarray(truth)
    hit = sum(len(np.intersect1d(a, b)) for a, b in zip(ids, truth))
    return hit / truth.size


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int)
    ap.add_argument("n_lists", type=int)
    ap.add_argument("n_probes", type=int)
    ap.add_argument("--queries", type=int, default=500)
    ap.add_argument("--batch-size", type=int, default=200_000)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from raft_tpu.neighbors import ivf_pq as jax_pq
    from raft_tpu.neighbors.refine import refine as jax_refine
    from raft_tpu_torch import convert
    from raft_tpu_torch.neighbors import brute_force, ivf_pq, refine

    jax.config.update("jax_platforms", "cpu")
    k = 10
    x = sift_like(args.n, 96, seed=3)
    q = sift_like(args.queries, 96, seed=4)
    tx, tq = torch.from_numpy(x), torch.from_numpy(q)
    _, truth = brute_force.knn(tq, tx, k, device="cpu")
    truth = truth.numpy()
    print(f"{args.n} rows x 96, {args.n_lists} lists, {args.n_probes} "
          f"probes, {args.queries} queries, k = {k}", flush=True)

    def report(name, search, refine_fn, secs):
        line = f"{name}: build {secs:.1f} s; first stage " \
               f"{recall(search(k), truth):.4f}"
        for kc in (4 * k, 8 * k):
            line += f", {kc} -> {k} refined " \
                    f"{recall(refine_fn(search(kc)), truth):.4f}"
        print(line, flush=True)

    t0 = time.perf_counter()
    jix = jax_pq.attach_rabitq_cache(jax_pq.build(jax_pq.IndexParams(
        n_lists=args.n_lists, pq_dim=48, pq_bits=8,
        kmeans_trainset_fraction=0.1), x, batch_size=args.batch_size))
    jax.block_until_ready(jix.recon_cache)
    secs = time.perf_counter() - t0
    jsp = jax_pq.SearchParams(n_probes=args.n_probes, scan_impl="xla")
    jx, jq = jnp.asarray(x), jnp.asarray(q)
    report("reference", lambda kc: jax_pq.search(jsp, jix, jq, kc)[1],
           lambda c: jax_refine(jx, jq, c, k)[1], secs)

    fields = ("centers", "centers_rot", "rotation", "pq_centers", "codes",
              "indices", "list_sizes", "rec_norms", "recon_cache",
              "cache_qnorms", "cache_fac")
    arrays = {f: np.asarray(getattr(jix, f)) for f in fields}
    arrays["recon_scale"] = np.float32(jix.recon_scale)
    carried = convert.ivf_pq_index_from_numpy(
        arrays, jix.metric, device="cpu", codebook_kind=jix.codebook_kind,
        pq_bits=jix.pq_bits, cache_dtype=jix.cache_dtype)
    del jix, jx, jq
    sp = ivf_pq.SearchParams(n_probes=args.n_probes)

    def port_refine(c):
        return refine.refine(tx, tq, c, k, device="cpu")[1]

    report("port on the reference's index",
           lambda kc: ivf_pq.search(sp, carried, tq, kc)[1], port_refine,
           0.0)
    del carried
    t0 = time.perf_counter()
    pix = ivf_pq.attach_rabitq_cache(ivf_pq.build(ivf_pq.IndexParams(
        n_lists=args.n_lists, pq_dim=48, pq_bits=8,
        kmeans_trainset_fraction=0.1), tx, batch_size=args.batch_size,
        device="cpu"))
    secs = time.perf_counter() - t0
    report("port", lambda kc: ivf_pq.search(sp, pix, tq, kc)[1],
           port_refine, secs)


if __name__ == "__main__":
    main()
