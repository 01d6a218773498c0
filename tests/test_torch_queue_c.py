"""Faults of the port against the JAX reference, each repaired and held
here on the input that showed it.

1. IVF-Flat at k > 256 keeps min(k, cap) candidates per list, as the
   reference does, through the exact plain scan (the kernel keeps 256).
2. f32 queries against bf16 rows are not rounded to bf16: IVF-Flat rounds
   queries only at compute_dtype="bf16", brute force only for bf16
   queries, as the reference does.
3. The reference's parameter names are accepted: its backend names map to
   the kernel ("auto", "pallas") or the plain version ("xla",
   "pallas_interpret"), with the extraction arm the reference's kernel
   takes at the same local_recall_target (binned below 1 where the cap
   allows it); a fold arm forced by name runs, as the reference's does;
   and the reference's no-op or tiling arguments (IVF-Flat's
   conservative_memory_allocation, pairwise_distance's tile_m / tile_n)
   are accepted.
5. IVF-PQ's and 6. CAGRA's default search on a CPU index take the
   reference's CPU route (its "auto" off the accelerator): the decode
   body and the scattered traversal.
8. IVF-Flat over float16 and uint8 datasets: indexes the reference built
   (rows stored as the dataset's type) load and search in the port, rows
   kept as stored.
9. ``select_k`` orders NaN as the reference's impl of the same name:
   "top_k" by XLA's total order (the sign of a NaN counts), "hierarchical"
   with NaN quarantined, "auto" through the reference's dispatch
   (``dispatch_select_impl``).

Tolerance: distances 1e-4 relative (and absolute), ids equal outside
near-ties (tests/torch_parity.py).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.distance.pairwise import pairwise_distance as \
    jax_pairwise_distance
from raft_tpu.matrix.select_k import dispatch_select_impl as \
    jax_dispatch_select_impl
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu.neighbors import cagra as jax_cagra
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors import nn_descent as jax_nnd
from raft_tpu_torch import convert
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.matrix.select_k import dispatch_select_impl, select_k
from raft_tpu_torch.neighbors import brute_force, cagra, ivf_flat, ivf_pq, \
    nn_descent
from tests.oracles import naive_knn
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _carry(ix, storage_dtype=None):
    arrays = {"centers": ix.centers, "storage": ix.storage,
              "indices": ix.indices, "list_sizes": ix.list_sizes}
    if ix.data_norms is not None:
        arrays["data_norms"] = ix.data_norms
    arrays = {k: np.asarray(v.astype(jnp.float32) if k == "storage" else v)
              for k, v in arrays.items()}
    return convert.ivf_flat_index_from_numpy(
        arrays, ix.metric, device="cpu", storage_dtype=storage_dtype)


def test_ivf_flat_k_over_256_is_exact():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((4000, 8)).astype(np.float32)
    q = rng.standard_normal((5, 8)).astype(np.float32)
    jix = jax_ivf.build(jax_ivf.IndexParams(n_lists=4, kmeans_n_iters=10), x)
    jd, ji = jax_ivf.search(jax_ivf.SearchParams(
        n_probes=2, compute_dtype="f32", local_recall_target=1.0), jix, q,
        400)
    pd, pi = ivf_flat.search(ivf_flat.SearchParams(
        n_probes=2, compute_dtype="f32"), _carry(jix), q, 400)
    assert pd.shape == (5, 400)
    assert_topk_match(pd, pi, jd, ji, 400)
    # the forced kernel cannot keep 400 per list and says so
    with pytest.raises(ValueError, match="256"):
        ivf_flat.search(ivf_flat.SearchParams(n_probes=2, scan_impl="pallas"),
                        _carry(jix), q, 400)


@pytest.mark.parametrize("jax_impl", ["xla", "pallas_interpret"])
def test_ivf_flat_f32_queries_on_bf16_rows(jax_impl):
    rng = np.random.default_rng(12)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = (1.37 * rng.standard_normal((64, 16))).astype(np.float32)
    jix = jax_ivf.build(jax_ivf.IndexParams(
        n_lists=8, kmeans_n_iters=10, storage_dtype="bf16"), x)
    jd, ji = jax_ivf.search(jax_ivf.SearchParams(
        n_probes=8, compute_dtype="f32", local_recall_target=1.0,
        scan_impl=jax_impl), jix, q, 10)
    pd, pi = ivf_flat.search(ivf_flat.SearchParams(
        n_probes=8, compute_dtype="f32"), _carry(jix, "bf16"), q, 10)
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-5, atol=1e-4)


def test_brute_force_f32_queries_on_bf16_rows():
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2000, 16)).astype(np.float32)
    q = rng.standard_normal((64, 16)).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    jd, ji = jax_bf.search(jax_bf.build(xb), jnp.asarray(q), 10)
    pd, pi = brute_force.search(brute_force.build(
        torch.from_numpy(x).to(torch.bfloat16), device="cpu"),
        torch.from_numpy(q), 10)
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-5, atol=1e-4)


# --- 3. the reference's parameter names -----------------------------------
# Each case runs the port and the reference with the same arguments on the
# same inputs: IVF-Flat on a JAX-built index carried across, CAGRA on one
# exact KNN graph, nn-descent by its graph's recall of the exact KNN graph,
# within 0.02 of the reference's (the two draw different random starts, so
# their graphs agree in quality, not bit for bit).

@pytest.fixture(scope="module")
def small():
    rng = np.random.default_rng(14)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    q = rng.standard_normal((32, 16)).astype(np.float32)
    jix = jax_ivf.build(jax_ivf.IndexParams(n_lists=8, kmeans_n_iters=5), x)
    _, knn = naive_knn(x, x, 9)
    return dict(x=x, q=q, jix=jix, knn=knn[:, 1:].astype(np.int32))


def _ivf_flat_call(s, kw):
    jkw = dict(kw)
    if kw.get("scan_impl") == "pallas":
        # the reference's compiled kernel needs a TPU; off it the same
        # kernel runs interpreted, at the same local_recall_target, so both
        # take the same extraction arm (binned at k = 10 on this cap)
        jkw.update(scan_impl="pallas_interpret")
    got = ivf_flat.search(ivf_flat.SearchParams(n_probes=4, **kw),
                          _carry(s["jix"]), s["q"], 10)
    ref = jax_ivf.search(jax_ivf.SearchParams(n_probes=4, **jkw), s["jix"],
                         s["q"], 10)
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-4)


def _graph_overlap(a, b) -> float:
    return float(np.mean([len(set(ra) & set(rb)) / len(ra)
                          for ra, rb in zip(a, b)]))


def _nn_descent_call(s, kw):
    p = dict(graph_degree=8, max_iterations=10)
    got = np_(nn_descent.build(nn_descent.IndexParams(**p, **kw), s["x"],
                               device="cpu").graph)
    ref = np.asarray(jax_nnd.build(jax_nnd.IndexParams(**p, **kw),
                                   s["x"]).graph)
    r_port = _graph_overlap(got, s["knn"])
    r_ref = _graph_overlap(ref, s["knn"])
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


def _select_k_call(s, kw):
    x = s["x"][:, :40]
    got = select_k(x, 7, device="cpu", **kw)
    ref = jax_select_k(jnp.asarray(x), 7, **kw)
    assert_topk_match(*got, *ref, 7, rtol=1e-5, atol=1e-4)


def _brute_force_call(s, kw):
    got = brute_force.search(brute_force.build(s["x"], device="cpu"),
                             s["q"], 10, **kw)
    ref = jax_bf.search(jax_bf.build(s["x"]), s["q"], 10, **kw)
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-4)


def _ivf_flat_params_call(s, kw):
    # every list probed, so both builds give the exact top-k
    p = dict(n_lists=8, kmeans_n_iters=5, **kw)
    got = ivf_flat.search(ivf_flat.SearchParams(n_probes=8),
                          ivf_flat.build(ivf_flat.IndexParams(**p), s["x"],
                                         device="cpu"), s["q"], 10)
    ref = jax_ivf.search(jax_ivf.SearchParams(
        n_probes=8, local_recall_target=1.0),
        jax_ivf.build(jax_ivf.IndexParams(**p), s["x"]), s["q"], 10)
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-4)


def _pairwise_call(s, kw):
    x, q = s["x"][:300], s["q"]
    got = pairwise_distance(q, x, "euclidean", device="cpu", **kw)
    ref = jax_pairwise_distance(q, x, "euclidean", **kw)
    np.testing.assert_allclose(np_(got), np.asarray(ref), rtol=1e-5,
                               atol=1e-4)


def _cagra_call(s, kw):
    sp = dict(itopk_size=32, max_iterations=8, **kw)
    got = cagra.search(cagra.SearchParams(**sp),
                       cagra.from_graph(s["x"], s["knn"], device="cpu"),
                       s["q"], 5)
    ref = jax_cagra.search(jax_cagra.SearchParams(**sp),
                           jax_cagra.from_graph(s["x"], s["knn"]), s["q"], 5)
    assert_topk_match(*got, *ref, 5, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("call, kw", [
    (_ivf_flat_call, dict(local_recall_target=0.9, merge_recall_target=0.9,
                          scan_impl="auto")),
    (_ivf_flat_call, dict(local_recall_target=0.95, scan_impl="pallas")),
    (_ivf_flat_call, dict(scan_impl="pallas_interpret")),
    (_ivf_flat_call, dict(scan_impl="xla")),
    (_nn_descent_call, dict(join_impl="xla")),
    (_nn_descent_call, dict(join_impl="pallas_interpret")),
    (_select_k_call, dict(sorted=True, impl="tournament")),
    (_select_k_call, dict(sorted=True, impl="top_k")),
    (_brute_force_call, dict(tile_n=256, fast=False, impl="scan")),
    (_brute_force_call, dict(tile_n=512, fast=True, impl="auto")),
    (_cagra_call, dict(scan_impl="xla")),
    (_ivf_flat_params_call, dict(conservative_memory_allocation=True)),
    (_pairwise_call, dict(tile_m=16, tile_n=128)),
], ids=["ivf_flat-recall-targets", "ivf_flat-pallas",
        "ivf_flat-pallas_interpret", "ivf_flat-xla", "nn_descent-xla",
        "nn_descent-pallas_interpret", "select_k-tournament",
        "select_k-top_k", "brute_force-scan", "brute_force-fast",
        "cagra-xla", "ivf_flat-conservative_memory_allocation",
        "pairwise-tiles"])
def test_reference_arguments_accepted(small, call, kw):
    call(small, kw)


def test_forced_approximate_arm(small):
    # kernel 1's fold arm forced by name runs (its plain version on the
    # CPU) and returns the reference's interpreted fold kernel's result
    x, q = small["x"], small["q"]
    got = brute_force.search(brute_force.build(x, device="cpu"), q, 10,
                             impl="fused_fold")
    ref = jax_bf.search(jax_bf.build(x), q, 10, impl="fused_fold:interpret")
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError, match="scan_impl"):
        ivf_flat.search(ivf_flat.SearchParams(scan_impl="binned"),
                        ivf_flat.build(ivf_flat.IndexParams(n_lists=4),
                                       x, device="cpu"), q, 5)


# --- 5 and 6. default calls on a CPU index ---------------------------------
# The reference's "auto" takes its XLA route off the accelerator: IVF-PQ's
# decode body and CAGRA's scattered traversal. The port's default call on a
# CPU index takes the same route, on the reference's own index saved and
# loaded by the port; data and arguments are the probe's that found each
# fault (3,000 x 32 standard-normal rows, 32 queries).

@pytest.fixture(scope="module")
def probe():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((32, 32)).astype(np.float32)
    return x, q


def test_ivf_pq_default_call_on_cpu_index(probe, tmp_path):
    x, q = probe
    jix = jax_pq.build(jax_pq.IndexParams(n_lists=16, kmeans_n_iters=5), x)
    assert jix.cache_kind == "i8"
    path = str(tmp_path / "probe.ivf_pq")
    jax_pq.save(path, jix)
    pix = ivf_pq.load(path, device="cpu")
    ref = jax_pq.search(jax_pq.SearchParams(n_probes=4), jix, q, 10)
    got = ivf_pq.search(ivf_pq.SearchParams(n_probes=4), pix, q, 10)
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-5)


def test_cagra_default_call_on_cpu_index(probe, tmp_path):
    x, q = probe
    jix = jax_cagra.build(jax_cagra.IndexParams(
        intermediate_graph_degree=32, graph_degree=16), x)
    assert jix.nbr_pack is not None
    path = str(tmp_path / "probe.cagra")
    jax_cagra.save(path, jix)
    pix = cagra.load(path, device="cpu")
    ref = jax_cagra.search(jax_cagra.SearchParams(), jix, q, 10)
    got = cagra.search(cagra.SearchParams(), pix, q, 10)
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", ["float16", "uint8"])
def test_ivf_flat_f16_and_uint8_default_call(probe, tmp_path, dtype):
    """Item 8: the reference stores IVF-Flat rows as the dataset's type;
    the port loads such an index without widening it and its default
    search (the plain exact scan on a CPU index) answers as the
    reference's default call does."""
    x, q = probe
    if dtype == "uint8":
        data = np.clip(x * 30 + 128, 0, 255).astype(np.uint8)
        q = np.clip(q * 30 + 128, 0, 255).astype(np.float32)
    else:
        data = x.astype(np.float16)
    jix = jax_ivf.build(jax_ivf.IndexParams(n_lists=16), data)
    path = str(tmp_path / f"probe_{dtype}.ivf_flat")
    jax_ivf.save(path, jix)
    pix = ivf_flat.load(path, device="cpu")
    assert pix.storage.dtype == getattr(torch, dtype)
    ref = jax_ivf.search(jax_ivf.SearchParams(n_probes=4), jix, q, 10)
    got = ivf_flat.search(ivf_flat.SearchParams(n_probes=4), pix, q, 10)
    # the module's tolerance: uint8 rows' distances reach 4e4, where the
    # expanded form's sums in two orders differ by ~1e-5 relative
    assert_topk_match(*got, *ref, 10)


_NAN = np.float32(np.nan)
# +NaN, -NaN, +-inf and signed zeros, one column of each sign apart
_NAN_ROWS = np.array([[_NAN, 1, 2, -_NAN, -1, 0.5],
                      [np.inf, 1, -np.inf, _NAN, 0, -0.0],
                      [-_NAN, 5, -np.inf, np.inf, 0, 0.0],
                      [0.0, -0.0, 1, -0.0, 0.0, -_NAN]], np.float32)


@pytest.mark.parametrize("k", [3, 6])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("impl", ["top_k", "hierarchical", "auto"])
def test_select_k_nan_order_matches_the_impl(impl, select_min, k):
    """Item 9: values (bit for bit, the NaN's sign included) and ids as
    the reference's same impl gives them, at both ends."""
    rows = _NAN_ROWS
    if impl == "hierarchical":
        # its local top_k orders -0.0 before +0.0 and its merge tree takes
        # them as equal; the NaN rule is the point here
        rows = np.where(rows == 0, np.float32(0.0), rows)
    jv, ji = jax_select_k(rows, k, select_min=select_min, impl=impl)
    pv, pi = select_k(rows, k, select_min=select_min, impl=impl,
                      device="cpu")
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))
    np.testing.assert_array_equal(np_(pv).view(np.int32),
                                  np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("batch, n, k, dtype, op, fallback", [
    (4, 6, 3, np.float32, "select_k", None),
    (64, 8192, 64, np.float32, "select_k", None),
    (10, 100_000, 300, np.float32, "select_k", None),
    (10, 100_000, 300, np.int32, "select_k", None),
    (10, 2000, 300, np.float32, "select_k", None),
    (4, 30, 9, np.int32, "select_k", None),
    (256, 1280, 10, np.float32, "merge_topk", "auto"),
    (10_000, 125_184, 42, np.float32, "merge_topk", "auto"),
    (8, 20_000, 512, np.float32, "merge_topk", "auto")])
def test_dispatch_select_impl_matches_reference(batch, n, k, dtype, op,
                                                fallback):
    want = jax_dispatch_select_impl(batch, n, k, dtype, op=op,
                                    fallback=fallback)
    got = dispatch_select_impl(batch, n, k,
                               torch.from_numpy(np.zeros(1, dtype)).dtype,
                               op=op, fallback=fallback, device="cpu")
    assert got == want
