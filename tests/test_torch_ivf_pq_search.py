"""The port's IVF-PQ search (raft_tpu_torch.neighbors.ivf_pq) against the
JAX reference on indexes the reference built and convert.py carried over.

Two indexes: L2, PER_SUBSPACE, pq_bits 8, rot 20 (pq_dim 10 x pq_len 2);
inner product, PER_CLUSTER, pq_bits 4, rot 40 (pq_dim 8 x pq_len 5). Both
carry the int8 decoded-residual cache.

* The cache scan (scan_impl="pallas_interpret" at local_recall_target
  1.0 on both sides: kernel 2's plain version in the port, JAX's Pallas
  kernel in interpret mode, exact extraction): L2 / L2-sqrt / IP,
  compute bf16 and f32, a prefilter.
* The decode-then-matmul scan (scan_impl="xla" on both sides) is held
  against JAX's XLA route across the lut_dtype ladder, the bf16 internal
  distance type, a prefilter, and the cache read back through it. At
  k > 256 the port's default call on a CPU index takes it too, as the
  reference's "auto" takes its XLA body off the accelerator (default
  against default: tests/test_torch_queue_c.py).

Tolerance: distances 1e-4 relative plus 1e-4 absolute (sum order), ids
equal outside near-ties.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_pq
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

_FIELDS = ("centers", "centers_rot", "rotation", "pq_centers", "codes",
           "indices", "list_sizes", "rec_norms", "recon_cache")


def _clustered(seed, n, d, m, k_centers=20):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-4, 4, (k_centers, d)).astype(np.float32)
    x = (c[rng.integers(0, k_centers, n)]
         + rng.standard_normal((n, d))).astype(np.float32)
    q = (c[rng.integers(0, k_centers, m)]
         + rng.standard_normal((m, d))).astype(np.float32)
    return x, q


def carry(jix):
    arrays = {f: np.asarray(getattr(jix, f)) for f in _FIELDS}
    return convert.ivf_pq_index_from_numpy(
        arrays, jix.metric, device="cpu", codebook_kind=jix.codebook_kind,
        recon_scale=jix.recon_scale)


@pytest.fixture(scope="module")
def l2_index():
    x, q = _clustered(31, 3000, 20, 40)
    jix = jax_pq.build(jax_pq.IndexParams(n_lists=8, pq_dim=10,
                                          kmeans_n_iters=10), x)
    assert jix.cache_kind == "i8"
    return jix, carry(jix), q


@pytest.fixture(scope="module")
def ip_index():
    x, q = _clustered(32, 2500, 40, 40)
    jix = jax_pq.build(jax_pq.IndexParams(
        n_lists=8, pq_dim=8, pq_bits=4, kmeans_n_iters=10,
        metric=DistanceType.InnerProduct,
        codebook_kind=jax_pq.codebook_gen.PER_CLUSTER), x)
    assert jix.cache_kind == "i8"
    return jix, carry(jix), q


def _both(jix, pix, q, k, jax_kw, port_kw, prefilter=None, n_probes=4):
    mask = None
    if prefilter is not None:
        mask = np.random.default_rng(prefilter).random(pix.size) < 0.5
    jd, ji = jax_pq.search(
        jax_pq.SearchParams(n_probes=n_probes, local_recall_target=1.0,
                            **jax_kw), jix, q, k,
        prefilter=None if mask is None
        else JaxBitset.from_dense(jnp.asarray(mask)))
    pd, pi = ivf_pq.search(
        ivf_pq.SearchParams(n_probes=n_probes, **port_kw), pix,
        torch.from_numpy(q), k,
        prefilter=None if mask is None
        else Bitset.from_dense(torch.from_numpy(mask)))
    if mask is not None:
        ids = np_(pi)
        assert mask[ids[ids >= 0]].all()
    return pd, pi, jd, ji


@pytest.mark.parametrize("metric, cd", [
    (DistanceType.L2Expanded, "bf16"), (DistanceType.L2Expanded, "f32"),
    (DistanceType.L2SqrtExpanded, "bf16")], ids=["l2-bf16", "l2-f32",
                                                 "l2sqrt-bf16"])
def test_cache_scan_matches_pallas_interpret(l2_index, metric, cd):
    jix, pix, q = l2_index
    jix = dataclasses.replace(jix, metric=metric)
    pix = dataclasses.replace(pix, metric=metric)
    pd, pi, jd, ji = _both(jix, pix, q, 10,
                           dict(scan_impl="pallas_interpret",
                                compute_dtype=cd),
                           dict(scan_impl="pallas_interpret",
                                local_recall_target=1.0, compute_dtype=cd))
    assert_topk_match(pd, pi, jd, ji, 10)


def test_cache_scan_inner_product_per_cluster(ip_index):
    jix, pix, q = ip_index
    pd, pi, jd, ji = _both(jix, pix, q, 10,
                           dict(scan_impl="pallas_interpret"),
                           dict(scan_impl="pallas_interpret",
                                local_recall_target=1.0))
    assert_topk_match(pd, pi, jd, ji, 10)


def test_cache_scan_prefilter(l2_index):
    jix, pix, q = l2_index
    pd, pi, jd, ji = _both(jix, pix, q, 10,
                           dict(scan_impl="pallas_interpret"),
                           dict(scan_impl="pallas_interpret",
                                local_recall_target=1.0),
                           prefilter=5)
    assert_topk_match(pd, pi, jd, ji, 10)


def test_cache_scan_k_over_256(l2_index):
    jix, pix, q = l2_index
    assert pix.indices.shape[1] > 300
    pd, pi, jd, ji = _both(jix, pix, q[:6], 300,
                           dict(scan_impl="xla", compute_dtype="f32"),
                           dict(compute_dtype="f32"), n_probes=2)
    assert pd.shape == (6, 300)
    assert_topk_match(pd, pi, jd, ji, 300)


@pytest.mark.parametrize("which, lut, internal", [
    ("l2", "f32", "f32"), ("l2", "bf16", "f32"), ("l2", "f8", "f32"),
    ("l2", "i8", "bf16"), ("ip", "f32", "f32"), ("ip", "auto", "f32")])
def test_decode_scan_matches_xla(l2_index, ip_index, which, lut, internal):
    jix, pix, q = l2_index if which == "l2" else ip_index
    kw = dict(scan_impl="xla", lut_dtype=lut,
              internal_distance_dtype=internal)
    pd, pi, jd, ji = _both(jix, pix, q, 10, kw, kw)
    rtol = 1e-2 if internal == "bf16" else 1e-4
    assert_topk_match(pd, pi, jd, ji, 10, rtol=rtol)


def test_decode_scan_prefilter_and_torch_dtypes(l2_index):
    jix, pix, q = l2_index
    pd, pi, jd, ji = _both(
        jix, pix, q, 10, dict(scan_impl="xla", lut_dtype="f32"),
        dict(scan_impl="xla", lut_dtype=torch.float32), prefilter=6)
    assert_topk_match(pd, pi, jd, ji, 10)


def test_route_guards(l2_index):
    _, pix, q = l2_index
    qt = torch.from_numpy(q)
    with pytest.raises(ValueError, match="256"):
        ivf_pq.search(ivf_pq.SearchParams(n_probes=2, scan_impl="pallas"),
                      pix, qt, 300)
    nocache = dataclasses.replace(pix, recon_cache=None)
    with pytest.raises(ValueError, match="cache"):
        ivf_pq.search(ivf_pq.SearchParams(scan_impl="pallas"), nocache, qt,
                      5)
    with pytest.raises(ValueError, match="i8"):
        ivf_pq.search(ivf_pq.SearchParams(lut_dtype="i8"), nocache, qt, 5)
    with pytest.raises(ValueError, match="exceeds"):
        ivf_pq.search(ivf_pq.SearchParams(n_probes=1), pix, qt, 10_000)
    # without the cache "auto" decodes, and equals the explicit decode scan
    a = ivf_pq.search(ivf_pq.SearchParams(n_probes=3), nocache, qt, 5)
    b = ivf_pq.search(ivf_pq.SearchParams(n_probes=3, scan_impl="xla"),
                      nocache, qt, 5)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
