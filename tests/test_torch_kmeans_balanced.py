"""The port's balanced kmeans (raft_tpu_torch.cluster.kmeans_balanced)
against the JAX reference.

Fits cannot match bit for bit (jax.random and torch.Generator draw
different numbers), so fits are held to quality — inertia within 3% and
cluster sizes as balanced — while the deterministic pieces (predict on
shared centers, center sums, the fine-cluster split) match exactly or to
1e-5 relative."""

import numpy as np
import pytest
import torch

from raft_tpu.cluster import kmeans_balanced as jax_kb
from raft_tpu.distance.types import DistanceType
from raft_tpu_torch.cluster import kmeans_balanced as kb
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def blobs():
    """Rows near a 4-dim manifold in 8 dims: no natural cluster count, so
    the balance of a fit is a property of the trainer, not of the seed."""
    rng = np.random.default_rng(3)
    proj = rng.standard_normal((4, 8)).astype(np.float32)
    z = rng.standard_normal((4000, 4)).astype(np.float32)
    noise = rng.standard_normal((4000, 8)).astype(np.float32)
    return (3.0 * z @ proj + 0.5 * noise).astype(np.float32)


def _inertia(x, centers):
    d = ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)
    lab = d.argmin(1)
    return d.min(1).sum(), np.bincount(lab, minlength=centers.shape[0])


@pytest.mark.parametrize("n_clusters", [8, 64])
def test_fit_quality_matches_jax(blobs, n_clusters):
    """n_clusters=8 takes the flat path, 64 the hierarchical one."""
    p_jax = jax_kb.KMeansBalancedParams(n_clusters=n_clusters, n_iters=10)
    p = kb.KMeansBalancedParams(n_clusters=n_clusters, n_iters=10)
    cj = np.asarray(jax_kb.fit(p_jax, blobs))
    cp = np_(kb.fit(p, blobs, device="cpu"))
    assert cp.shape == cj.shape and np.isfinite(cp).all()
    ij, sj = _inertia(blobs, cj)
    ip, sp = _inertia(blobs, cp)
    assert ip <= 1.03 * ij, (ip, ij)
    assert sp.max() <= 1.25 * sj.max() and sp.min() >= 0.5 * sj.min(), \
        (sp, sj)


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_predict_matches_jax_on_shared_centers(blobs, metric):
    centers = blobs[np.random.default_rng(4).choice(4000, 16, replace=False)]
    pj = jax_kb.KMeansBalancedParams(n_clusters=16, metric=metric)
    pp = kb.KMeansBalancedParams(n_clusters=16, metric=metric)
    lj = np.asarray(jax_kb.predict(pj, centers, blobs))
    lp = np_(kb.predict(pp, centers, blobs, device="cpu"))
    # only exact near-ties between two centers may flip
    assert (lj == lp).mean() > 0.999


def test_calc_centers_and_sizes_matches_jax(blobs):
    labels = np.random.default_rng(5).integers(0, 12, 4000).astype(np.int32)
    cj, sj = jax_kb.calc_centers_and_sizes(blobs, labels, 12)
    cp, sp = kb.calc_centers_and_sizes(blobs, labels, 12, device="cpu")
    np.testing.assert_allclose(np_(cp), np.asarray(cj), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(np_(sp), np.asarray(sj))


def test_arrange_fine_clusters_matches_jax():
    for sizes in ([5, 100, 37, 0, 12], [1, 1, 1], [400, 3]):
        sizes = np.asarray(sizes)
        np.testing.assert_array_equal(
            kb._arrange_fine_clusters(20, len(sizes), sizes),
            jax_kb._arrange_fine_clusters(20, len(sizes), sizes))


def test_adjust_centers_moves_only_starved_clusters(blobs):
    x = torch.from_numpy(blobs)
    labels = torch.zeros(4000, dtype=torch.int32)
    labels[2000:] = 1
    sizes = torch.tensor([2000.0, 2000.0, 0.0, 3.0])
    centers = torch.randn(4, 8)
    gen = torch.Generator().manual_seed(0)
    out, n_adj = kb._adjust_centers(x, labels, sizes, centers, gen, 4)
    assert int(n_adj) == 2
    np.testing.assert_array_equal(np_(out[:2]), np_(centers[:2]))
    assert not torch.equal(out[2:], centers[2:])
