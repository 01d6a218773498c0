"""The port's exact re-ranking (raft_tpu_torch.neighbors.refine) against
the JAX reference's refine and refine_host, and the two-phase brute force
that rides on it.

Candidates are drawn with numpy, with -1 (invalid) slots and repeats.
Tolerance: distances 1e-5 relative plus 1e-4 absolute (the expanded form's
sum order), ids equal outside near-ties.
"""

import numpy as np
import pytest
import torch

from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu.neighbors.refine import refine as jax_refine_fn, \
    refine_host as jax_refine_host
from raft_tpu_torch.neighbors import brute_force, refine
from tests.oracles import naive_knn
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(51)
    x = rng.standard_normal((800, 24)).astype(np.float32)
    q = rng.standard_normal((40, 24)).astype(np.float32)
    cand = rng.integers(0, 800, (40, 30)).astype(np.int32)
    cand[:, 25:] = -1                  # ragged lists
    cand[3, :] = -1                    # a query with no candidate at all
    cand[5, 1] = cand[5, 0]            # a repeated candidate
    return x, q, cand


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_refine_matches_reference(case, metric):
    x, q, cand = case
    jd, ji = jax_refine_fn(x, q, cand, 10, metric)
    pd, pi = refine.refine(x, q, cand, 10, metric, device="cpu")
    assert pd.shape == (40, 10) and pi.dtype == torch.int32
    fin = np.isfinite(np.asarray(jd))
    np.testing.assert_array_equal(np.isfinite(np_(pd)), fin)
    rows = fin.all(1)
    assert_topk_match(np_(pd)[rows], np_(pi)[rows], np.asarray(jd)[rows],
                      np.asarray(ji)[rows], 10, rtol=1e-5, atol=1e-4)
    # the row without candidates keeps only invalid ids
    assert (np_(pi)[3] < 0).all()


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.InnerProduct],
                         ids=lambda m: m.name)
def test_refine_host_matches_reference(case, metric):
    x, q, cand = case
    jd, ji = jax_refine_host(x, q, cand, 10, metric, n_threads=2)
    pd, pi = refine.refine_host(x, q, cand, 10, metric, n_threads=2)
    np.testing.assert_array_equal(pi == -1, ji == -1)
    rows = (ji >= 0).all(1)
    assert_topk_match(pd[rows], pi[rows], jd[rows], ji[rows], 10, rtol=1e-5,
                      atol=1e-4)
    with pytest.raises(ValueError, match="L2/IP"):
        refine.refine_host(x, q, cand, 10, DistanceType.CosineExpanded)


def test_refine_recovers_exact_neighbours(case):
    x, q, _ = case
    _, truth = naive_knn(q, x, 10)
    rng = np.random.default_rng(52)
    noise = rng.integers(0, 800, (40, 40)).astype(np.int32)
    noise[(noise[:, :, None] == truth[:, None, :]).any(2)] = -1
    cand = np.concatenate([noise[:, :20], truth, noise[:, 20:]], 1)
    _, pi = refine.refine(x, q, cand, 10, device="cpu")
    np.testing.assert_array_equal(np.sort(np_(pi), 1), np.sort(truth, 1))
    with pytest.raises(ValueError, match="n_candidates"):
        refine.refine(x, q, cand[:, :5], 10, device="cpu")


def test_fast_brute_force_matches_reference(case):
    """bf16 candidates at max(4k, k + 32), then an exact f32 refine."""
    x, q, _ = case
    jd, ji = jax_bf.search(jax_bf.build(x), q, 10, fast=True)
    pd, pi = brute_force.search(brute_force.build(x, device="cpu"), q, 10,
                                fast=True)
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-5, atol=1e-4)
