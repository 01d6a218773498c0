"""CAGRA's default graph build (raft_tpu_torch.neighbors.cagra, IVF-PQ
self-search + exact refine) against the JAX reference's build_knn_graph.

The two packages train their IVF-PQ indexes from other random numbers, so
the raw graphs are held by quality: each graph's overlap with the exact
KNN graph (self excluded) on the same data, the port's within 0.03 of the
reference's. The whole default build then feeds a search whose recall is
held against the numpy oracle.
"""

import numpy as np
import pytest

from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import cagra as jax_cagra
from raft_tpu_torch.neighbors import cagra
from tests.oracles import eval_recall, naive_knn
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(61)
    c = rng.uniform(-5, 5, (16, 16)).astype(np.float32)
    x = (c[rng.integers(0, 16, 2000)]
         + 0.8 * rng.standard_normal((2000, 16))).astype(np.float32)
    q = (c[rng.integers(0, 16, 100)]
         + 0.8 * rng.standard_normal((100, 16))).astype(np.float32)
    _, exact = naive_knn(x, x, 17)
    return x, q, exact[:, 1:]


def _overlap(graph, exact):
    return eval_recall(np.asarray(graph)[:, :exact.shape[1]], exact)


def test_build_knn_graph_quality_matches_reference(data):
    x, _, exact = data
    jg = np.asarray(jax_cagra.build_knn_graph(x, 16,
                                              DistanceType.L2Expanded))
    pg = np_(cagra.build_knn_graph(x, 16, DistanceType.L2Expanded,
                                   device="cpu"))
    assert pg.shape == jg.shape == (2000, 16)
    assert not (pg == np.arange(2000)[:, None]).any()
    r_port, r_ref = _overlap(pg, exact), _overlap(jg, exact)
    assert r_port >= r_ref - 0.03, (r_port, r_ref)
    assert r_port >= 0.9


def test_build_knn_graph_trims_to_63(data):
    x, _, _ = data
    with pytest.warns(UserWarning, match="trimmed"):
        g = cagra.build_knn_graph(x[:1000], 96, DistanceType.L2Expanded,
                                  min_degree=32, device="cpu")
    assert g.shape == (1000, 63)


def test_default_build_searches(data):
    x, q, _ = data
    idx = cagra.build(cagra.IndexParams(intermediate_graph_degree=32,
                                        graph_degree=16), x, device="cpu")
    _, i = cagra.search(cagra.SearchParams(itopk_size=32, max_iterations=8),
                        idx, q, 10)
    _, want = naive_knn(q, x, 10)
    assert eval_recall(np_(i), want) >= 0.95
