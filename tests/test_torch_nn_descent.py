"""The port's nn-descent (raft_tpu_torch.neighbors.nn_descent) against the
JAX reference.

Pieces are compared on shared inputs: the reverse graph bit for bit, the
XLA-path merge bit for bit, the init block and local-join blocks (the
reference with its Pallas kernel in interpret mode) exactly on ids and to
1e-5 relative on distances (f32 dots summed in other orders). Whole builds
draw other random numbers (torch.Generator vs jax.random), so they are
held by graph recall against the exact KNN graph, and against the
reference's build through CAGRA in test_torch_cagra.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.neighbors import nn_descent as jax_nnd
from raft_tpu_torch.convert import nn_descent_index_from_numpy
from raft_tpu_torch.neighbors import nn_descent
from tests.oracles import naive_knn
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def shared():
    """Data, reference norms, and a reference graph after its init."""
    rng = np.random.default_rng(21)
    n, d, K = 600, 16, 24
    x = rng.standard_normal((n, d)).astype(np.float32)
    norms = np.array(jnp.sum(jnp.asarray(x) ** 2, axis=1))
    init = rng.integers(0, n, (n, K)).astype(np.int32)
    gd, gi = jax_nnd._init_block(jnp.asarray(x), jnp.asarray(norms),
                                 jnp.asarray(init), 0, rows=n, ip=False)
    return x, norms, init, np.array(gd), np.array(gi)


def test_init_block_matches_reference(shared):
    x, norms, init, gd, gi = shared
    t = torch.from_numpy
    pd, pi = nn_descent._init_block(t(x), t(norms), t(init), 0, len(x),
                                    False)
    np.testing.assert_array_equal(np_(pi), gi)
    np.testing.assert_allclose(np_(pd), gd, rtol=1e-5, atol=1e-5)


def test_make_rev_bitwise(shared):
    _, _, _, _, gi = shared
    gi = gi.copy()
    gi[::7, -1] = -1                             # unfilled slots
    want = np.asarray(jax_nnd._make_rev(jnp.asarray(gi)))
    np.testing.assert_array_equal(
        np_(nn_descent._make_rev(torch.from_numpy(gi))), want)


@pytest.mark.parametrize("ip", [False, True])
def test_score_matches_reference(shared, ip):
    x, norms, init, _, _ = shared
    ids = np.arange(100, 300, dtype=np.int32)
    want = jax_nnd._score(jnp.asarray(ids), jnp.asarray(init[ids]),
                          jnp.asarray(x), jnp.asarray(norms), ip)
    t = torch.from_numpy
    got = nn_descent._score(t(ids), t(init[ids]), t(x), t(norms), ip)
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_merge_topk_unique_bitwise():
    rng = np.random.default_rng(4)
    B, K, C = 20, 12, 30
    cur_i = rng.integers(-1, 60, (B, K)).astype(np.int32)
    new_i = rng.integers(-1, 60, (B, C)).astype(np.int32)
    # one distance per id: duplicates carry bitwise-equal distances
    dist_of = rng.standard_normal(61).astype(np.float32)
    cur_d = np.where(cur_i < 0, np.inf, dist_of[cur_i]).astype(np.float32)
    new_d = np.where(new_i < 0, np.inf, dist_of[new_i]).astype(np.float32)
    jd, ji = jax_nnd._merge_topk_unique(*map(jnp.asarray, (cur_d, cur_i,
                                                           new_d, new_i)), K)
    t = torch.from_numpy
    pd, pi = nn_descent._merge_topk_unique(t(cur_d), t(cur_i), t(new_d),
                                           t(new_i), K)
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))
    np.testing.assert_array_equal(np_(pd), np.asarray(jd))


@pytest.mark.parametrize("ip", [False, True])
def test_join_block_matches_pallas_interpret(shared, ip):
    x, norms, _, gd, gi = shared
    n, K = gi.shape
    rng = np.random.default_rng(5 + ip)
    rev = np.array(jax_nnd._make_rev(jnp.asarray(gi)))
    pool = np.concatenate([gi, rev], 1)
    cols = rng.integers(0, 2 * K * K, 40).astype(np.int32)
    start, rows = 200, 150
    jd, ji, ju = jax_nnd._join_block(
        jnp.asarray(x), jnp.asarray(norms), jnp.asarray(gd), jnp.asarray(gi),
        jnp.asarray(pool), jnp.asarray(rev), jnp.asarray(cols),
        jnp.int32(start), rows=rows, ip=ip, impl="pallas_interpret",
        tile_b=8)
    t = torch.from_numpy
    pd, pi, pu = nn_descent._join_block(t(x), t(norms), t(gd), t(gi),
                                        t(pool), t(rev), t(cols), start,
                                        rows, ip)
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))
    np.testing.assert_allclose(np_(pd), np.asarray(jd), rtol=1e-5, atol=1e-5)
    assert int(pu) == int(ju)


def _graph_recall(graph, x, k):
    _, want = naive_knn(x, x, k + 1)
    want = want[:, 1:]                           # drop self
    g = np.asarray(graph)[:, :k]
    return np.mean([len(set(g[i]) & set(want[i])) / k
                    for i in range(len(x))])


def test_build_quality():
    """Graph recall against the exact KNN graph (the whole slice is held
    against the reference's build in test_torch_cagra); no self edges,
    unique ids, sorted distances; blocks of any size give the same
    graph."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((1000, 16)).astype(np.float32)
    params = dict(graph_degree=16, max_iterations=12)
    idx = nn_descent.build(nn_descent.IndexParams(**params), x,
                           device="cpu")
    assert _graph_recall(np_(idx.graph), x, 16) >= 0.9
    g, dist = np_(idx.graph), np_(idx.distances)
    assert g.shape == (1000, 16)
    assert not (g == np.arange(1000)[:, None]).any()
    assert all(len(set(r)) == len(r) for r in g)
    assert np.all(np.diff(dist, axis=1) >= 0)
    blocked = nn_descent.build(
        nn_descent.IndexParams(block_rows=333, **params), x, device="cpu")
    assert torch.equal(blocked.graph, idx.graph)


def test_inner_product_and_carry_across():
    rng = np.random.default_rng(9)
    x = rng.standard_normal((400, 8)).astype(np.float32)
    idx = nn_descent.build(nn_descent.IndexParams(
        graph_degree=8, metric="inner_product", max_iterations=8), x,
        device="cpu")
    g, dist = np_(idx.graph), np_(idx.distances)
    # distances are the (positive) inner products, best first
    np.testing.assert_allclose(
        dist, np.einsum("nd,nkd->nk", x, x[g]), rtol=1e-5, atol=1e-5)
    assert np.all(np.diff(dist, axis=1) <= 0)
    back = nn_descent_index_from_numpy(
        {"graph": g, "distances": dist}, device="cpu")
    assert torch.equal(back.graph, idx.graph)
    assert back.graph.dtype == torch.int32
