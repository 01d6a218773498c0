"""The port's CAGRA (raft_tpu_torch.neighbors.cagra) against the JAX
reference.

* Bit for bit on shared inputs: ``optimize`` (detour counts, pruning,
  reverse-edge splice) and ``_pack_tables`` (codes, code words, ids, norm
  bitcasts — both sides given the norms the reference packs).
* Whole searches on an index that raft_tpu built and saved, loaded by the
  port: recall within 0.01 of the reference's (its beam kernel in
  interpret mode; the port's packed path named as "pallas_interpret",
  since "auto" on a CPU index takes the scattered path, as the
  reference's does off its accelerator), L2 and inner product, the
  scattered path, a prefilter.
  One flipped near-tie changes the beam's path, so whole searches are
  compared by recall, never for equality.
* The slice end to end in the port (nn-descent build -> optimize -> pack
  -> search) on the same data: recall no lower than the reference's minus
  0.02. Builds draw other random numbers than jax.random, so they are held
  by quality.
"""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from raft_tpu.neighbors import cagra as jax_cagra
from raft_tpu_torch.convert import cagra_index_from_numpy
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import cagra
from tests.oracles import eval_recall, naive_knn
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

K = 10
SEARCH = dict(itopk_size=32, max_iterations=8, n_seeds=64)


def _clustered(rng, n, nq, d=32, n_centers=16):
    centers = rng.uniform(-5, 5, (n_centers, d)).astype(np.float32)
    x = (centers[rng.integers(0, n_centers, n)]
         + 0.7 * rng.standard_normal((n, d))).astype(np.float32)
    q = (centers[rng.integers(0, n_centers, nq)]
         + 0.7 * rng.standard_normal((nq, d))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """A CAGRA index built (nn-descent) and saved by raft_tpu, its
    searches, and the data."""
    rng = np.random.default_rng(11)
    x, q = _clustered(rng, 2000, 128)
    params = dict(intermediate_graph_degree=32, graph_degree=16)
    idx = jax_cagra.build(jax_cagra.IndexParams(
        graph_build_algo=jax_cagra.build_algo.NN_DESCENT, **params), x)
    path = str(tmp_path_factory.mktemp("cagra") / "ref.cagra")
    jax_cagra.save(path, idx)
    return {"x": x, "q": q, "idx": idx, "path": path, "params": params}


@pytest.fixture(scope="module")
def reference_ids(reference):
    """The reference's search of its own index (beam kernel in interpret
    mode)."""
    _, ji = jax_cagra.search(jax_cagra.SearchParams(
        scan_impl="pallas_interpret", **SEARCH), reference["idx"],
        reference["q"], K)
    return np.asarray(ji)


def test_optimize_bitwise():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((800, 16)).astype(np.float32)
    _, g = naive_knn(x, x, 33)
    g = g[:, 1:].astype(np.int32)
    g[::37, 5] = -1                                # unfilled slots
    want = np.asarray(jax_cagra.optimize(g, 16))
    got = cagra.optimize(torch.from_numpy(g), 16, chunk=300)
    np.testing.assert_array_equal(np_(got), want)
    np.testing.assert_array_equal(
        np_(cagra._detour_counts(torch.from_numpy(g), 128)),
        np.asarray(jax_cagra._detour_counts(jnp.asarray(g), 128)))


@pytest.mark.parametrize("ip", [False, True])
def test_pack_tables_bitwise(ip):
    rng = np.random.default_rng(6 + ip)
    x = rng.standard_normal((300, 36)).astype(np.float32)
    g = rng.integers(-1, 300, (300, 8)).astype(np.int32)
    jp, jcodes, jscale = jax_cagra._pack_tables(jnp.asarray(x),
                                               jnp.asarray(g), not ip, 128)
    # the norms the reference packs (its own jitted reduction)
    norms = None if ip else torch.from_numpy(np.array(jax.jit(
        lambda a: jnp.sum(a * a, axis=1))(jnp.asarray(x))))
    tp, tcodes, tscale = cagra._pack_tables(
        torch.from_numpy(x), torch.from_numpy(g), not ip, 128, norms=norms)
    np.testing.assert_array_equal(np_(tp), np.asarray(jp))
    np.testing.assert_array_equal(np_(tcodes), np.asarray(jcodes))
    assert float(tscale) == float(jscale)
    assert cagra._inline_eligible(300, 36, 8, not ip)
    assert not cagra._inline_eligible(300, 34, 8, not ip)


def test_save_load_round_trip_across_packages(reference, tmp_path):
    x = reference["x"]
    idx = cagra.load(reference["path"], device="cpu")
    path = str(tmp_path / "port.cagra")
    cagra.save(path, idx)
    back = jax_cagra.load(path)
    np.testing.assert_array_equal(np.asarray(back.graph), np_(idx.graph))
    np.testing.assert_array_equal(np.asarray(back.dataset), x)
    assert back.metric == jax_cagra.DistanceType.L2Expanded
    assert back.nbr_pack is not None


def test_search_on_reference_index(reference, reference_ids):
    """The raft_tpu-built index, loaded from its file by the port."""
    x, q = reference["x"], reference["q"]
    _, want = naive_knn(q, x, K)
    idx = cagra.load(reference["path"], device="cpu")
    np.testing.assert_array_equal(np_(idx.graph),
                                  np.asarray(reference["idx"].graph))
    assert idx.nbr_pack is not None
    d, i = cagra.search(cagra.SearchParams(scan_impl="pallas_interpret",
                                           **SEARCH), idx, q, K)
    r_port = eval_recall(np_(i), want)
    r_ref = eval_recall(reference_ids, want)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    # exact rescored distances, best first, unique ids
    i, d = np_(i), np_(d)
    np.testing.assert_allclose(d, ((x[i] - q[:, None]) ** 2).sum(-1),
                               rtol=1e-4, atol=1e-3)
    assert all(len(set(r)) == K for r in i)
    assert np.all(np.diff(d, axis=1) >= 0)


def test_inner_product_search(reference):
    """The reference's graph under the inner-product metric, carried
    across as arrays (the inline layout is rebuilt by the port)."""
    x, q = reference["x"], reference["q"]
    graph = np.asarray(reference["idx"].graph)
    ref = jax_cagra.from_graph(x, graph, "inner_product")
    _, ji = jax_cagra.search(jax_cagra.SearchParams(
        scan_impl="pallas_interpret", **SEARCH), ref, q, K)
    idx = cagra_index_from_numpy({"dataset": x, "graph": graph},
                                 "inner_product", device="cpu")
    d, i = cagra.search(cagra.SearchParams(scan_impl="pallas_interpret",
                                           **SEARCH), idx, q, K)
    _, want = naive_knn(q, x, K, metric="inner_product")
    r_port, r_ref = eval_recall(np_(i), want), eval_recall(np.asarray(ji),
                                                           want)
    assert abs(r_port - r_ref) <= 0.01, (r_port, r_ref)
    assert np.all(np.diff(np_(d), axis=1) <= 1e-4)    # scores, best first


def test_scattered_path_matches_reference(reference):
    x, q = reference["x"], reference["q"]
    idx = cagra.load(reference["path"], device="cpu")
    sp = dict(SEARCH, compute_dtype="f32")
    _, ji = jax_cagra.search(jax_cagra.SearchParams(**sp), reference["idx"],
                             q, K)
    _, i = cagra.search(cagra.SearchParams(**sp), idx, q, K)
    _, want = naive_knn(q, x, K)
    assert abs(eval_recall(np_(i), want)
               - eval_recall(np.asarray(ji), want)) <= 0.01
    assert np.mean(np_(i) == np.asarray(ji)) >= 0.95


@pytest.mark.parametrize("impl", ["packed", "scattered"])
def test_prefilter_returns_only_allowed_ids(reference, impl):
    x, q = reference["x"], reference["q"]
    idx = cagra.load(reference["path"], device="cpu")
    keep = np.random.default_rng(3).random(len(x)) < 0.5
    _, i = cagra.search(cagra.SearchParams(scan_impl=impl, **SEARCH), idx,
                        q, K, prefilter=Bitset.from_dense(keep))
    i = np_(i)
    assert np.all(keep[i[i >= 0]])
    allowed = np.flatnonzero(keep)
    _, want = naive_knn(q, x[allowed], K)
    assert eval_recall(i, allowed[want]) >= 0.9


def test_port_build_end_to_end(reference, reference_ids):
    """nn-descent build -> optimize -> pack -> search, all in the port."""
    x, q = reference["x"], reference["q"]
    idx = cagra.build(cagra.IndexParams(
        graph_build_algo=cagra.build_algo.NN_DESCENT,
        **reference["params"]), x, device="cpu")
    g = np_(idx.graph)
    assert g.shape == (2000, 16) and g.min() >= 0
    assert not (g == np.arange(2000)[:, None]).any()
    _, i = cagra.search(cagra.SearchParams(scan_impl="pallas_interpret",
                                           **SEARCH), idx, q, K)
    _, want = naive_knn(q, x, K)
    r_port = eval_recall(np_(i), want)
    r_ref = eval_recall(reference_ids, want)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


def test_ivf_pq_build_raises():
    """The default IVF-PQ graph build is ported (it raised before IVF-PQ
    was); an unknown build algorithm raises."""
    with pytest.raises(ValueError, match="graph_build_algo"):
        cagra.build(cagra.IndexParams(graph_build_algo=7),
                    np.zeros((10, 8), np.float32), device="cpu")
    x = np.random.default_rng(3).standard_normal((300, 8)).astype(
        np.float32)
    idx = cagra.build(cagra.IndexParams(intermediate_graph_degree=16,
                                        graph_degree=8), x, device="cpu")
    g = np_(idx.graph)
    assert g.shape == (300, 8) and g.min() >= 0
    assert not (g == np.arange(300)[:, None]).any()
