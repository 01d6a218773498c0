"""The port's IVF-Flat (raft_tpu_torch.neighbors.ivf_flat) against the JAX
reference.

Search parity runs on one shared index: built by JAX, carried over with
raft_tpu_torch.convert and, separately, saved by JAX and loaded by the
port. JAX searches with compute_dtype="f32" and local_recall_target=1.0
(exact per-list selection); tolerance: distances 1e-4 relative, ids equal
outside near-ties. Builds cannot match bit for bit (jax.random and
torch.Generator draw different numbers), so the port's own build is held
to quality: recall@10 against the numpy oracle within 0.03 of the JAX
build's, and lists as balanced.
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_flat
from tests.oracles import naive_knn
from tests.torch_parity import assert_topk_match, np_, recall, \
    torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

N, D, M, N_LISTS, N_PROBES = 3000, 16, 64, 16, 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.uniform(-4, 4, (24, D)).astype(np.float32)
    x = (centers[rng.integers(0, 24, N)]
         + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, 24, M)]
         + rng.standard_normal((M, D))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def jax_index(data):
    x, _ = data
    return jax_ivf.build(jax_ivf.IndexParams(n_lists=N_LISTS,
                                             kmeans_n_iters=10), x)


def _jax_arrays(ix):
    arrays = {"centers": ix.centers, "storage": ix.storage,
              "indices": ix.indices, "list_sizes": ix.list_sizes}
    if ix.data_norms is not None:
        arrays["data_norms"] = ix.data_norms
    return {k: np.asarray(v) for k, v in arrays.items()}


_JAX_SP = jax_ivf.SearchParams(n_probes=N_PROBES, compute_dtype="f32",
                               local_recall_target=1.0)
_SP = ivf_flat.SearchParams(n_probes=N_PROBES, compute_dtype="f32")


@pytest.mark.parametrize("metric", [DistanceType.L2Expanded,
                                    DistanceType.L2SqrtExpanded,
                                    DistanceType.InnerProduct,
                                    DistanceType.CosineExpanded],
                         ids=lambda m: m.name)
def test_search_matches_jax_on_converted_index(data, jax_index, metric):
    """One JAX-built list layout searched under each metric (the layout
    does not depend on the metric; IP drops the norms)."""
    _, q = data
    jix = dataclasses.replace(
        jax_index, metric=metric,
        data_norms=None if metric == DistanceType.InnerProduct
        else jax_index.data_norms)
    jd, ji = jax_ivf.search(_JAX_SP, jix, q, 11)
    pix = convert.ivf_flat_index_from_numpy(_jax_arrays(jix), metric,
                                            device="cpu")
    pd, pi = ivf_flat.search(_SP, pix, q, 11)
    assert pd.dtype == torch.float32 and pi.dtype == torch.int32
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-4, atol=1e-4)


def test_search_matches_jax_on_loaded_file(data, jax_index, tmp_path):
    _, q = data
    path = str(tmp_path / "ivf.bin")
    jax_ivf.save(path, jax_index)
    pix = ivf_flat.load(path, device="cpu")
    np.testing.assert_array_equal(np_(pix.indices),
                                  np.asarray(jax_index.indices))
    jd, ji = jax_ivf.search(_JAX_SP, jax_index, q, 11)
    pd, pi = ivf_flat.search(_SP, pix, q, 11)
    assert_topk_match(pd, pi, jd, ji, 10)
    # and the port's file loads back into JAX unchanged
    path2 = str(tmp_path / "ivf_port.bin")
    ivf_flat.save(path2, pix)
    back = jax_ivf.load(path2)
    for name in ("centers", "storage", "indices", "list_sizes",
                 "data_norms"):
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jax_index, name)))


def test_search_prefilter_matches_jax(data, jax_index):
    _, q = data
    mask = np.random.default_rng(8).random(N) < 0.5
    jd, ji = jax_ivf.search(_JAX_SP, jax_index, q, 11,
                            prefilter=JaxBitset.from_dense(jnp.asarray(mask)))
    pix = convert.ivf_flat_index_from_numpy(
        _jax_arrays(jax_index), DistanceType.L2Expanded, device="cpu")
    pd, pi = ivf_flat.search(_SP, pix, q, 11,
                             prefilter=Bitset.from_dense(torch.from_numpy(mask)))
    assert mask[np_(pi)[np_(pi) >= 0]].all()
    assert_topk_match(pd, pi, jd, ji, 10)


def test_bucketize_and_unbucketize_match_jax():
    rng = np.random.default_rng(9)
    m, n_probes, C, group, bb = 50, 3, 8, 16, 4
    probes = np.stack([rng.choice(C, n_probes, replace=False)
                       for _ in range(m)]).astype(np.int32)
    jout = jax.jit(jax_ivf.bucketize_pairs, static_argnums=(1, 2, 3, 4, 5))(
        jnp.asarray(probes), m, n_probes, C, group, bb)
    pout = ivf_flat.bucketize_pairs(torch.from_numpy(probes), m, n_probes,
                                    C, group, bb)
    for j, p in zip(jout[:5], pout[:5]):
        np.testing.assert_array_equal(np_(p), np.asarray(j))
    assert tuple(int(v) for v in jout[5:]) == tuple(pout[5:])
    nb, kl, k = pout[6], 3, 4
    cand_d = rng.standard_normal((nb, group, kl)).astype(np.float32)
    cand_i = rng.integers(0, 10_000, (nb, group, kl)).astype(np.int32)
    jd, ji = jax.jit(jax_ivf.unbucketize_merge,
                     static_argnums=(5, 6, 7, 8, 9, 10))(
        jnp.asarray(cand_d), jnp.asarray(cand_i), *jout[2:5], m * n_probes,
        m, n_probes, kl, k, True, float("inf"))
    pd, pi = ivf_flat.unbucketize_merge(
        torch.from_numpy(cand_d), torch.from_numpy(cand_i), *pout[2:5],
        pout[5], m, n_probes, kl, k, True)
    np.testing.assert_array_equal(np_(pd), np.asarray(jd))
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))


def test_adaptive_query_group_matches_jax():
    for args in [(10_000, 64, 1024, 256), (100, 4, 16, 256), (5000, 8, 64, 64)]:
        assert ivf_flat.adaptive_query_group(*args) == \
            jax_ivf.adaptive_query_group(*args)


def test_own_build_quality_matches_jax(data, jax_index):
    x, q = data
    _, truth = naive_knn(q, x, 10)
    jd, ji = jax_ivf.search(_JAX_SP, jax_index, q, 10)
    pix = ivf_flat.build(ivf_flat.IndexParams(n_lists=N_LISTS,
                                              kmeans_n_iters=10), x,
                         device="cpu")
    pd, pi = ivf_flat.search(_SP, pix, q, 10)
    r_jax, r_port = recall(ji, truth), recall(pi, truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)
    js = np.asarray(jax_index.list_sizes)
    ps = np_(pix.list_sizes)
    assert ps.sum() == N and sorted(np_(pix.indices)[np_(pix.indices) >= 0]
                                    .tolist()) == list(range(N))
    assert ps.max() / ps.mean() <= 1.25 * js.max() / js.mean(), (ps, js)
    # the port's bf16 default scan on its own build stays close
    bd, bi = ivf_flat.search(ivf_flat.SearchParams(n_probes=N_PROBES), pix,
                             q, 10)
    assert recall(bi, truth) >= r_port - 0.02


def test_extend_and_bf16_storage(data):
    x, q = data
    params = ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=5,
                                  storage_dtype="bf16")
    ix = ivf_flat.build(params, x[:2000], device="cpu")
    assert ix.storage.dtype == torch.bfloat16
    ix = ivf_flat.extend(ix, x[2000:])
    assert ix.size == N
    ids = np_(ix.indices)
    assert sorted(ids[ids >= 0].tolist()) == list(range(N))
    d, i = ivf_flat.search(ivf_flat.SearchParams(n_probes=8), ix, q, 5)
    _, truth = naive_knn(q, x, 5)
    assert recall(i, truth) > 0.95


def test_build_without_card_needs_explicit_device(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ivf_flat.build(ivf_flat.IndexParams(n_lists=4), data[0][:100])
