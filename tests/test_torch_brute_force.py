"""The port's brute-force KNN (raft_tpu_torch.neighbors.brute_force)
against the JAX reference: the expanded metrics through the fused kernel's
plain version on the CPU, the others through plain distance blocks.
Tolerance: distances 1e-4 relative, ids equal outside near-ties."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu_torch import convert
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import brute_force, common
from raft_tpu_torch.neighbors.common import BitsetFilter
from raft_tpu_torch.ops import fused_topk
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.random((2000, 16)).astype(np.float32)
    q = rng.random((40, 16)).astype(np.float32)
    return x, q


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean",
                                    "inner_product", "cosine", "l1",
                                    "chebyshev"])
def test_knn_matches_jax(data, metric):
    x, q = data
    jd, ji = jax_bf.knn(q, x, 11, metric=metric)
    pd, pi = brute_force.knn(q, x, 11, metric=metric, device="cpu")
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1"])
def test_knn_past_the_kernel_k_matches_jax(data, metric, monkeypatch):
    """k beyond the fused kernel's capacity (and a metric it does not
    take) runs plain distance blocks, here several of them."""
    monkeypatch.setattr(common, "BLOCK_ROWS", 300)
    x, q = data
    k = fused_topk.K_MAX + 44
    jd, ji = jax_bf.knn(q, x, k + 1, metric=metric)
    pd, pi = brute_force.knn(q, x, k + 1, metric=metric, device="cpu")
    assert_topk_match(pd, pi, jd, ji, k, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("out_of_range", ["drop", "keep"])
def test_prefilter_matches_jax(data, out_of_range):
    """A filter narrower than the dataset: rows past it are dropped or
    kept per ``out_of_range``, like the reference's scan path."""
    x, q = data
    mask = np.random.default_rng(12).random(1500) < 0.3
    from raft_tpu.neighbors.common import BitsetFilter as JaxFilter
    jd, ji = jax_bf.search(
        jax_bf.build(x), q, 11,
        prefilter=JaxFilter(JaxBitset.from_dense(jnp.asarray(mask)),
                            out_of_range))
    pd, pi = brute_force.search(
        brute_force.build(x, device="cpu"), q, 11,
        prefilter=BitsetFilter(Bitset.from_dense(torch.from_numpy(mask)),
                               out_of_range))
    ok = np.concatenate([mask, np.full(500, out_of_range == "keep")])
    assert ok[np_(pi)].all()
    assert_topk_match(pd, pi, jd, ji, 10)


def test_loads_jax_file_and_converted_arrays(data, tmp_path):
    x, q = data
    jix = jax_bf.build(x, "cosine")
    path = str(tmp_path / "bf.bin")
    jax_bf.save(path, jix)
    jd, ji = jax_bf.search(jix, q, 11)
    loaded = brute_force.load(path, device="cpu")
    conv = convert.brute_force_index_from_numpy(
        {"dataset": np.asarray(jix.dataset), "norms": np.asarray(jix.norms)},
        "cosine", device="cpu")
    for ix in (loaded, conv):
        pd, pi = brute_force.search(ix, q, 11)
        assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-4, atol=1e-5)
    brute_force.save(str(tmp_path / "port.bin"), loaded)
    back = jax_bf.load(str(tmp_path / "port.bin"))
    np.testing.assert_array_equal(np.asarray(back.dataset), x)
    assert back.metric == jix.metric


def test_k_range_checked(data):
    x, q = data
    ix = brute_force.build(x[:10], device="cpu")
    with pytest.raises(ValueError):
        brute_force.search(ix, q, 11)
