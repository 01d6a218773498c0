"""The port's IVF-PQ build side (raft_tpu_torch.neighbors.ivf_pq) against
the JAX reference: code words, the encoder, the reconstructed norms and
the int8 cache on quantizers the reference trained; extend; the shared
index file in both directions; coarse margins; the port's own build by
recall; and the cache rungs a build gives (tests/test_torch_ivf_pq_rungs.py
holds each rung against the reference).

Tolerances: code words and the int8 cache bit for bit (the cache is built
from codes with the reference's scale bits); labels equal; codes equal
except at near-ties of the subspace distances (at most 0.5% of codes);
reconstructed norms 1e-5 relative (sum order); searches as in
test_torch_ivf_pq_search.py; the port's build within 0.02 recall@10 of
the reference's on the same data (builds draw other random numbers).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch import convert
from raft_tpu_torch.neighbors import ivf_pq
from tests.oracles import naive_knn
from tests.torch_parity import assert_topk_match, np_, recall, \
    torch_threads  # noqa: F401

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


def _carry(jix):
    arrays = {f: np.asarray(getattr(jix, f)) for f in _FIELDS}
    return convert.ivf_pq_index_from_numpy(
        arrays, jix.metric, device="cpu", codebook_kind=jix.codebook_kind,
        recon_scale=jix.recon_scale)


@pytest.fixture(scope="module")
def data():
    return _clustered(41, 3000, 20, 60)


@pytest.fixture(scope="module", params=["subspace-pq8", "cluster-pq6"])
def jax_index(request, data):
    x, _ = data
    kw = dict(n_lists=8, pq_dim=10, kmeans_n_iters=10)
    if request.param == "cluster-pq6":
        kw.update(pq_bits=6,
                  codebook_kind=jax_pq.codebook_gen.PER_CLUSTER)
    return jax_pq.build(jax_pq.IndexParams(**kw), x)


@pytest.mark.parametrize("pq_bits", [4, 5, 6, 7, 8])
def test_pack_unpack_bit_for_bit(pq_bits):
    rng = np.random.default_rng(pq_bits)
    codes = rng.integers(0, 1 << pq_bits, (37, 13)).astype(np.uint8)
    jw = np.asarray(jax_pq.pack_codes(jnp.asarray(codes), pq_bits))
    pw = ivf_pq.pack_codes(torch.from_numpy(codes), pq_bits)
    assert pw.shape[-1] == ivf_pq.packed_words(13, pq_bits)
    np.testing.assert_array_equal(np_(pw).view(np.uint32), jw)
    np.testing.assert_array_equal(
        np_(ivf_pq.unpack_codes(pw, 13, pq_bits)),
        np.asarray(jax_pq.unpack_codes(jnp.asarray(jw), 13, pq_bits)))


def test_encode_norms_and_cache_on_carried_quantizers(data, jax_index):
    x, _ = data
    pix = _carry(jax_index)
    jl, jc = jax_pq.encode(jax_index, x[:1500])
    pl, pc = ivf_pq.encode(pix, torch.from_numpy(x[:1500]))
    np.testing.assert_array_equal(np_(pl), np.asarray(jl))
    p, b = pix.pq_dim, pix.pq_bits
    jcodes = np.asarray(jax_pq.unpack_codes(jc, p, b))
    pcodes = np_(ivf_pq.unpack_codes(pc, p, b))
    assert (jcodes != pcodes).mean() <= 0.005
    # norms and cache from the reference's own packed lists
    rn = ivf_pq._rec_norms(pix.codes, pix.pq_centers, pix.codebook_kind, p, b)
    np.testing.assert_allclose(np_(rn), np.asarray(jax_index.rec_norms),
                               rtol=1e-5, atol=1e-5)
    cache, scale = ivf_pq._recon_cache_scan(pix.codes, pix.pq_centers,
                                            pix.codebook_kind, p, b)
    assert scale == jax_index.recon_scale
    np.testing.assert_array_equal(np_(cache),
                                  np.asarray(jax_index.recon_cache))
    # the carried index rebuilds the same cache when none is handed over
    arrays = {f: np.asarray(getattr(jax_index, f)) for f in _FIELDS[:-1]}
    rebuilt = convert.ivf_pq_index_from_numpy(
        arrays, jax_index.metric, device="cpu",
        codebook_kind=jax_index.codebook_kind)
    assert rebuilt.cache_kind == "i8"
    np.testing.assert_array_equal(np_(rebuilt.recon_cache), np_(cache))


def test_extend_matches_reference(data, jax_index):
    x, q = data
    rng = np.random.default_rng(42)
    new = (x[:200] + 0.1 * rng.standard_normal((200, 20))).astype(np.float32)
    new_ids = np.arange(5000, 5200, dtype=np.int32)
    jext = jax_pq.extend(jax_index, new, jnp.asarray(new_ids))
    pext = ivf_pq.extend(_carry(jax_index), torch.from_numpy(new),
                         torch.from_numpy(new_ids))
    np.testing.assert_array_equal(np_(pext.list_sizes),
                                  np.asarray(jext.list_sizes))
    np.testing.assert_array_equal(np_(pext.indices), np.asarray(jext.indices))
    # the new rows sit next to old ones, so a pair can encode to the same
    # codes: an exact tie, seen by taking one column past k
    sp = dict(n_probes=4, scan_impl="xla")
    jd, ji = jax_pq.search(jax_pq.SearchParams(**sp), jext, q, 11)
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(**sp), pext,
                           torch.from_numpy(q), 11)
    assert_topk_match(pd, pi, jd, ji, 10)
    assert pext.size == 3200 and pext.cache_kind == "i8"


def test_save_load_both_ways(data, jax_index, tmp_path):
    _, q = data
    path = str(tmp_path / "jax.pq")
    jax_pq.save(path, jax_index)
    pix = ivf_pq.load(path, device="cpu")
    np.testing.assert_array_equal(np_(pix.codes).view(np.uint32),
                                  np.asarray(jax_index.codes))
    np.testing.assert_array_equal(np_(pix.recon_cache),
                                  np.asarray(jax_index.recon_cache))
    sp = dict(n_probes=4)
    jd, ji = jax_pq.search(jax_pq.SearchParams(
        scan_impl="pallas_interpret", local_recall_target=1.0, **sp),
        jax_index, q, 10)
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(
        scan_impl="pallas_interpret", local_recall_target=1.0, **sp), pix,
        torch.from_numpy(q), 10)
    assert_topk_match(pd, pi, jd, ji, 10)
    path2 = str(tmp_path / "port.pq")
    ivf_pq.save(path2, pix)
    back = jax_pq.load(path2)
    for name in _FIELDS:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(jax_index, name)))
    assert (back.pq_dim, back.pq_bits, back.codebook_kind) == (
        jax_index.pq_dim, jax_index.pq_bits, jax_index.codebook_kind)


def test_coarse_margins_match(data, jax_index):
    _, q = data
    for p in (2, 3):
        np.testing.assert_allclose(
            np_(ivf_pq.coarse_margins(_carry(jax_index), q, p=p)),
            np.asarray(jax_pq.coarse_margins(jax_index, q, p=p)),
            rtol=1e-4, atol=1e-5)


def test_port_build_recall_against_oracle():
    """200 queries: across four such datasets the two builds' recall@10
    differed by 0.005-0.016 either way (other random draws)."""
    x, q = _clustered(41, 3000, 20, 200)
    _, truth = naive_knn(q, x, 10)
    jix = jax_pq.build(jax_pq.IndexParams(n_lists=8, kmeans_n_iters=10), x)
    _, ji = jax_pq.search(jax_pq.SearchParams(n_probes=4), jix, q, 10)
    pix = ivf_pq.build(ivf_pq.IndexParams(n_lists=8, kmeans_n_iters=10), x,
                       device="cpu")
    assert pix.cache_kind == "i8" and pix.pq_dim == jix.pq_dim
    _, pi = ivf_pq.search(ivf_pq.SearchParams(n_probes=4), pix,
                          torch.from_numpy(q), 10)
    r_port, r_ref = recall(pi, truth), recall(ji, truth)
    assert r_port >= r_ref - 0.02, (r_port, r_ref)


def test_streamed_build_equals_whole_build(data):
    x, _ = data
    params = ivf_pq.IndexParams(n_lists=8, pq_dim=10, kmeans_n_iters=5,
                                codebook_kind=ivf_pq.codebook_gen.PER_CLUSTER)
    whole = ivf_pq.build(params, x, device="cpu")
    streamed = ivf_pq.build(params, x, batch_size=700, device="cpu")
    for f in ("codes", "indices", "list_sizes", "rec_norms", "recon_cache"):
        assert torch.equal(getattr(whole, f), getattr(streamed, f)), f
    rot = ivf_pq.make_rotation_matrix(
        30, 20, True, torch.Generator().manual_seed(1))
    np.testing.assert_allclose(np_(rot.T @ rot), np.eye(20), atol=1e-5)
    assert ivf_pq._auto_pq_dim(96) == jax_pq._auto_pq_dim(96) == 24


def test_cache_rungs_not_ported_raise(data, monkeypatch):
    """The build gives each cache rung it is asked for (none raises any
    more); with no rung that fits, no cache (as in the reference); an
    explicit i8 that does not fit gives no cache; "auto" below the i8
    budget takes i4; cosine is refused."""
    x, _ = data
    want = {"i4": ("i4", 8), "pq4": ("pq4", 4), "rabitq": ("rabitq", 8)}
    for dtype, (kind, bits) in want.items():
        ix = ivf_pq.build(ivf_pq.IndexParams(
            n_lists=4, kmeans_n_iters=2, pq_dim=8, pq_bits=bits,
            cache_dtype=dtype), x[:500], device="cpu")
        assert ix.cache_kind == kind
        assert ix.recon_cache.dtype == torch.int32
    monkeypatch.setattr(ivf_pq, "_CACHE_BUDGET", 4 * 128 * 16)
    assert ivf_pq._cache_kind_for(True, "auto", 4, 128, 24) == "i4"
    assert ivf_pq._cache_kind_for(True, "auto", 4, 1024, 24) is None
    monkeypatch.setattr(ivf_pq, "_CACHE_BUDGET", 1000)
    ix = ivf_pq.build(ivf_pq.IndexParams(n_lists=4, kmeans_n_iters=2,
                                         cache_dtype="i8"), x[:500],
                      device="cpu")
    assert ix.cache_kind == "none"
    with pytest.raises(ValueError, match="ivf_pq supports"):
        ivf_pq.IndexParams(metric=DistanceType.CosineExpanded)
