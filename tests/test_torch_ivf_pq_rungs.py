"""IVF-PQ's compressed cache rungs in the port (raft_tpu_torch.neighbors.
ivf_pq: i4, pq4, RaBitQ and the raw i4 / i8 residual caches) against the
JAX reference: the cache builders on the reference's codes, the cache
ladder at every rung and budget edge, searches over JAX-built indexes
carried by ``convert`` (kernel route and decode route), recall at the
equal-bytes recipe (EQUAL_BYTES_r05.json) at CPU size, the RaBitQ
first-stage + refine recipe of ``bench.py:428-450`` (which sets
chip_smoke.py's gate), and the shared index file in both directions.

Tolerances: cache words and scales bit for bit (the port takes jitted
JAX's reciprocal-multiply bits for ``/ 7``); the norm and fac sidecars
1e-6 relative (their sums run in another order); searches as in
test_torch_ivf_pq_search.py (distances 1e-4 relative, ids equal outside
near-ties); the port's own builds within 0.03 recall@10 of the
reference's (builds draw other random numbers).
"""

import dataclasses

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import raft_tpu.tuning
from chip_smoke import RABITQ_REFINED_RECALL_FLOOR
from raft_tpu.distance.types import DistanceType
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.neighbors.refine import refine as jax_refine
from raft_tpu_torch import convert
from raft_tpu_torch.neighbors import ivf_pq, refine
from tests.oracles import naive_knn
from tests.torch_parity import assert_topk_match, np_, recall, \
    torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

_FIELDS = ("centers", "centers_rot", "rotation", "pq_centers", "codes",
           "indices", "list_sizes", "rec_norms")
_CACHE_FIELDS = ("recon_cache", "cache_scales", "cache_qnorms", "cache_fac")
_SP = dict(n_probes=4)


def _manifold(seed, n, d, m):
    """SIFT-like rows near a low-dimensional manifold (the L2 recipe of
    EQUAL_BYTES_r05.json), and queries from the same distribution."""
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((6, d)).astype(np.float32) / 6 ** 0.5
    z = rng.standard_normal((n + m, 6)).astype(np.float32) * 3
    pts = z @ proj + 0.3 * rng.standard_normal((n + m, d))
    pts = pts.astype(np.float32)
    return pts[:n], pts[n:]


@pytest.fixture(scope="module")
def data():
    x, q = _manifold(17, 3000, 24, 100)
    _, truth = naive_knn(q, x, 10)
    return x, q, truth


@pytest.fixture(scope="module")
def jax_indexes(data):
    """One reference index per rung: the default build with its i4 cache
    (what ``build(cache_dtype="i4")`` ends with: ``_attach_cache`` on the
    same codes), RaBitQ and raw i4 / i8 caches; the pq4 build (pq_dim =
    dim at 4 bits: the equal-bytes twin of pq_dim = dim / 2 at 8 bits);
    and the default build's quantizers and codes searched by inner
    product, with its i4 and RaBitQ caches."""
    x, _, _ = data
    kw = dict(n_lists=8, kmeans_n_iters=8)
    base = jax_pq.build(jax_pq.IndexParams(pq_dim=12, **kw), x)
    ip = jax_pq._attach_cache(dataclasses.replace(
        base, metric=DistanceType.InnerProduct, cache_dtype="i4"))
    return {
        "i4": jax_pq._attach_cache(dataclasses.replace(base,
                                                       cache_dtype="i4")),
        "pq4": jax_pq.build(jax_pq.IndexParams(pq_dim=24, pq_bits=4,
                                               cache_dtype="pq4", **kw), x),
        "rabitq": jax_pq.attach_rabitq_cache(base),
        "raw-i4": jax_pq.attach_raw_residual_cache(base, x, dtype="i4"),
        "raw-i8": jax_pq.attach_raw_residual_cache(base, x, dtype="i8"),
        "base": base,
        "ip-i4": ip,
        "ip-rabitq": jax_pq.attach_rabitq_cache(ip),
    }


def _arrays(jix, cache=True):
    arrays = {f: np.asarray(getattr(jix, f)) for f in _FIELDS}
    if cache:
        arrays.update({f: np.asarray(getattr(jix, f)) for f in _CACHE_FIELDS
                       if getattr(jix, f) is not None})
        arrays["recon_scale"] = np.float32(jix.recon_scale)
    return arrays


def _carry(jix, cache=True):
    return convert.ivf_pq_index_from_numpy(
        _arrays(jix, cache), jix.metric, device="cpu",
        codebook_kind=jix.codebook_kind, pq_bits=jix.pq_bits,
        cache_dtype=jix.cache_dtype)


def _words(t):
    a = np_(t)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _assert_cache_equal(pix, jix):
    assert pix.cache_kind == jix.cache_kind
    np.testing.assert_array_equal(_words(pix.recon_cache),
                                  np.asarray(jix.recon_cache))
    if jix.cache_scales is None:
        assert pix.cache_scales is None
    else:
        np.testing.assert_array_equal(np_(pix.cache_scales),
                                      np.asarray(jix.cache_scales))
    for f in ("cache_qnorms", "cache_fac"):
        if getattr(jix, f) is None:
            assert getattr(pix, f) is None, f
        else:
            np.testing.assert_allclose(np_(getattr(pix, f)),
                                       np.asarray(getattr(jix, f)),
                                       rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("rung", ["i4", "pq4", "rabitq"])
def test_cache_builder_matches_reference(jax_indexes, rung):
    """The ladder's caches, built by the port from the reference's codes
    (nothing carried but the codes and quantizers)."""
    jix = jax_indexes[rung]
    pix = _carry(jix, cache=False)
    if rung == "rabitq":
        pix = ivf_pq.attach_rabitq_cache(pix)
    _assert_cache_equal(pix, jix)


@pytest.mark.parametrize("dtype", ["i4", "i8"])
def test_raw_cache_builder_matches_reference(data, jax_indexes, dtype):
    """From the dataset: the rotation is the identity (rot_dim = dim), so
    the rotated rows are exact on both sides and the cache is bit for
    bit; ``block_lists`` does not change it."""
    x, _, _ = data
    pix = ivf_pq.attach_raw_residual_cache(
        _carry(jax_indexes["base"], cache=False), torch.from_numpy(x),
        block_lists=3, dtype=dtype)
    _assert_cache_equal(pix, jax_indexes[f"raw-{dtype}"])


def test_quantizer_primitives_match_reference():
    rng = np.random.default_rng(5)
    vals = rng.standard_normal((3, 50, 40)).astype(np.float32)
    vals[0, :3] = 0.0
    ok = rng.random((3, 50, 1)) < 0.9
    base = (np.abs(vals).max(1) / 7).astype(np.float32)
    t = torch.from_numpy
    s_p = ivf_pq._pick_clip_scale(t(vals), t(base), t(ok))
    s_j = np.asarray(jax_pq._pick_clip_scale(jnp.asarray(vals),
                                             jnp.asarray(base),
                                             jnp.asarray(ok)))
    np.testing.assert_array_equal(np_(s_p), s_j)
    packed, qn = ivf_pq._quant_pack_i4(t(vals), s_p[:, None, :])
    jpk, jqn = jax_pq._quant_pack_i4(jnp.asarray(vals), jnp.asarray(s_j)[
        :, None, :])
    np.testing.assert_array_equal(_words(packed), np.asarray(jpk))
    np.testing.assert_allclose(np_(qn), np.asarray(jqn), rtol=1e-6)
    np.testing.assert_array_equal(np_(ivf_pq.unpack_i4(packed)),
                                  np.asarray(jax_pq.unpack_i4(jpk)))
    bits, fac, n2 = ivf_pq._quant_pack_rabitq(t(vals))
    jb, jf, jn = jax_pq._quant_pack_rabitq(jnp.asarray(vals))
    np.testing.assert_array_equal(_words(bits), np.asarray(jb))
    np.testing.assert_allclose(np_(fac), np.asarray(jf), rtol=1e-6)
    np.testing.assert_allclose(np_(n2), np.asarray(jn), rtol=1e-6)
    assert np_(fac)[0, 0] == 0.0
    np.testing.assert_array_equal(
        np_(ivf_pq.unpack_sign_bits(bits, 40)),
        np.asarray(jax_pq.unpack_sign_bits(jb, 40)))
    for rot in (24, 40, 96, 100):
        assert ivf_pq.bits_words(rot) == jax_pq.bits_words(rot)
        for kind in ("rabitq", "i4", "i8", "pq4"):
            assert ivf_pq.scan_bytes_per_row(kind, rot, 48) == \
                jax_pq.scan_bytes_per_row(kind, rot, 48)
    with pytest.raises(ValueError, match="unknown scan kind"):
        ivf_pq.scan_bytes_per_row("f8", 24)


# (cache_dtype, budget, C, cap, rot, pq_bits, pq_dim, per_subspace) at
# C = 4, cap = 128: i8 needs 512 * rot bytes, i4 half that, pq4
# 256 * pq_dim, RaBitQ 512 * (4 * words + 8)
_I8, _I4 = 4 * 128 * 24, 4 * 128 * 24 // 2
_LADDER = [
    ("auto", _I8, 24, 8, 24, True),          # i8 exactly fits
    ("auto", _I8 - 1, 24, 8, 24, True),      # i4 below it
    ("auto", _I4, 24, 4, 24, True),          # i4 exactly fits
    ("auto", _I4 - 1, 24, 4, 24, True),      # pq4 and RaBitQ fit: no cache
    ("auto", _I8 - 1, 20, 8, 20, True),      # rot % 8: no i4, no cache
    ("auto", 10 << 30, 24, 8, 24, True),
    ("i8", _I8, 24, 8, 24, True),
    ("i8", _I8 - 1, 24, 8, 24, True),
    ("i4", _I4, 24, 8, 24, True),
    ("i4", _I4 - 1, 24, 8, 24, True),
    ("i4", 10 << 30, 20, 8, 20, True),
    ("pq4", 4 * 128 * 24 // 2, 48, 4, 24, True),
    ("pq4", 4 * 128 * 24 // 2 - 1, 48, 4, 24, True),
    ("pq4", 10 << 30, 48, 8, 24, True),      # 8-bit codes
    ("pq4", 10 << 30, 48, 4, 20, True),      # pq_dim % 8
    ("pq4", 10 << 30, 48, 4, 24, False),     # per-cluster books
    ("rabitq", 4 * 128 * 12, 24, 8, 24, True),
    ("rabitq", 4 * 128 * 12 - 1, 24, 8, 24, True),
    ("rabitq", 4 * 128 * 16, 40, 8, 20, True),   # a partial word
]


@pytest.mark.parametrize("case", _LADDER,
                         ids=[f"{c[0]}-{c[1]}-rot{c[2]}-b{c[3]}-p{c[4]}"
                              f"{'' if c[5] else '-cluster'}"
                              for c in _LADDER])
def test_cache_kind_for_matches_reference(monkeypatch, case):
    """The ladder against the reference's with its tuning off (what the
    reference returns on a table miss): every rung at its budget edge."""
    dtype, budget, rot, bits, pq_dim, per_sub = case
    monkeypatch.setattr(raft_tpu.tuning, "_mode_override", "off")
    monkeypatch.setattr(ivf_pq, "_CACHE_BUDGET", budget)
    monkeypatch.setattr(jax_pq, "_CACHE_BUDGET", budget)
    args = (True, dtype, 4, 128, rot, bits, pq_dim, per_sub)
    assert ivf_pq._cache_kind_for(*args) == jax_pq._cache_kind_for(*args)


def test_cache_kind_for_edges():
    assert ivf_pq._cache_kind_for(False, "i4", 4, 128, 24) is None
    assert ivf_pq._cache_kind_for(True, "i4", 4, 0, 24) is None
    for dtype in ("f8", "int4"):
        with pytest.raises(ValueError, match="unknown cache_dtype"):
            ivf_pq._cache_kind_for(True, dtype, 4, 128, 24)


def _jax_search(jix, q, k, scan_impl):
    sp = jax_pq.SearchParams(scan_impl=scan_impl, local_recall_target=1.0,
                             **_SP)
    return jax_pq.search(sp, jix, q, k)


@pytest.mark.parametrize("rung", ["i4", "pq4", "rabitq", "raw-i4", "raw-i8",
                                  "ip-i4", "ip-rabitq"])
def test_search_parity_per_rung(data, jax_indexes, rung):
    """The cache scan (kernel 2's arm, its plain version here) and the
    decode scan's cache blocks over the reference's own index."""
    _, q, _ = data
    jix = jax_indexes[rung]
    pix = _carry(jix)
    assert pix.cache_kind == jix.cache_kind
    tq = torch.from_numpy(q)
    jd, ji = _jax_search(jix, q, 11, "pallas_interpret")
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(
        scan_impl="pallas_interpret", local_recall_target=1.0, **_SP), pix,
        tq, 11)
    assert_topk_match(pd, pi, jd, ji, 10)
    if not rung.startswith("ip"):
        jd, ji = _jax_search(jix, q, 11, "xla")
        pd, pi = ivf_pq.search(ivf_pq.SearchParams(scan_impl="xla", **_SP),
                               pix, tq, 11)
        assert_topk_match(pd, pi, jd, ji, 10)


def test_equal_bytes_recall_matches_reference(data, jax_indexes):
    """The equal-bytes recipe at CPU size: pq4 at pq_dim = dim against the
    default build with a raw i4 cache (both dim / 2 bytes a vector),
    each built by the port and by the reference."""
    x, q, truth = data
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    kw = dict(n_lists=8, kmeans_n_iters=8)
    port = {
        "pq4": ivf_pq.build(ivf_pq.IndexParams(
            pq_dim=24, pq_bits=4, cache_dtype="pq4", **kw), x, device="cpu"),
        "raw-i4": ivf_pq.attach_raw_residual_cache(ivf_pq.build(
            ivf_pq.IndexParams(pq_dim=12, **kw), x, device="cpu"), tx,
            dtype="i4"),
    }
    for rung, pix in port.items():
        assert pix.cache_kind == jax_indexes[rung].cache_kind
        _, pi = ivf_pq.search(ivf_pq.SearchParams(**_SP), pix, tq, 10)
        _, ji = _jax_search(jax_indexes[rung], q, 10, "xla")
        r_port, r_ref = recall(pi, truth), recall(ji, truth)
        assert abs(r_port - r_ref) <= 0.03, (rung, r_port, r_ref)


def test_rabitq_refined_recipe_sets_the_smoke_gate(data, jax_indexes):
    """bench.py:428-450 at CPU size: the default build on the RaBitQ rung,
    4k = 40 first-stage candidates refined exactly to 10. The reference's
    recall here is what chip_smoke.py's RaBitQ refined gate is held to;
    the port, over the same index, finds the same neighbours."""
    x, q, truth = data
    jix = jax_indexes["rabitq"]
    _, jc = _jax_search(jix, q, 40, "xla")
    _, ji = jax_refine(jnp.asarray(x), jnp.asarray(q), jc, 10)
    r_ref = recall(ji, truth)
    assert r_ref >= RABITQ_REFINED_RECALL_FLOOR >= 0.80, r_ref
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    _, pc = ivf_pq.search(ivf_pq.SearchParams(**_SP), _carry(jix), tq, 40)
    _, pi = refine.refine(tx, tq, pc, 10, device="cpu")
    assert recall(pi, truth) == r_ref
    # the first stage alone is well below: the rung needs the re-rank
    _, p10 = ivf_pq.search(ivf_pq.SearchParams(**_SP), _carry(jix), tq, 10)
    assert recall(p10, truth) < r_ref


def _cache_only(jix):
    return dataclasses.replace(
        jix, codes=jnp.zeros((*jix.indices.shape, 0), jnp.uint32))


@pytest.mark.parametrize("rung", ["raw-i4", "raw-i8", "rabitq",
                                  "cache-only"])
def test_save_load_across_packages(data, jax_indexes, rung, tmp_path):
    """Serialized caches (per-list-scaled raw caches, RaBitQ, a cache-only
    index) restored verbatim in both directions, and searched alike."""
    _, q, _ = data
    jix = (_cache_only(jax_indexes["raw-i4"]) if rung == "cache-only"
           else jax_indexes[rung])
    path = str(tmp_path / "jax.pq")
    jax_pq.save(path, jix)
    pix = ivf_pq.load(path, device="cpu")
    _assert_cache_equal(pix, jix)
    assert pix.codes.shape == jix.codes.shape
    jd, ji = _jax_search(jix, q, 11, "pallas_interpret")
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(
        scan_impl="pallas_interpret", local_recall_target=1.0, **_SP), pix,
        torch.from_numpy(q), 11)
    assert_topk_match(pd, pi, jd, ji, 10)
    path2 = str(tmp_path / "port.pq")
    ivf_pq.save(path2, pix)
    back = jax_pq.load(path2)
    for name in _FIELDS + _CACHE_FIELDS:
        want = getattr(jix, name)
        got = getattr(back, name)
        if want is None:
            assert got is None, name
        else:
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                          err_msg=name)
    assert back.cache_kind == jix.cache_kind
    if rung == "cache-only":
        with pytest.raises(ValueError, match="cache-only"):
            ivf_pq.search(ivf_pq.SearchParams(lut_dtype="f32", **_SP), pix,
                          torch.from_numpy(q), 10)
