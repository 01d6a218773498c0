"""The port's base layers against the JAX reference: select_k and its
NaN / integer / tie contracts (those tests/test_select_k.py pins), the
bitset and filters, merge_topk, pairwise distances, fused L2 1-NN, the
index-file container, and the device rule. Exact equality unless a
tolerance is stated."""

import io

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.core import serialize as jax_serialize
from raft_tpu.core.bitset import Bitset as JaxBitset
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_argmin as jax_l2nn
from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise
from raft_tpu.matrix.select_k import select_k as jax_select_k
from raft_tpu.neighbors import common as jax_common
from raft_tpu_torch.core import resources, serialize
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn_argmin
from raft_tpu_torch.distance.pairwise import pairwise_distance
from raft_tpu_torch.distance.types import DistanceType, METRIC_NAMES
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import common
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("batch,n,k", [(1, 100, 5), (16, 1000, 32),
                                       (4, 257, 256)])
def test_select_k_matches_jax(select_min, batch, n, k):
    x = np.random.default_rng(n).standard_normal((batch, n)).astype(
        np.float32)
    jv, ji = jax_select_k(x, k, select_min=select_min)
    pv, pi = select_k(x, k, select_min=select_min, device="cpu")
    np.testing.assert_array_equal(np_(pv), np.asarray(jv))
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_integers_exact_above_2p24(select_min):
    base = 1 << 24
    x = np.array([[base + 3, base + 1, base + 2, base, -base - 1, -base - 2,
                   -(2**31), 2**31 - 1, 0]], np.int32)
    v, i = select_k(x, 4, select_min=select_min, device="cpu")
    srt = np.sort(x, axis=1)
    want = srt[:, :4] if select_min else srt[:, ::-1][:, :4]
    np.testing.assert_array_equal(np_(v), want)
    np.testing.assert_array_equal(np.take_along_axis(x, np_(i), axis=1),
                                  np_(v))
    assert v.dtype == torch.int32


def test_select_k_unsigned_and_bool():
    x = np.array([[2**32 - 1, (1 << 24) + 1, (1 << 24) + 2, 7, 0]],
                 np.uint32)
    v, _ = select_k(x, 3, select_min=True, device="cpu")
    assert v.dtype == torch.uint32
    np.testing.assert_array_equal(np_(v.to(torch.int64)),
                                  [[0, 7, (1 << 24) + 1]])
    b = np.array([[True, False, True, False]])
    v, i = select_k(b, 2, select_min=False, device="cpu")
    np.testing.assert_array_equal(np_(i), [[0, 2]])


def test_select_k_nan_quarantined_and_ties_stable():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64)).astype(np.float32)
    x[:, 5] = np.nan
    x[:, 9] = np.inf
    v, i = select_k(x, 64, select_min=True, device="cpu")
    v, i = np_(v), np_(i)
    assert np.isnan(v[:, -2:]).any(axis=1).all()
    assert (i[np.isnan(v)] == 5).all()
    np.testing.assert_array_equal(v[:, :62], np.sort(x, axis=1)[:, :62])
    ties = np.zeros((2, 100), np.float32)
    _, ti = select_k(ties, 10, device="cpu")
    np.testing.assert_array_equal(np_(ti), np.broadcast_to(np.arange(10),
                                                           (2, 10)))


def test_select_k_in_idx_and_1d():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((4, 50)).astype(np.float32)
    src = rng.integers(0, 10_000, (4, 50)).astype(np.int32)
    jv, ji = jax_select_k(x, 7, in_idx=src)
    pv, pi = select_k(x, 7, in_idx=src, device="cpu")
    np.testing.assert_array_equal(np_(pi), np.asarray(ji))
    v1, i1 = select_k(x[0], 4, device="cpu")
    assert tuple(v1.shape) == (4,) and tuple(i1.shape) == (4,)
    with pytest.raises(ValueError):
        select_k(x, 51, device="cpu")


def test_merge_topk_matches_jax():
    rng = np.random.default_rng(3)
    d = rng.standard_normal((3, 5, 40)).astype(np.float32)
    i = rng.integers(0, 1000, (3, 5, 40)).astype(np.int32)
    for select_min in (True, False):
        jd, ji = jax_common.merge_topk(jnp.asarray(d), jnp.asarray(i), 6,
                                       select_min)
        pd, pi = common.merge_topk(torch.from_numpy(d), torch.from_numpy(i),
                                   6, select_min)
        np.testing.assert_array_equal(np_(pd), np.asarray(jd))
        np.testing.assert_array_equal(np_(pi), np.asarray(ji))


@pytest.mark.parametrize("select_min", [True, False])
def test_blocked_topk_across_blocks(monkeypatch, select_min):
    """Many small blocks give the whole row's top-k: stable (ties to the
    lower column), filtered columns at the sentinel with id -1."""
    monkeypatch.setattr(common, "BLOCK_ROWS", 7)
    rng = np.random.default_rng(4)
    dist = rng.integers(0, 6, (5, 50)).astype(np.float32)    # many ties
    keep = rng.random(50) < 0.5                               # < k kept
    sentinel = np.inf if select_min else -np.inf
    masked = np.where(keep[None, :], dist, sentinel)
    order = np.argsort(masked if select_min else -masked, axis=1,
                       kind="stable")[:, :30]
    want_d = np.take_along_axis(masked, order, 1)
    t = torch.from_numpy(dist)
    pd, pi = common.blocked_topk(lambda c0, c1: t[:, c0:c1], 50, 30,
                                 select_min=select_min, sentinel=sentinel,
                                 keep=torch.from_numpy(keep))
    np.testing.assert_array_equal(np_(pd), want_d)
    np.testing.assert_array_equal(np_(pi),
                                  np.where(np.isinf(want_d), -1, order))
    assert pi.dtype == torch.int32


def test_bitset_words_match_jax():
    mask = np.random.default_rng(4).random(77) < 0.4
    jb = JaxBitset.from_dense(jnp.asarray(mask))
    pb = Bitset.from_dense(torch.from_numpy(mask))
    np.testing.assert_array_equal(pb.to_numpy(), np.asarray(jb.bits))
    assert int(pb.count()) == int(jb.count()) == mask.sum()
    np.testing.assert_array_equal(np_(pb.to_dense()), mask)
    # the reference's words load unchanged
    back = Bitset(77, bits=np.asarray(jb.bits))
    np.testing.assert_array_equal(np_(back.to_dense()), mask)
    pb.resize(100, default=True)
    jb.resize(100, default=True)
    np.testing.assert_array_equal(pb.to_numpy(), np.asarray(jb.bits))
    want = np.concatenate([mask, np.ones(23, bool)])
    want[[3, 90]] = False
    pb.set(np.array([3, 90]), False).flip()
    np.testing.assert_array_equal(np_(pb.to_dense()), ~want)


@pytest.mark.parametrize("out_of_range", ["drop", "keep"])
def test_filter_keep_and_resolve_match_jax(out_of_range):
    mask = np.random.default_rng(5).random(40) < 0.5
    ids = np.array([-1, 0, 3, 17, 39, 40, 45, 1000], np.int32)
    jk = jax_common.filter_keep(JaxBitset.from_dense(jnp.asarray(mask)).bits,
                                40, jnp.asarray(ids), out_of_range)
    pk = common.filter_keep(Bitset.from_dense(torch.from_numpy(mask)).bits,
                            40, torch.from_numpy(ids), out_of_range)
    np.testing.assert_array_equal(np_(pk), np.asarray(jk))
    filt = common.BitsetFilter(Bitset.from_dense(torch.from_numpy(mask)),
                               out_of_range)
    bits = common.resolve_filter_bits(filt, 64)
    assert bits.n_bits == (64 if out_of_range == "keep" else 40)
    assert common.resolve_filter_bits(filt, 64) is bits
    assert common.resolve_filter_bits(common.as_filter(None), 64) is None


_PAIRWISE = ["sqeuclidean", "euclidean", "cosine", "inner_product",
             "correlation", "l1", "chebyshev", "canberra", "minkowski",
             "braycurtis", "jensenshannon", "hamming", "kl_divergence",
             "hellinger", "russellrao", "jaccard", "dice"]


@pytest.mark.parametrize("metric", _PAIRWISE)
def test_pairwise_matches_jax(metric):
    rng = np.random.default_rng(6)
    x = rng.random((20, 12)).astype(np.float32)
    y = rng.random((30, 12)).astype(np.float32)
    if metric in ("hamming", "jaccard", "dice", "russellrao"):
        x, y = (x > 0.5).astype(np.float32), (y > 0.5).astype(np.float32)
    want = np.asarray(jax_pairwise(x, y, metric, 3.0))
    got = np_(pairwise_distance(x, y, metric, 3.0, device="cpu"))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


def test_haversine_and_metric_names():
    rng = np.random.default_rng(7)
    x = rng.uniform(-1, 1, (10, 2)).astype(np.float32)
    y = rng.uniform(-1, 1, (15, 2)).astype(np.float32)
    np.testing.assert_allclose(
        np_(pairwise_distance(x, y, "haversine", device="cpu")),
        np.asarray(jax_pairwise(x, y, "haversine")), rtol=1e-5, atol=1e-6)
    from raft_tpu.distance.types import METRIC_NAMES as JAX_NAMES
    assert {k: int(v) for k, v in METRIC_NAMES.items()} == \
        {k: int(v) for k, v in JAX_NAMES.items()}
    assert int(DistanceType.Precomputed) == 100


def test_fused_l2_nn_matches_jax():
    rng = np.random.default_rng(8)
    x = rng.standard_normal((300, 16)).astype(np.float32)
    y = rng.standard_normal((50, 16)).astype(np.float32)
    jv, ji = jax_l2nn(x, y)
    for tile in (None, 7):
        pv, pi = fused_l2_nn_argmin(x, y, tile_n=tile, device="cpu")
        np.testing.assert_array_equal(np_(pi), np.asarray(ji))
        np.testing.assert_allclose(np_(pv), np.asarray(jv), rtol=1e-5,
                                   atol=1e-4)


def test_index_files_cross_load(tmp_path):
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.array([1, -1], np.int32)}
    p1, p2 = str(tmp_path / "port.bin"), str(tmp_path / "jax.bin")
    serialize.write_index_file(p1, "ivf_flat", 1, {"metric": 0}, arrays)
    jax_serialize.write_index_file(p2, "ivf_flat", 1, {"metric": 0}, arrays)
    assert open(p1, "rb").read() == open(p2, "rb").read()
    v, meta, got = jax_serialize.read_index_file(p1, "ivf_flat")
    assert (v, meta) == (1, {"metric": 0})
    np.testing.assert_array_equal(got["a"], arrays["a"])
    with pytest.raises(ValueError, match="expected index kind"):
        serialize.read_index_file(p2, "brute_force")
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"NOTMAGIC" + io.BytesIO(b"x" * 16).read())
    with pytest.raises(ValueError, match="not a raft_tpu index file"):
        serialize.read_index_file(str(bad), "ivf_flat")


def test_device_rule(monkeypatch):
    assert resources.resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resources.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        select_k(np.zeros((1, 4), np.float32), 2)


def test_port_imports_build_nothing_and_no_jax():
    """Importing every module of the port builds and loads no kernel, and
    none of them imports jax or raft_tpu."""
    import ast
    import importlib
    import pathlib
    import pkgutil

    import raft_tpu_torch
    from raft_tpu_torch.ops import _build

    for info in pkgutil.walk_packages(raft_tpu_torch.__path__,
                                      "raft_tpu_torch."):
        importlib.import_module(info.name)
    assert _build._LOADED == {}
    for path in pathlib.Path(raft_tpu_torch.__path__[0]).rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "raft_tpu"), (path, name)
