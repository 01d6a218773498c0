"""The two fold arms (raft_tpu_torch.ops.fused_topk's and ops.ivf_scan's,
plain versions on CPU tensors) against the JAX reference's Pallas kernels
in interpret mode, and through the searches that take them.

* Kernel 1's fold: the unmerged [m, n_tiles * 128 R] buffer of
  ``fused_knn_fold`` against ``_fused_topk_tiles(variant="fold",
  interpret=True)``, column for column, and the merged top-k against
  ``fused_topk(variant="fold")``: L2, inner product and cosine, f32 and
  bf16 operands, k = 10, 65, 130, 200 (R = 2, 2, 3, 4), row tiles 256 and
  512, n off a multiple of the tile.
* Kernel 2's fold: ``ivf_list_scan_topk(extract="fold")`` against
  ``fused_list_scan_topk(extract="fold", approx=True, interpret=True)`` on
  every storage arm (f32 rows, bf16 rows, int8 rows with residual queries
  and per-list scales, packed i4, sign bits with the row scale, pq4
  codes), k = 10, 130, 200, with an empty list, one shorter than k, a
  keep filter and duplicate rows; and the output contract of the
  reference's ``test_list_scan_fold_width_and_invalids``.
* Searches: the fast brute force with the fold forced in both packages
  (ids after the exact refine equal); ``_resolve_bf_impl`` against the
  reference's on the accelerator, with and without a table; IVF-Flat and
  IVF-PQ (int8 cache) at ``scan_impl="pallas_interpret"`` under a dispatch
  table whose ``ivf_scan_extract`` entry names the fold, on an index the
  reference built, against the reference under the same table.

Tolerance: distances 1e-5 relative plus 1e-4 absolute (the packages sum
products in other orders); ids equal wherever the reference's distance has
no other within that tolerance in its lane stack (unmerged buffers) or
its row (merged results).
"""

import importlib
import json

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from raft_tpu import tuning as jax_tuning
from raft_tpu.neighbors import brute_force as jax_bf
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch import convert, tuning
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq
from raft_tpu_torch.ops import fused_topk, ivf_scan
from tests.test_torch_ivf_scan_binned import _SHAPES, _jax, _port, _workload
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

jax_ft = importlib.import_module("raft_tpu.ops.fused_topk")

pytestmark = pytest.mark.usefixtures("torch_threads")

RTOL, ATOL = 1e-5, 1e-4


@pytest.fixture
def tables():
    """Both packages' tuning state, restored after the test, and the
    reference's jit caches dropped: its searches resolve the arm while
    they trace, so an executable traced under a table would answer a
    later call at the same shapes with the table's arm."""
    yield
    for mod in (tuning, jax_tuning):
        mod.set_table_path(None)
        mod.set_mode(None)
        mod.reload()
    jax.clear_caches()


def assert_fold_match(pd, pi, jd, ji, R):
    """Two fold buffers [..., n_blocks * 128 R], column for column: +inf
    where the reference has it, distances within tolerance, ids equal
    wherever the reference's distance has no other within tolerance in
    its lane stack (the R slots of its lane)."""
    pd, pi, jd, ji = (np.asarray(a).reshape(-1, R, 128)
                      for a in (pd, pi, jd, ji))
    np.testing.assert_array_equal(np.isinf(pd), np.isinf(jd))
    np.testing.assert_array_equal(pi == -1, np.isinf(jd))
    fin = np.isfinite(jd)
    np.testing.assert_allclose(pd[fin], jd[fin], rtol=RTOL, atol=ATOL)
    tol = ATOL + RTOL * np.abs(np.where(fin, jd, 0.0))
    near = np.zeros_like(fin)
    with np.errstate(invalid="ignore"):          # inf - inf
        for a in range(R):
            for b in range(R):
                if a != b:
                    near[:, a] |= np.abs(jd[:, a] - jd[:, b]) <= tol[:, a]
    keyed = fin & ~near
    assert (pi[keyed] == ji[keyed]).all(), int((pi[keyed] != ji[keyed]).sum())


# --- kernel 1 --------------------------------------------------------------

def _knn_inputs(seed, metric_kind, bf16, m=9, n=1100, d=12):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    norms = None if metric_kind == fused_topk.IP else (x * x).sum(1)
    jq, jx = jnp.asarray(q), jnp.asarray(x)
    tq, tx = torch.from_numpy(q), torch.from_numpy(x)
    if bf16:
        jq, jx = jq.astype(jnp.bfloat16), jx.astype(jnp.bfloat16)
        tq, tx = tq.to(torch.bfloat16), tx.to(torch.bfloat16)
    return jq, jx, tq, tx, norms


@pytest.mark.parametrize("tile_n", [256, 512])
@pytest.mark.parametrize("k", [10, 65, 130, 200])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP,
                                         fused_topk.COSINE],
                         ids=["l2", "ip", "cosine"])
def test_kernel1_fold_matches_pallas_interpret(metric_kind, bf16, k,
                                               tile_n):
    jq, jx, tq, tx, norms = _knn_inputs(31 * k + tile_n + metric_kind, 
                                        metric_kind, bf16)
    m = tq.shape[0]
    jn = None if norms is None else jnp.asarray(norms)
    tn = None if norms is None else torch.from_numpy(norms)
    geo = jax_ft.tile_geometry(m, tx.shape[0], tx.shape[1], k, "fold",
                               2 if bf16 else 4)
    assert geo == fused_topk.tile_geometry(m, tx.shape[0], tx.shape[1], k,
                                           "fold", 2 if bf16 else 4)
    jd, ji = jax_ft._fused_topk_tiles(
        jq, jx, jn, None, k=k, metric_kind=metric_kind, variant="fold",
        tile_q=geo["tile_q"], tile_n=tile_n, interpret=True)
    pd, pi = fused_topk.fused_knn_fold(tq, tx, k, metric_kind=metric_kind,
                                       norms=tn, tile_n=tile_n)
    R = fused_topk.fold_depth(k)
    assert R == jax_ft.fold_depth(k)
    assert pd.shape == (m, -(-tx.shape[0] // tile_n) * 128 * R)
    assert_fold_match(np_(pd), np_(pi), np_(jd)[:m], np_(ji)[:m], R)
    # merged: the exact merge over the buffer
    jd, ji = jax_ft.fused_topk(jq, jx, k, metric_kind=metric_kind, norms=jn,
                               variant="fold", tile_n=tile_n, interpret=True)
    pd, pi = fused_topk.fused_knn_topk(tq, tx, k, metric_kind=metric_kind,
                                       norms=tn, variant="fold",
                                       tile_n=tile_n)
    assert_topk_match(pd, pi, jd, ji, k, rtol=RTOL, atol=ATOL)


def test_kernel1_fold_refusals_and_geometry():
    q, x = torch.zeros(4, 8), torch.zeros(600, 8)
    with pytest.raises(ValueError, match="tile_n % 128"):
        fused_topk.fused_knn_topk(q, x, 10, metric_kind=fused_topk.IP,
                                  variant="fold", tile_n=200)
    with pytest.raises(ValueError, match="out of range"):
        fused_topk.fused_knn_topk(q, x, 257, metric_kind=fused_topk.IP,
                                  variant="fold")
    with pytest.raises(ValueError, match="variant"):
        fused_topk.fused_knn_topk(q, x, 10, metric_kind=fused_topk.IP,
                                  variant="binned")
    for k in (1, 64, 65, 128, 129, 192, 193, 256):
        assert fused_topk.fold_depth(k) == jax_ft.fold_depth(k)
        for v in ("exact", "fold"):
            assert fused_topk.candidate_width(k, v) == \
                jax_ft.candidate_width(k, v)
    for args in [(10_000, 1_000_000, 128, 42, "fold", 2),
                 (10_000, 1_000_000, 960, 200, "fold", 2),
                 (5, 300, 24, 10, "exact", 4), (100, 5000, 4096, 256,
                                                "fold", 4),
                 (1, 10, 8, 1, "fold", 1)]:
        assert fused_topk.tile_geometry(*args) == jax_ft.tile_geometry(*args)
    assert fused_topk.tile_geometry(10_000, 1_000_000, 128, 42, "fold",
                                    2)["tile_n"] == 2048


# --- kernel 2 --------------------------------------------------------------

_ARMS = {"f32": "f32", "bf16": "f32", "i8": "i8", "i4": "i4",
         "bits": "bits", "pq4": "pq4"}


@pytest.mark.parametrize("k", [10, 130, 200])
@pytest.mark.parametrize("arm, ip, bf16, keep", [
    ("f32", False, False, True), ("bf16", True, True, False),
    ("i8", False, True, True), ("i4", False, True, False),
    ("bits", False, False, True), ("pq4", True, False, True)],
    ids=lambda v: str(v))
def test_kernel2_fold_matches_pallas_interpret(arm, ip, bf16, keep, k):
    cap = 256 if k < 200 else 384
    base = _ARMS[arm]
    w = _workload(900 + k + cap + len(arm), base, cap, **_SHAPES[base])
    if arm == "bf16":
        # bf16 rows: the reference and the port hold the same rounded rows
        w["storage"] = np_(torch.from_numpy(w["storage"]).to(
            torch.bfloat16).float())
        w["norms"] = (w["storage"] ** 2).sum(2)
    jd, ji = _jax(w, base, k, ip, bf16, keep, "fold")
    pd, pi = _port(w, base, k, ip, bf16, keep, "fold")
    R = fused_topk.fold_depth(k)
    assert pd.shape == jd.shape == (w["bq"].shape + (128 * R,))
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, 128 * R), pi.reshape(-1, 128 * R)
    jd, ji = jd.reshape(-1, 128 * R), ji.reshape(-1, 128 * R)
    assert_fold_match(pd[valid], pi[valid], jd[valid], ji[valid], R)
    # empty slots come back (+inf, -1) (the reference scans query 0 there)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()


def test_kernel2_fold_width_and_invalids():
    """The reference's fold contract (tests/test_pallas_parity.py
    test_list_scan_fold_width_and_invalids): width 128 R, invalid slots
    (+inf, -1), every finite id a live row; here with lists of 100 rows
    and the dense f32 arm."""
    w = _workload(5, "f32", 256, rot=24)
    w["sizes"][:] = 100
    pd, pi = _port(w, "f32", 10, False, False, False, "fold")
    assert pd.shape[2] == 256
    assert ((pi == -1) == np.isinf(pd)).all()
    live = pi[pi >= 0]
    pos = (live - 2) // 5 % 256          # ids are 5 * (list * cap + pos) + 2
    assert (pos < 100).all()
    # and the arm resolves to fold only through a table: never the
    # analytic pick
    for k, cap in ((10, 256), (30, 512), (200, 1024)):
        assert "fold" in ivf_scan.eligible_extracts(k, cap)
        assert ivf_scan.pick_extract(k, cap) != "fold"


def test_kernel2_wrapper_resolves_through_the_table(tables, tmp_path):
    """``extract=None``: the wrapper takes ``resolve_extract``'s arm at its
    own query group — the analytic pick on a miss, the fold where a table
    names it, exact without ``approx`` whatever the table says."""
    w = _workload(6, "f32", 256, rot=24)
    t = torch.from_numpy
    args = (t(w["storage"]), t(w["ids"]), t(w["sizes"]), t(w["bl"]),
            t(w["bq"]), t(w["q_rot"]))
    kw = dict(k=10, metric_kind=ivf_scan.IP, extract=None)
    binned = ivf_scan.ivf_list_scan_topk(*args, **{**kw,
                                                   "extract": "binned"})
    got = ivf_scan.ivf_list_scan_topk(*args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, binned))
    tuning.set_table_path(_fold_table(tmp_path, [
        {"cap": 256, "k": 10, "g": w["bq"].shape[1]}]))
    for scan in (ivf_scan.ivf_list_scan_topk,
                 ivf_scan.ivf_list_scan_topk_plain):
        assert scan(*args, **kw)[0].shape[2] == 256
        exact = scan(*args, approx=False, **kw)
        want = scan(*args, **{**kw, "extract": "exact"})
        assert all(torch.equal(a, b) for a, b in zip(exact, want))


# --- searches --------------------------------------------------------------

@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_fast_brute_force_forced_fold(metric):
    rng = np.random.default_rng(41)
    x = rng.standard_normal((3000, 16)).astype(np.float32)
    q = rng.standard_normal((20, 16)).astype(np.float32)
    ref = jax_bf.search(jax_bf.build(x, metric), q, 10, fast=True,
                        impl="fused_fold:512:interpret")
    got = brute_force.search(brute_force.build(x, metric, device="cpu"), q,
                             10, fast=True, impl="fused_fold:512:interpret")
    assert_topk_match(*got, *ref, 10, rtol=RTOL, atol=ATOL)


def _table(path, op, entries, backend="cuda"):
    with open(path, "w") as f:
        json.dump({"version": 1, "backend": backend, "ops": {op: {
            "entries": entries}}, "budgets": {}}, f)
    return str(path)


def test_resolve_bf_impl_matches_reference(tables, tmp_path, monkeypatch):
    from raft_tpu.distance.types import DistanceType as JaxDistanceType
    from raft_tpu_torch.distance.types import DistanceType

    # the reference is told that it runs on its accelerator
    monkeypatch.setattr(jax_tuning, "backend_name", lambda: "tpu")
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    cases = [(10_000, 1_000_000, 128, 42, "L2Expanded", False, True),
             (10_000, 1_000_000, 128, 42, "L2Expanded", True, True),
             (10_000, 1_000_000, 128, 10, "InnerProduct", False, False),
             (64, 20_000, 64, 130, "CosineExpanded", False, False),
             (64, 20_000, 64, 130, "CosineExpanded", False, True),
             (64, 20_000, 64, 300, "L2Expanded", False, True),
             (512, 20_000, 960, 200, "L2SqrtExpanded", False, True),
             (512, 20_000, 64, 10, "L1", False, True)]

    def both():
        for m, n, d, k, metric, filtered, approx in cases:
            want = jax_bf._resolve_bf_impl(
                "auto", m, n, d, k, JaxDistanceType[metric], filtered,
                approx)
            got = brute_force._resolve_bf_impl(
                "auto", m, n, d, k, DistanceType[metric], filtered, approx,
                cuda)
            assert got == want, (m, n, d, k, metric, filtered, approx)
            assert brute_force._resolve_bf_impl(
                "auto", m, n, d, k, DistanceType[metric], filtered, approx,
                cpu) == "scan"
            assert brute_force._resolve_bf_impl(
                "fused_exact:512", m, n, d, k, DistanceType[metric],
                filtered, approx, cuda) == "fused_exact:512"

    both()
    assert brute_force._resolve_bf_impl(
        "auto", 10_000, 1_000_000, 128, 42, DistanceType.L2Expanded, False,
        True, cuda) == "fused_fold:2048"
    path = _table(tmp_path / "bf.json", "fused_topk_tile", [
        {"key": {"m": 10_000, "n": 1_000_000, "d": 128, "k": 42},
         "winner": "fused_exact:1024", "times_ms": {}},
        {"key": {"m": 64, "n": 20_000, "d": 64, "k": 130},
         "winner": "fused_fold:512", "times_ms": {}},
        {"key": {"m": 512, "n": 20_000, "d": 64, "k": 10},
         "winner": "fused_fold:9999", "times_ms": {}}])
    for mod in (tuning, jax_tuning):
        mod.set_table_path(path)
    both()
    assert brute_force._resolve_bf_impl(
        "auto", 10_000, 1_000_000, 128, 42, DistanceType.L2Expanded, False,
        True, cuda) == "fused_exact:1024"


def _fold_table(tmp_path, keys):
    return _table(tmp_path / "fold.json", "ivf_scan_extract",
                  [{"key": key, "winner": "fold", "times_ms": {}}
                   for key in keys])


def _record_arms(monkeypatch):
    """The extraction arm each package's scan takes, by call: the
    reference's jitted kernel call and the port's plain scan, each
    wrapped by a recorder that passes the call on."""
    arms = {"ref": [], "port": []}
    jax_scan = importlib.import_module("raft_tpu.ops.ivf_scan")
    ref_fn = jax_scan._fused_list_scan_topk
    port_fn = ivf_scan.ivf_list_scan_topk_plain

    def ref(*a, **kw):
        arms["ref"].append(kw["extract"])
        return ref_fn(*a, **kw)

    def port(*a, **kw):
        arms["port"].append(kw["extract"])
        return port_fn(*a, **kw)

    monkeypatch.setattr(jax_scan, "_fused_list_scan_topk", ref)
    monkeypatch.setattr(ivf_scan, "ivf_list_scan_topk_plain", port)
    return arms


def test_ivf_flat_under_fold_table(tables, tmp_path, monkeypatch):
    rng = np.random.default_rng(43)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    jix = jax_ivf.build(jax_ivf.IndexParams(n_lists=16, kmeans_n_iters=5),
                        x)
    cap = int(jix.storage.shape[1])
    assert cap % 128 == 0 and cap > 128
    arrays = {f: np.asarray(getattr(jix, f)) for f in
              ("centers", "storage", "indices", "list_sizes", "data_norms")}
    pix = convert.ivf_flat_index_from_numpy(arrays, jix.metric,
                                            device="cpu")
    group = ivf_flat.adaptive_query_group(64, 4, 16, 256)
    path = _fold_table(tmp_path, [{"cap": cap, "k": 10, "g": group}])
    for mod in (tuning, jax_tuning):
        mod.set_table_path(path)
    assert ivf_scan.resolve_extract(10, cap, group) == "fold"
    sp = dict(n_probes=4, scan_impl="pallas_interpret",
              compute_dtype="f32")
    arms = _record_arms(monkeypatch)
    jd, ji = jax_ivf.search(jax_ivf.SearchParams(**sp), jix, q, 10)
    pd, pi = ivf_flat.search(ivf_flat.SearchParams(**sp), pix, q, 10)
    assert arms == {"ref": ["fold"], "port": ["fold"]}
    assert_topk_match(pd, pi, jd, ji, 10, rtol=RTOL, atol=ATOL)
    # "xla" takes no kernel, so no table: the exact plain scan
    xd, xi = ivf_flat.search(ivf_flat.SearchParams(
        n_probes=4, scan_impl="xla", compute_dtype="f32"), pix, q, 10)
    ed, ei = jax_ivf.search(jax_ivf.SearchParams(
        n_probes=4, scan_impl="xla", compute_dtype="f32"), jix, q, 10)
    assert_topk_match(xd, xi, ed, ei, 10, rtol=RTOL, atol=ATOL)
    assert arms["port"] == ["fold", "exact"]


def test_ivf_pq_under_fold_table(tables, tmp_path, monkeypatch):
    rng = np.random.default_rng(44)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    jix = jax_pq.build(jax_pq.IndexParams(n_lists=16, pq_dim=16,
                                          kmeans_n_iters=5), x)
    assert jix.cache_kind == "i8"
    cap = int(jix.indices.shape[1])
    assert cap % 128 == 0 and cap > 128
    fields = ("centers", "centers_rot", "rotation", "pq_centers", "codes",
              "indices", "list_sizes", "rec_norms", "recon_cache")
    pix = convert.ivf_pq_index_from_numpy(
        {f: np.asarray(getattr(jix, f)) for f in fields}, jix.metric,
        device="cpu", codebook_kind=jix.codebook_kind,
        recon_scale=jix.recon_scale)
    group = ivf_flat.adaptive_query_group(64, 4, 16, 256)
    path = _fold_table(tmp_path, [{"cap": cap, "k": k, "g": group}
                                  for k in (10, 30)])
    for mod in (tuning, jax_tuning):
        mod.set_table_path(path)
    arms = _record_arms(monkeypatch)
    for k in (10, 30):
        sp = dict(n_probes=4, scan_impl="pallas_interpret")
        jd, ji = jax_pq.search(jax_pq.SearchParams(**sp), jix, q, k)
        pd, pi = ivf_pq.search(ivf_pq.SearchParams(**sp), pix,
                               torch.from_numpy(q), k)
        assert_topk_match(pd, pi, jd, ji, k, rtol=RTOL, atol=ATOL)
    assert arms == {"ref": ["fold"] * 2, "port": ["fold"] * 2}
