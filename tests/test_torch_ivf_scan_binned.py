"""Kernel 2's binned extraction arms (raft_tpu_torch.ops.ivf_scan, plain
versions) against the JAX reference.

* The extraction alone: ``binned_topk`` against the reference's own
  ``_extract_topk_binned`` / ``_extract_topk_binned_deep`` run eagerly on
  the same distances — small integers, so most of them tie — at every
  boundary k (1, 10, 13 binned; 14, 30, 64, 65, 256 binned_deep) and caps
  256, 384 and 640, with masked tails and a row with nothing valid: equal
  bit for bit, ids included.
* The whole scan: each storage kind (f32 rows, int8 rows with residual
  queries and per-list scales, packed i4, sign bits with the row scale,
  pq4 codes) through ``ivf_list_scan_topk(extract=...)`` on CPU tensors
  against ``fused_list_scan_topk(..., interpret=True, extract=...)``, with
  a list shorter than k, an empty list, a keep filter and duplicate rows
  (equal distances in one bin and in neighbouring bins). Tolerance:
  distances 1e-5 relative plus 1e-4 absolute (the two sum the products in
  other orders), ids equal outside near-ties.
* ``pick_extract`` / ``eligible_extracts`` / ``binned_loss_fits`` /
  ``binned_k_cap`` against the reference's on a grid of (k, cap, recall
  target).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.ops import ivf_scan as jax_scan
from raft_tpu_torch.ops import ivf_scan
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

C, G, NB, M = 4, 8, 4, 30


@pytest.mark.parametrize("extract, k", [
    ("binned", 1), ("binned", 10), ("binned", 13), ("binned_deep", 14),
    ("binned_deep", 30), ("binned_deep", 64), ("binned_deep", 65),
    ("binned_deep", 256)])
@pytest.mark.parametrize("cap", [256, 384, 640])
def test_extraction_matches_reference_on_ties(extract, k, cap):
    rng = np.random.default_rng(cap + k + 1000 * (extract == "binned"))
    dist = rng.integers(0, 6, (G, cap)).astype(np.float32)
    dist[:, cap - 77:] = np.inf                  # the list ends
    dist[3] = np.inf                             # nothing valid
    dist[5, ::3] = np.inf                        # filtered
    ids = (np.arange(cap, dtype=np.int32) * 3 + 1)
    jd = np.zeros((1, G, k), np.float32)
    ji = np.zeros((1, G, k), np.int32)
    ref = (jax_scan._extract_topk_binned if extract == "binned"
           else jax_scan._extract_topk_binned_deep)
    ref(jnp.asarray(dist), jnp.asarray(ids), k, cap, jd, ji)
    pd, pi = ivf_scan.binned_topk(torch.from_numpy(dist)[None],
                                  torch.from_numpy(ids)[None], k, extract)
    np.testing.assert_array_equal(np_(pd)[0], jd[0])
    np.testing.assert_array_equal(np_(pi)[0], ji[0])


def _duplicate(w, arm, positions):
    """Copy position p's row (storage, norm, row scale, keep) to each
    target of ``positions`` [(p, target)] in lists 0 and 3."""
    for lst in (0, 3):
        for p, t in positions:
            if t >= w["ids"].shape[1]:
                continue
            if arm in ("f32", "i8"):
                w["storage"][lst, t] = w["storage"][lst, p]
            else:
                w["storage"][lst, :, t] = w["storage"][lst, :, p]
            for side in ("norms", "fac", "keep"):
                if w[side] is not None:
                    w[side][lst, t] = w[side][lst, p]


def _workload(seed, arm, cap, rot, p=0, pl=0):
    """Random rows of one storage kind with their sidecars, lists full,
    shorter than k, empty and nearly full, and duplicated rows: position
    p copied to p + 128 and p + 256 (one bin) and to p + 1 (the next)."""
    rng = np.random.default_rng(seed)
    nw = {"i4": rot // 8, "bits": -(-rot // 32), "pq4": -(-p // 8)}.get(arm)
    w = dict(ids=(np.arange(C * cap, dtype=np.int32) * 5 + 2).reshape(C, cap),
             sizes=np.array([cap, 9, 0, cap - 21], np.int32),
             bl=np.arange(NB, dtype=np.int32) % C,
             bq=rng.integers(0, M, (NB, G)).astype(np.int32),
             q_rot=(rng.standard_normal((M, rot)) * 2).astype(np.float32),
             c_rot=rng.standard_normal((C, rot)).astype(np.float32),
             keep=(rng.random((C, cap)) < 0.75).astype(np.int32),
             norms=rng.uniform(10, 50, (C, cap)).astype(np.float32),
             scales=None, fac=None, pqc=None, rot=rot)
    w["bq"][0, 5:] = -1
    if arm == "f32":
        w["storage"] = rng.standard_normal((C, cap, rot)).astype(np.float32)
        w["norms"] = (w["storage"] ** 2).sum(2)
    elif arm == "i8":
        w["storage"] = rng.integers(-128, 128, (C, cap, rot)).astype(np.int8)
        w["scales"] = rng.uniform(0.05, 0.2, (C, rot)).astype(np.float32)
    else:
        w["storage"] = rng.integers(0, 2 ** 32, (C, nw, cap),
                                    dtype=np.uint64).astype(np.uint32)
    if arm == "i4":
        w["scales"] = rng.uniform(0.05, 0.2, (C, rot)).astype(np.float32)
    if arm == "bits":
        w["fac"] = rng.uniform(0.5, 1.5, (C, cap)).astype(np.float32)
    if arm == "pq4":
        w["pqc"] = rng.standard_normal((p, 16, pl)).astype(np.float32)
    _duplicate(w, arm, [(3, 131), (3, 259), (40, 41), (7, 135), (100, 101)])
    return w


def _jax(w, arm, k, ip, bf16, keep, extract):
    mm = jnp.bfloat16 if bf16 else jnp.float32
    qsafe = np.maximum(w["bq"], 0)
    q = w["q_rot"][qsafe]
    kw = {}
    if arm == "f32":
        # IVF-Flat: plain queries, qaux = ||q||^2
        src = q
        qaux = None if ip else jnp.asarray((q * q).sum(2))
    else:
        q_res = q - w["c_rot"][w["bl"]][:, None, :]
        src = q if ip else q_res
        qaux = None if ip else jnp.asarray((q_res * q_res).sum(2))
    if w["scales"] is not None:
        src = src * w["scales"][w["bl"]][:, None, :]
    qv = jnp.asarray(src).astype(mm)
    if arm == "bits":
        qv = jnp.pad(qv, ((0, 0), (0, 0),
                          (0, w["storage"].shape[1] * 32 - w["rot"])))
        kw = dict(packed_bits=True, row_scale=jnp.asarray(w["fac"]))
    elif arm == "i4":
        kw = dict(packed_i4=True)
    elif arm == "pq4":
        p, _, pl = w["pqc"].shape
        eye = np.eye(p, dtype=np.float32)
        kw = dict(lut_weights=jnp.asarray(
            (w["pqc"].transpose(1, 0, 2)[:, :, :, None]
             * eye[None, :, None, :]).reshape(16, p * pl, p)))
    jd, ji = jax_scan.fused_list_scan_topk(
        jnp.asarray(w["storage"]), jnp.asarray(w["ids"]),
        jnp.asarray(w["sizes"]), jnp.asarray(w["bl"]), qv, qaux,
        None if ip else jnp.asarray(w["norms"]),
        jnp.asarray(w["keep"]) if keep else None, k=k,
        metric_kind=jax_scan.IP if ip else jax_scan.L2, approx=True,
        extract=extract, interpret=True, **kw)
    return np_(jd), np_(ji)


def _port(w, arm, k, ip, bf16, keep, extract):
    t = torch.from_numpy
    st = w["storage"]
    q, c = w["q_rot"], w["c_rot"]
    kw = dict(k=k, compute_dtype="bf16" if bf16 else "f32", extract=extract)
    qaux = None
    if arm == "bits":
        pad = st.shape[1] * 32 - w["rot"]
        q, c = np.pad(q, ((0, 0), (0, pad))), np.pad(c, ((0, 0), (0, pad)))
        kw.update(packed_bits=True, row_scale=t(w["fac"]))
    elif arm == "i4":
        kw.update(packed_i4=True)
    elif arm == "pq4":
        kw.update(pq_centers=t(w["pqc"]))
    if w["scales"] is not None:
        kw.update(scale=t(w["scales"]))
    if ip:
        kw.update(metric_kind=ivf_scan.IP)
    elif arm == "f32":
        kw.update(metric_kind=ivf_scan.L2)
        qaux = t((q * q).sum(1))
    else:
        kw.update(metric_kind=ivf_scan.L2, centers=t(c))
    storage = t(st.view(np.int32) if st.dtype == np.uint32 else st)
    pd, pi = ivf_scan.ivf_list_scan_topk(
        storage, t(w["ids"]), t(w["sizes"]), t(w["bl"]), t(w["bq"]), t(q),
        qaux, None if ip else t(w["norms"]),
        t(w["keep"]) if keep else None, **kw)
    return np_(pd), np_(pi)


_SHAPES = {"f32": dict(rot=24), "i8": dict(rot=40), "i4": dict(rot=40),
           "bits": dict(rot=40), "pq4": dict(rot=48, p=24, pl=2)}


@pytest.mark.parametrize("arm, extract, k, cap, ip, bf16, keep", [
    ("f32", "binned", 1, 256, False, False, True),
    ("f32", "binned", 13, 384, True, False, False),
    ("i8", "binned", 10, 256, False, True, True),
    ("i4", "binned", 10, 384, False, True, False),
    ("i4", "binned", 10, 256, True, False, True),
    ("bits", "binned", 13, 256, False, False, True),
    ("pq4", "binned", 10, 256, False, True, True),
    ("f32", "binned_deep", 14, 256, False, False, True),
    ("i8", "binned_deep", 30, 384, False, True, True),
    ("bits", "binned_deep", 40, 256, False, True, False),
    ("pq4", "binned_deep", 30, 256, True, False, False),
], ids=lambda v: str(v))
def test_binned_plain_matches_pallas_interpret(arm, extract, k, cap, ip,
                                               bf16, keep):
    seed = 700 + 7 * k + cap + 3 * ip + ("f32", "i8", "i4", "bits",
                                         "pq4").index(arm)
    w = _workload(seed, arm, cap, **_SHAPES[arm])
    jd, ji = _jax(w, arm, k, ip, bf16, keep, extract)
    pd, pi = _port(w, arm, k, ip, bf16, keep, extract)
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, k), pi.reshape(-1, k)
    jd, ji = jd.reshape(-1, k), ji.reshape(-1, k)
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-5, atol=1e-4)
    # the empty slots and lists come back (+inf, -1), the short list's
    # tail too
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
    assert (pi[valid] == -1).any()


def _reference_extract(k, cap, approx, rt, extract=None):
    """The arm the reference's entry point hands its kernel: its Pallas
    call is replaced by a stand-in that records ``extract``."""
    seen = {}

    def stand_in(*a, extract, **kw):
        seen["extract"] = extract
        return None, None

    orig = jax_scan._fused_list_scan_topk
    jax_scan._fused_list_scan_topk = stand_in
    try:
        jax_scan.fused_list_scan_topk(
            jnp.zeros((1, cap, 8)), jnp.zeros((1, cap), jnp.int32),
            jnp.zeros((1,), jnp.int32), jnp.zeros((1,), jnp.int32),
            jnp.zeros((1, 8, 8)), k=k, metric_kind=jax_scan.IP,
            approx=approx, recall_target=rt, extract=extract)
    finally:
        jax_scan._fused_list_scan_topk = orig
    return seen["extract"]


def test_pick_extract_matches_reference():
    for k in (1, 2, 10, 13, 14, 30, 64, 65, 200, 256):
        for cap in (128, 200, 256, 384, 1024):
            for approx, rt in ((True, 0.95), (True, 0.5), (True, 0.99),
                               (True, 0.0), (False, 0.95)):
                if k > cap:
                    continue
                want = _reference_extract(k, cap, approx, rt)
                assert ivf_scan.pick_extract(k, cap, approx, rt) == want, (
                    k, cap, approx, rt)
                for arm in ("exact", "binned", "binned_deep"):
                    try:
                        _reference_extract(k, cap, approx, rt, arm)
                        ok = True
                    except ValueError:
                        ok = False
                    assert (arm in ivf_scan.eligible_extracts(
                        k, cap, approx, rt)) == ok, (k, cap, approx, rt, arm)


def test_loss_model_matches_reference():
    for rt in (0.0, 0.5, 0.75, 0.9, 0.95, 0.96, 0.99, 1.0):
        assert ivf_scan.binned_k_cap(rt) == jax_scan.binned_k_cap(rt)
        for k in range(1, 70):
            assert ivf_scan.binned_loss_fits(k, rt) == \
                jax_scan.binned_loss_fits(k, rt)
    assert ivf_scan.DEFAULT_RECALL_TARGET == jax_scan.DEFAULT_RECALL_TARGET
    assert ivf_scan.binned_k_cap() == 13


def test_wrapper_refuses_ineligible_arms():
    w = _workload(800, "f32", 128, rot=24)
    t = torch.from_numpy
    args = (t(w["storage"]), t(w["ids"]), t(w["sizes"]), t(w["bl"]),
            t(w["bq"]), t(w["q_rot"]))
    with pytest.raises(ValueError, match="not eligible"):
        ivf_scan.ivf_list_scan_topk(*args, k=10, metric_kind=ivf_scan.IP,
                                    extract="binned")
    w = _workload(801, "f32", 256, rot=24)
    args = (t(w["storage"]), t(w["ids"]), t(w["sizes"]), t(w["bl"]),
            t(w["bq"]), t(w["q_rot"]))
    with pytest.raises(ValueError, match="not eligible"):
        ivf_scan.ivf_list_scan_topk(*args, k=65, metric_kind=ivf_scan.IP,
                                    extract="binned")
    # the fold arm is accepted, its output 128 R = 256 slots wide at k = 10
    d, i = ivf_scan.ivf_list_scan_topk(*args, k=10, metric_kind=ivf_scan.IP,
                                       extract="fold")
    assert d.shape == i.shape == (NB, G, 256)
    with pytest.raises(ValueError, match="extract must be"):
        ivf_scan.ivf_list_scan_topk(*args, k=10, metric_kind=ivf_scan.IP,
                                    extract="folded")
    d, i = ivf_scan.ivf_list_scan_topk(*args, k=65, metric_kind=ivf_scan.IP,
                                       extract="binned_deep")
    assert d.shape == (NB, G, 65)
