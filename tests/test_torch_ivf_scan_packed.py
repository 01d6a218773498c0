"""Kernel 2's packed storage arms and per-list query scales
(raft_tpu_torch.ops.ivf_scan, plain versions) against the JAX Pallas
kernel in interpret mode.

The JAX caller (ivf_pq.py:2043-2112) pre-gathers each bucket's residual
queries, folds the scales into them (per list for the i4 and raw caches,
1 for pq4 and RaBitQ), zero-pads them to the sign-word width for RaBitQ
and hands pq4 the block-diagonal codebook weights; the port takes q_rot,
centers_rot, the scales and the codebook and builds the same operands
itself. Empty slots (-1) are compared only on the port side (the
reference scans query 0 there). Tolerance: distances 1e-4 relative (the
two sum the f32 products and qaux in other orders), ids equal outside
near-ties.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu.ops import ivf_scan as jax_scan
from raft_tpu_torch.ops import ivf_scan
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

C, CAP, G, NB, M = 4, 128, 8, 4, 30


def _workload(seed, arm, rot, p=0, pl=0):
    """Random packed words and sidecars of one arm, with lists of every
    kind: full, shorter than k, empty, nearly full."""
    rng = np.random.default_rng(seed)
    nw = {"i4": rot // 8, "bits": -(-rot // 32), "pq4": -(-p // 8),
          "i8": 0}[arm]
    w = dict(ids=(np.arange(C * CAP, dtype=np.int32) * 5 + 2).reshape(C, CAP),
             sizes=np.array([CAP, 9, 0, CAP - 21], np.int32),
             bl=np.arange(NB, dtype=np.int32) % C,
             bq=rng.integers(0, M, (NB, G)).astype(np.int32),
             q_rot=(rng.standard_normal((M, rot)) * 2).astype(np.float32),
             c_rot=rng.standard_normal((C, rot)).astype(np.float32),
             keep=(rng.random((C, CAP)) < 0.75).astype(np.int32),
             norms=rng.uniform(10, 50, (C, CAP)).astype(np.float32),
             scales=None, fac=None, pqc=None, rot=rot)
    w["bq"][0, 5:] = -1
    if arm == "i8":
        w["storage"] = rng.integers(-128, 128, (C, CAP, rot)).astype(np.int8)
    else:
        w["storage"] = rng.integers(0, 2 ** 32, (C, nw, CAP),
                                    dtype=np.uint64).astype(np.uint32)
    if arm in ("i4", "i8"):
        w["scales"] = rng.uniform(0.05, 0.2, (C, rot)).astype(np.float32)
    if arm == "bits":
        w["fac"] = rng.uniform(0.5, 1.5, (C, CAP)).astype(np.float32)
    if arm == "pq4":
        w["pqc"] = rng.standard_normal((p, 16, pl)).astype(np.float32)
    return w


def _jax(w, arm, k, ip, bf16, keep):
    mm = jnp.bfloat16 if bf16 else jnp.float32
    rot = w["rot"]
    qsafe = np.maximum(w["bq"], 0)
    q_res = w["q_rot"][qsafe] - w["c_rot"][w["bl"]][:, None, :]
    src = w["q_rot"][qsafe] if ip else q_res
    if w["scales"] is not None:
        src = src * w["scales"][w["bl"]][:, None, :]
    qv = jnp.asarray(src).astype(mm)
    kw = {}
    if arm == "bits":
        qv = jnp.pad(qv, ((0, 0), (0, 0), (0, w["storage"].shape[1] * 32
                                           - rot)))
        kw = dict(packed_bits=True, row_scale=jnp.asarray(w["fac"]))
    elif arm == "i4":
        kw = dict(packed_i4=True)
    elif arm == "pq4":
        p, _, pl = w["pqc"].shape
        eye = np.eye(p, dtype=np.float32)
        kw = dict(lut_weights=jnp.asarray(
            (w["pqc"].transpose(1, 0, 2)[:, :, :, None]
             * eye[None, :, None, :]).reshape(16, p * pl, p)))
    qaux = None if ip else jnp.asarray((q_res * q_res).sum(2))
    jd, ji = jax_scan.fused_list_scan_topk(
        jnp.asarray(w["storage"]), jnp.asarray(w["ids"]),
        jnp.asarray(w["sizes"]), jnp.asarray(w["bl"]), qv, qaux,
        None if ip else jnp.asarray(w["norms"]),
        jnp.asarray(w["keep"]) if keep else None, k=k,
        metric_kind=jax_scan.IP if ip else jax_scan.L2, approx=False,
        extract="exact", interpret=True, **kw)
    return np_(jd), np_(ji)


def _port(w, arm, k, ip, bf16, keep):
    t = torch.from_numpy
    st = w["storage"]
    q, c = w["q_rot"], w["c_rot"]
    kw = dict(k=k, compute_dtype="bf16" if bf16 else "f32")
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
    else:
        kw.update(metric_kind=ivf_scan.L2, centers=t(c))
    storage = t(st.view(np.int32) if st.dtype == np.uint32 else st)
    pd, pi = ivf_scan.ivf_list_scan_topk(
        storage, t(w["ids"]), t(w["sizes"]), t(w["bl"]), t(w["bq"]), t(q),
        None, None if ip else t(w["norms"]), t(w["keep"]) if keep else None,
        **kw)
    return np_(pd), np_(pi)


def _compare(w, arm, k, ip, bf16, keep):
    jd, ji = _jax(w, arm, k, ip, bf16, keep)
    pd, pi = _port(w, arm, k, ip, bf16, keep)
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, k), pi.reshape(-1, k)
    jd, ji = jd.reshape(-1, k), ji.reshape(-1, k)
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-4, atol=1e-4)
    # the list shorter than k and the empty list come back (+inf, -1)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
    if k > 9:
        assert (pi[valid] == -1).any()


# per operand type: i4 at 5 words (the last depth slice partial); RaBitQ
# at a partial second word (pad bits decode -1 against zero query
# components) and at whole words; pq4 at 24 subspaces of 2 and at pq_len
# 1 (each table entry one product, the DEEP-10M pq4 geometry)
_SHAPES = {"i4": (dict(rot=40), dict(rot=40)),
           "bits": (dict(rot=40), dict(rot=64)),
           "pq4": (dict(rot=48, p=24, pl=2), dict(rot=24, p=24, pl=1)),
           "i8": (dict(rot=40), dict(rot=40))}


@pytest.mark.parametrize("arm", ["i4", "bits", "pq4", "i8"])
@pytest.mark.parametrize("ip", [False, True], ids=["l2", "ip"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_packed_plain_matches_pallas_interpret(arm, ip, bf16):
    w = _workload(300 + 4 * ("i4", "bits", "pq4", "i8").index(arm)
                  + 2 * ip + bf16, arm, **_SHAPES[arm][bf16])
    _compare(w, arm, 10, ip, bf16, keep=not bf16)


@pytest.mark.parametrize("arm", ["i4", "bits", "pq4"])
def test_packed_k_one(arm):
    w = _workload(401, arm, **_SHAPES[arm][0])
    _compare(w, arm, 1, False, True, keep=True)


def test_unpack_fields_matches_reference_decodes():
    rng = np.random.default_rng(7)
    rows = rng.integers(0, 2 ** 32, (3, 17, 5),
                        dtype=np.uint64).astype(np.uint32)    # [C, cap, nw]
    t = torch.from_numpy(rows.view(np.int32))
    np.testing.assert_array_equal(
        np_(ivf_scan.unpack_fields(t, 40, 4, signed=True)).astype(np.float32),
        np.asarray(jax_pq.unpack_i4(jnp.asarray(rows))))
    np.testing.assert_array_equal(
        2 * np_(ivf_scan.unpack_fields(t, 150, 1)) - 1,
        np.asarray(jax_pq.unpack_sign_bits(jnp.asarray(rows), 150)))
    np.testing.assert_array_equal(
        np_(ivf_scan.unpack_fields(t, 37, 4)),
        np.asarray(jax_pq.unpack_codes(jnp.asarray(rows), 37, 4)))


def test_packed_wrapper_checks():
    w = _workload(600, "pq4", rot=48, p=24, pl=2)
    t = torch.from_numpy
    st = t(w["storage"].view(np.int32))
    args = (st, t(w["ids"]), t(w["sizes"]), t(w["bl"]), t(w["bq"]),
            t(w["q_rot"]), None, None)
    kw = dict(k=5, metric_kind=ivf_scan.IP)
    with pytest.raises(ValueError, match="mutually exclusive"):
        ivf_scan.ivf_list_scan_topk(*args, packed_i4=True,
                                    pq_centers=t(w["pqc"]), **kw)
    with pytest.raises(ValueError, match="int32 words"):
        ivf_scan.ivf_list_scan_topk(st.to(torch.int8), *args[1:],
                                    packed_bits=True, **kw)
    with pytest.raises(ValueError, match="row_scale belongs"):
        ivf_scan.ivf_list_scan_topk(*args[:5], t(w["q_rot"][:, :24]), None,
                                    None, packed_i4=True,
                                    row_scale=t(w["norms"]), **kw)
    with pytest.raises(ValueError, match="scale-free"):
        ivf_scan.ivf_list_scan_topk(*args, pq_centers=t(w["pqc"]),
                                    scale=2.0, **kw)
    with pytest.raises(ValueError, match="subspaces"):
        ivf_scan.ivf_list_scan_topk(*args, pq_centers=t(np.zeros(
            (32, 16, 1), np.float32)), **kw)
    with pytest.raises(ValueError, match="queries must be"):
        ivf_scan.ivf_list_scan_topk(*args, packed_bits=True, **kw)
    with pytest.raises(ValueError, match="per-list scale"):
        ivf_scan.ivf_list_scan_topk(*args[:5], t(w["q_rot"][:, :24]), None,
                                    None, packed_i4=True,
                                    scale=torch.ones(C, 8), **kw)
    with pytest.raises(ValueError, match="L2 or inner product"):
        ivf_scan.ivf_list_scan_topk(*args[:6], t(w["q_rot"][:, 0]),
                                    t(w["norms"]), pq_centers=t(w["pqc"]),
                                    k=5, metric_kind=ivf_scan.COSINE)
