"""Kernel 2's int8 arm with residual queries (raft_tpu_torch.ops.ivf_scan,
plain version) against the JAX Pallas kernel in interpret mode.

The JAX caller (ivf_pq.py:2043-2062) pre-gathers each bucket's queries as
qv = (q_rot[q] - centers_rot[l]) * scale (L2) or q_rot[q] * scale (inner
product), cast to the compute type, with qaux = ||q_rot[q] -
centers_rot[l]||^2; the port takes q_rot, centers_rot and the scale and
builds the same operands itself. Empty slots (-1) are compared only on
the port side (the reference scans query 0 there). Tolerance: distances
1e-4 relative (the two sum the f32 products and qaux in other orders),
ids equal outside near-ties.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.ops import ivf_scan as jax_scan
from raft_tpu_torch.ops import ivf_scan
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _workload(seed, rot, C=4, cap=256, G=8, nb=6, m=30):
    rng = np.random.default_rng(seed)
    cache = rng.integers(-127, 128, (C, cap, rot)).astype(np.int8)
    scale = np.float32(rng.uniform(0.01, 0.05))
    recon = cache.astype(np.float32) * scale
    norms = (recon * recon).sum(-1).astype(np.float32)
    ids = (np.arange(C * cap, dtype=np.int32) * 5 + 2).reshape(C, cap)
    sizes = np.array([cap, 9, 0, cap - 21][:C], np.int32)
    bl = np.arange(nb, dtype=np.int32) % C
    bq = rng.integers(0, m, (nb, G)).astype(np.int32)
    bq[0, 5:] = -1
    q_rot = (rng.standard_normal((m, rot)) * 2).astype(np.float32)
    c_rot = rng.standard_normal((C, rot)).astype(np.float32)
    keep = (rng.random((C, cap)) < 0.75).astype(np.int32)
    return dict(cache=cache, scale=scale, norms=norms, ids=ids, sizes=sizes,
                bl=bl, bq=bq, q_rot=q_rot, c_rot=c_rot, keep=keep)


def _jax(w, k, ip, bf16, keep):
    qsafe = np.maximum(w["bq"], 0)
    mm = jnp.bfloat16 if bf16 else jnp.float32
    if ip:
        qv = jnp.asarray(w["q_rot"][qsafe] * w["scale"]).astype(mm)
        mk, qaux, norms = jax_scan.IP, None, None
    else:
        q_res = w["q_rot"][qsafe] - w["c_rot"][w["bl"]][:, None, :]
        qv = jnp.asarray(q_res * w["scale"]).astype(mm)
        mk, qaux = jax_scan.L2, jnp.asarray((q_res * q_res).sum(2))
        norms = jnp.asarray(w["norms"])
    jd, ji = jax_scan.fused_list_scan_topk(
        jnp.asarray(w["cache"]), jnp.asarray(w["ids"]),
        jnp.asarray(w["sizes"]), jnp.asarray(w["bl"]), qv, qaux, norms,
        jnp.asarray(w["keep"]) if keep else None, k=k, metric_kind=mk,
        approx=False, extract="exact", interpret=True)
    return np_(jd), np_(ji)


def _port(w, k, ip, bf16, keep):
    t = torch.from_numpy
    kw = dict(k=k, compute_dtype="bf16" if bf16 else "f32",
              scale=float(w["scale"]))
    if ip:
        kw.update(metric_kind=ivf_scan.IP)
        norms = None
    else:
        kw.update(metric_kind=ivf_scan.L2, centers=t(w["c_rot"]))
        norms = t(w["norms"])
    pd, pi = ivf_scan.ivf_list_scan_topk(
        t(w["cache"]), t(w["ids"]), t(w["sizes"]), t(w["bl"]), t(w["bq"]),
        t(w["q_rot"]), None, norms, t(w["keep"]) if keep else None, **kw)
    return np_(pd), np_(pi)


@pytest.mark.parametrize("rot", [20, 40])
@pytest.mark.parametrize("ip", [False, True], ids=["l2", "ip"])
@pytest.mark.parametrize("bf16", [True, False], ids=["bf16", "f32"])
def test_int8_residual_plain_matches_pallas_interpret(rot, ip, bf16):
    w = _workload(100 + rot + 2 * ip + bf16, rot)
    k = 10
    jd, ji = _jax(w, k, ip, bf16, keep=rot == 40)
    pd, pi = _port(w, k, ip, bf16, keep=rot == 40)
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, k), pi.reshape(-1, k)
    jd, ji = jd.reshape(-1, k), ji.reshape(-1, k)
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-4, atol=1e-4)
    # the list shorter than k and the empty list come back (+inf, -1)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
    assert (pi[valid] == -1).any()


@pytest.mark.parametrize("k", [1, 64])
def test_int8_residual_k_range(k):
    w = _workload(200 + k, 20, nb=4)
    jd, ji = _jax(w, k, False, True, keep=False)
    pd, pi = _port(w, k, False, True, keep=False)
    valid = (w["bq"] >= 0).reshape(-1)
    assert_topk_match(pd.reshape(-1, k)[valid], pi.reshape(-1, k)[valid],
                      jd.reshape(-1, k)[valid], ji.reshape(-1, k)[valid], k)


def test_residual_qaux_sum_order():
    """The plain version's qaux is the kernel's fixed order: component 0
    first, each product and sum rounded once — not torch's own sum."""
    r = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (5, 7, 96)).astype(np.float32))
    want = np.zeros((5, 7), np.float32)
    rn = r.numpy()
    for c in range(96):
        want = (want + rn[..., c] * rn[..., c]).astype(np.float32)
    np.testing.assert_array_equal(np_(ivf_scan.sq_norms_in_order(r)), want)


def test_int8_wrapper_checks():
    w = _workload(300, 20, nb=2, cap=384)
    t = torch.from_numpy
    args = (t(w["cache"]), t(w["ids"]), t(w["sizes"]), t(w["bl"]),
            t(w["bq"]), t(w["q_rot"]))
    with pytest.raises(ValueError, match="L2 only"):
        ivf_scan.ivf_list_scan_topk(*args, None, None, k=3,
                                    metric_kind=ivf_scan.IP,
                                    centers=t(w["c_rot"]))
    with pytest.raises(ValueError, match="f32, bf16 or int8"):
        ivf_scan.ivf_list_scan_topk(t(w["cache"]).to(torch.int16),
                                    *args[1:], k=3, metric_kind=ivf_scan.IP)
    # the plain version keeps k past the kernel's 256, up to the capacity
    pd, pi = ivf_scan.ivf_list_scan_topk_plain(
        *args, None, t(w["norms"]), k=300, metric_kind=ivf_scan.L2,
        centers=t(w["c_rot"]), scale=float(w["scale"]))
    assert pd.shape == (2, 8, 300)
    with pytest.raises(ValueError, match="k=300"):
        ivf_scan.ivf_list_scan_topk(*args, None, t(w["norms"]), k=300,
                                    metric_kind=ivf_scan.L2,
                                    centers=t(w["c_rot"]))
