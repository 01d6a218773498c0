"""The port's IVF list scan + per-list top-k (raft_tpu_torch.ops.ivf_scan)
against the JAX Pallas kernel in interpret mode (float storage, exact
extraction).

The JAX kernel takes pre-gathered query groups qv [nb, G, d]; the port
gathers through bucket_q, so the comparison hands it qv flattened to
[nb * G, d] with bucket_q = arange. Tolerance: distances 1e-4 relative,
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


def _workload(seed, C=4, cap=256, d=32, G=8, nb=8, ragged=False):
    rng = np.random.default_rng(seed)
    storage = rng.standard_normal((C, cap, d)).astype(np.float32)
    ids = (np.arange(C * cap, dtype=np.int32) * 3 + 7).reshape(C, cap)
    sizes = np.full((C,), cap, np.int32)
    if ragged:
        sizes = np.array([cap, 5, 0, cap - 37][:C], np.int32)
    buckets = (np.arange(nb, dtype=np.int32) % C)
    qv = rng.standard_normal((nb, G, d)).astype(np.float32)
    return storage, ids, sizes, buckets, qv


def _aux(qv, storage, metric_kind):
    if metric_kind == ivf_scan.IP:
        return None, None
    qn = (qv.astype(np.float32) ** 2).sum(-1)
    qaux = qn if metric_kind == ivf_scan.L2 else np.sqrt(qn)
    return qaux, (storage.astype(np.float32) ** 2).sum(-1)


def _run_both(storage, ids, sizes, buckets, qv, k, metric_kind, keep=None,
              dtype=np.float32):
    qaux, norms = _aux(qv, storage, metric_kind)
    jdt = jnp.bfloat16 if dtype != np.float32 else jnp.float32
    jd, ji = jax_scan.fused_list_scan_topk(
        jnp.asarray(storage, jdt), jnp.asarray(ids), jnp.asarray(sizes),
        jnp.asarray(buckets), jnp.asarray(qv, jdt),
        None if qaux is None else jnp.asarray(qaux),
        None if norms is None else jnp.asarray(norms),
        None if keep is None else jnp.asarray(keep),
        k=k, metric_kind=metric_kind, approx=False, extract="exact",
        interpret=True)
    nb, G, d = qv.shape
    tdt = torch.bfloat16 if dtype != np.float32 else torch.float32
    pd, pi = ivf_scan.ivf_list_scan_topk(
        torch.from_numpy(storage).to(tdt), torch.from_numpy(ids),
        torch.from_numpy(sizes), torch.from_numpy(buckets),
        torch.arange(nb * G, dtype=torch.int32).reshape(nb, G),
        torch.from_numpy(qv.reshape(nb * G, d)).to(tdt),
        None if qaux is None else torch.from_numpy(qaux.reshape(-1)),
        None if norms is None else torch.from_numpy(norms),
        None if keep is None else torch.from_numpy(keep),
        k=k, metric_kind=metric_kind)
    return (np_(pd).reshape(nb * G, k), np_(pi).reshape(nb * G, k),
            np_(jd).reshape(nb * G, k), np_(ji).reshape(nb * G, k))


@pytest.mark.parametrize("metric_kind",
                         [ivf_scan.L2, ivf_scan.IP, ivf_scan.COSINE])
def test_plain_matches_pallas_exact(metric_kind):
    w = _workload(10 + metric_kind)
    pd, pi, jd, ji = _run_both(*w, k=11, metric_kind=metric_kind)
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-4, atol=1e-5)


def test_plain_matches_pallas_ragged_lists_and_keep():
    """Lists shorter than k (one empty), a keep filter: tails are
    (+inf, -1) on both sides and the ids are the stored global ids."""
    storage, ids, sizes, buckets, qv = _workload(20, ragged=True)
    keep = (np.random.default_rng(21).random(ids.shape) < 0.7).astype(
        np.int32)
    pd, pi, jd, ji = _run_both(storage, ids, sizes, buckets, qv, k=12,
                               metric_kind=ivf_scan.L2, keep=keep)
    assert_topk_match(pd, pi, jd, ji, 12)
    np.testing.assert_array_equal(pi == -1, ji == -1)
    assert (pi == -1).any() and (pi[pi >= 0] % 3 == 1).all()


def test_plain_matches_pallas_bf16():
    w = _workload(30, G=16, nb=4)
    pd, pi, jd, ji = _run_both(*w, k=11, metric_kind=ivf_scan.L2,
                               dtype="bf16")
    assert_topk_match(pd, pi, jd, ji, 10)


def test_empty_slots_come_back_invalid():
    storage, ids, sizes, buckets, qv = _workload(40, nb=2, G=8)
    nb, G, d = qv.shape
    bq = torch.arange(nb * G, dtype=torch.int32).reshape(nb, G)
    bq[1, 3:] = -1
    qaux, norms = _aux(qv, storage, ivf_scan.L2)
    pd, pi = ivf_scan.ivf_list_scan_topk(
        torch.from_numpy(storage), torch.from_numpy(ids),
        torch.from_numpy(sizes), torch.from_numpy(buckets[:nb]), bq,
        torch.from_numpy(qv.reshape(nb * G, d)),
        torch.from_numpy(qaux.reshape(-1)), torch.from_numpy(norms),
        k=4, metric_kind=ivf_scan.L2)
    assert (np_(pi)[1, 3:] == -1).all() and np.isinf(np_(pd)[1, 3:]).all()
    assert (np_(pi)[:, :3] >= 0).all()


def test_wrapper_on_cpu_counts_no_launch_and_checks_args():
    storage, ids, sizes, buckets, qv = _workload(50, nb=2)
    nb, G, d = qv.shape
    before = ivf_scan.ivf_list_scan_topk.launches
    args = (torch.from_numpy(storage), torch.from_numpy(ids),
            torch.from_numpy(sizes), torch.from_numpy(buckets[:nb]),
            torch.arange(nb * G, dtype=torch.int32).reshape(nb, G),
            torch.from_numpy(qv.reshape(nb * G, d)))
    ivf_scan.ivf_list_scan_topk(*args, k=3, metric_kind=ivf_scan.IP)
    assert ivf_scan.ivf_list_scan_topk.launches == before
    with pytest.raises(ValueError, match="norms"):
        ivf_scan.ivf_list_scan_topk(*args, k=3, metric_kind=ivf_scan.L2)
    with pytest.raises(ValueError, match="k="):
        ivf_scan.ivf_list_scan_topk(*args, k=ivf_scan.K_MAX + 1,
                                    metric_kind=ivf_scan.IP)
