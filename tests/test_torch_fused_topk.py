"""The port's brute-force distance + top-k (raft_tpu_torch.ops.fused_topk)
against the JAX Pallas kernel in interpret mode.

On the CPU the wrapper runs the kernel's plain version; the CUDA kernel is
held against that plain version on the card by chip_smoke.py. Tolerance:
distances 1e-4 relative (the two stacks sum the dot products in different
orders), ids equal outside near-ties.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.ops.fused_topk import fused_topk as jax_fused_topk
from raft_tpu_torch.ops import fused_topk
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _data(seed, m=64, n=3000, d=24):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    return q, x


@pytest.mark.parametrize("k", [1, 10, 40])
def test_plain_matches_pallas_exact_l2(k):
    q, x = _data(0)
    jd, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(x), k + 1,
                            metric_kind=fused_topk.L2, variant="exact",
                            interpret=True)
    pd, pi = fused_topk.fused_knn_topk_plain(
        torch.from_numpy(q), torch.from_numpy(x), k + 1,
        metric_kind=fused_topk.L2)
    assert_topk_match(pd, pi, jd, ji, k)


@pytest.mark.parametrize("metric_kind", [fused_topk.IP, fused_topk.COSINE])
def test_plain_matches_pallas_ip_cosine(metric_kind):
    q, x = _data(1)
    jd, ji = jax_fused_topk(jnp.asarray(q), jnp.asarray(x), 11,
                            metric_kind=metric_kind, variant="exact",
                            interpret=True)
    pd, pi = fused_topk.fused_knn_topk_plain(
        torch.from_numpy(q), torch.from_numpy(x), 11, metric_kind=metric_kind)
    assert_topk_match(pd, pi, jd, ji, 10, rtol=1e-4, atol=1e-5)


def test_plain_matches_pallas_bf16_operands():
    """bf16 operands on both sides: the same rounded inputs, f32 sums."""
    q, x = _data(2, m=32, n=1500)
    jd, ji = jax_fused_topk(jnp.asarray(q, jnp.bfloat16),
                            jnp.asarray(x, jnp.bfloat16), 11,
                            metric_kind=fused_topk.L2, variant="exact",
                            interpret=True)
    pd, pi = fused_topk.fused_knn_topk_plain(
        torch.from_numpy(q).bfloat16(), torch.from_numpy(x).bfloat16(), 11,
        metric_kind=fused_topk.L2)
    assert_topk_match(pd, pi, jd, ji, 10)


def test_plain_keep_filter_and_short_rows():
    """Filtered rows never come back; with fewer than k eligible rows the
    tail is (+inf, -1)."""
    q, x = _data(3, m=8, n=200, d=8)
    keep = np.zeros(200, np.int32)
    keep[::40] = 1                                    # 5 eligible rows
    d, i = fused_topk.fused_knn_topk_plain(
        torch.from_numpy(q), torch.from_numpy(x), 8,
        metric_kind=fused_topk.L2, keep=torch.from_numpy(keep))
    d, i = np_(d), np_(i)
    assert set(i[:, :5].ravel().tolist()) <= set(range(0, 200, 40))
    assert (i[:, 5:] == -1).all() and np.isinf(d[:, 5:]).all()
    want = ((q[:, None, :] - x[None, ::40, :]) ** 2).sum(-1)
    np.testing.assert_allclose(d[:, :5], np.sort(want, axis=1), rtol=1e-5,
                               atol=1e-5)


def test_wrapper_on_cpu_runs_plain_and_counts_no_launch():
    q, x = _data(4, m=16, n=500, d=8)
    before = fused_topk.fused_knn_topk.launches
    wd, wi = fused_topk.fused_knn_topk(torch.from_numpy(q),
                                       torch.from_numpy(x), 5,
                                       metric_kind=fused_topk.L2)
    pd, pi = fused_topk.fused_knn_topk_plain(torch.from_numpy(q),
                                             torch.from_numpy(x), 5,
                                             metric_kind=fused_topk.L2)
    assert fused_topk.fused_knn_topk.launches == before
    np.testing.assert_array_equal(np_(wi), np_(pi))
    np.testing.assert_array_equal(np_(wd), np_(pd))


@pytest.mark.parametrize("bad", ["k0", "k_over_cap", "metric", "dims"])
def test_wrapper_rejects_bad_arguments(bad):
    q, x = _data(5, m=4, n=300, d=8)
    q, x = torch.from_numpy(q), torch.from_numpy(x)
    kw = dict(metric_kind=fused_topk.L2)
    k = {"k0": 0, "k_over_cap": fused_topk.K_MAX + 1}.get(bad, 3)
    if bad == "metric":
        kw["metric_kind"] = 7
    if bad == "dims":
        x = x[:, :4]
    with pytest.raises(ValueError):
        fused_topk.fused_knn_topk(q, x, k, **kw)


def test_kernel_build_is_keyed_by_source_and_needs_nvcc(monkeypatch,
                                                         tmp_path):
    """The library name hashes the sources and flags, and building without
    the CUDA toolkit raises instead of falling back."""
    from raft_tpu_torch.ops import _build

    path = _build._lib_path("fused_knn_topk")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("libfused_knn_topk-")
    assert _build._lib_path("ivf_list_scan_topk") != path
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.nvcc_path()
