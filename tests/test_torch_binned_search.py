"""The port's IVF-Flat and IVF-PQ searches take the reference's binned
extraction arms wherever the reference's kernel does, and the scan
resolver (neighbors.common.scan_route) routes each backend name as the
reference does.

* The probe: on 6,000 x 32 normal rows, 16 lists (cap 512), 4 probes,
  64 queries, k = 10, compute f32, the reference at
  scan_impl="pallas_interpret" and its default local_recall_target 0.95
  runs the binned arm interpreted, and its ids differ from its exact
  result in 7 rows; the port on the same index carried by convert returns
  the reference's ids.
* IVF-Flat and IVF-PQ (the int8 cache; k = 10, binned, and k = 30,
  binned_deep) at "pallas_interpret" and "pallas" with 0.95, against the
  reference with the same arguments ("pallas" off the TPU: the same
  kernel interpreted) on its own index carried across. Tolerance:
  distances 1e-5 relative plus 1e-4 absolute, ids equal outside
  near-ties (tests/torch_parity.py).
* The resolver's table, case by case, on a CUDA and a CPU index (the
  device is only read, so no card is needed).
"""

import jax
import numpy as np
import pytest
import torch

from raft_tpu import tuning as jax_tuning
from raft_tpu.neighbors import ivf_flat as jax_ivf
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch import convert, tuning
from raft_tpu_torch.neighbors import ivf_flat, ivf_pq
from raft_tpu_torch.neighbors.common import scan_route
from raft_tpu_torch.ops import ivf_scan
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


@pytest.fixture(scope="module", autouse=True)
def no_table():
    """Both packages' tuning at its defaults (no table: the analytic
    pick), and no executable of the reference left by an earlier test
    file in this process: its searches resolve the arm while they trace,
    so a search traced under another file's table at these shapes would
    answer with that table's arm."""
    for mod in (tuning, jax_tuning):
        mod.set_table_path(None)
        mod.set_mode(None)
        mod.reload()
    jax.clear_caches()


def _carry_flat(jix):
    arrays = {k: np.asarray(getattr(jix, k)) for k in
              ("centers", "storage", "indices", "list_sizes", "data_norms")}
    return convert.ivf_flat_index_from_numpy(arrays, jix.metric,
                                             device="cpu")


@pytest.fixture(scope="module")
def probe():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((6000, 32)).astype(np.float32)
    q = rng.standard_normal((64, 32)).astype(np.float32)
    jix = jax_ivf.build(jax_ivf.IndexParams(n_lists=16, kmeans_n_iters=5), x)
    assert jix.storage.shape[1] == 512
    return jix, _carry_flat(jix), q


def _flat_pair(probe, port_kw, jax_kw, k=10):
    jix, pix, q = probe
    sp = dict(n_probes=4, compute_dtype="f32")
    ref = jax_ivf.search(jax_ivf.SearchParams(**sp, **jax_kw), jix, q, k)
    got = ivf_flat.search(ivf_flat.SearchParams(**sp, **port_kw), pix, q, k)
    return got, ref


def test_probe_pallas_interpret_takes_the_binned_arm(probe):
    got, ref = _flat_pair(probe, dict(scan_impl="pallas_interpret"),
                          dict(scan_impl="pallas_interpret"))
    _, exact = _flat_pair(probe, dict(scan_impl="xla"),
                          dict(scan_impl="pallas_interpret",
                               local_recall_target=1.0))
    # the reference's binned arm loses neighbours in 7 of 64 rows ...
    differ = (np_(ref[1]) != np_(exact[1])).any(1)
    assert int(differ.sum()) == 7
    # ... and the port's loses the same ones
    np.testing.assert_array_equal(np_(got[1]), np_(ref[1]))
    assert_topk_match(*got, *ref, 10, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("port_impl", ["pallas_interpret", "pallas",
                                       "pallas:16"])
@pytest.mark.parametrize("k", [10, 30])
def test_ivf_flat_default_target_matches_reference(probe, port_impl, k):
    got, ref = _flat_pair(probe, dict(scan_impl=port_impl,
                                      local_recall_target=0.95),
                          dict(scan_impl="pallas_interpret",
                               local_recall_target=0.95), k)
    assert_topk_match(*got, *ref, k, rtol=1e-5, atol=1e-4)


_PQ_FIELDS = ("centers", "centers_rot", "rotation", "pq_centers", "codes",
              "indices", "list_sizes", "rec_norms", "recon_cache")


@pytest.fixture(scope="module")
def pq_probe():
    rng = np.random.default_rng(1)
    c = rng.uniform(-3, 3, (12, 24)).astype(np.float32)
    x = (c[rng.integers(0, 12, 5000)]
         + rng.standard_normal((5000, 24))).astype(np.float32)
    q = (c[rng.integers(0, 12, 48)]
         + rng.standard_normal((48, 24))).astype(np.float32)
    jix = jax_pq.build(jax_pq.IndexParams(n_lists=12, pq_dim=12,
                                          kmeans_n_iters=8), x)
    assert jix.cache_kind == "i8"
    cap = jix.indices.shape[1]
    assert cap % 128 == 0 and cap > 128
    arrays = {f: np.asarray(getattr(jix, f)) for f in _PQ_FIELDS}
    pix = convert.ivf_pq_index_from_numpy(
        arrays, jix.metric, device="cpu", codebook_kind=jix.codebook_kind,
        recon_scale=jix.recon_scale)
    return jix, pix, q


@pytest.mark.parametrize("port_impl", ["pallas_interpret", "pallas"])
@pytest.mark.parametrize("k", [10, 30])
def test_ivf_pq_default_target_matches_reference(pq_probe, port_impl, k):
    jix, pix, q = pq_probe
    sp = dict(n_probes=3, local_recall_target=0.95)
    jd, ji = jax_pq.search(jax_pq.SearchParams(
        scan_impl="pallas_interpret", **sp), jix, q, k)
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(scan_impl=port_impl, **sp),
                           pix, torch.from_numpy(q), k)
    assert_topk_match(pd, pi, jd, ji, k, rtol=1e-5, atol=1e-4)


CUDA, CPU = torch.device("cuda"), torch.device("cpu")


@pytest.mark.parametrize("requested, kl, cap, rt, device, want", [
    # "xla": the exact plain scan everywhere
    ("xla", 10, 512, 0.95, CUDA, ("plain", "exact")),
    ("xla", 30, 512, 0.95, CPU, ("plain", "exact")),
    # "pallas_interpret": the plain version with the pick
    ("pallas_interpret", 10, 512, 0.95, CUDA, ("plain", "binned")),
    ("pallas_interpret", 30, 512, 0.95, CPU, ("plain", "binned_deep")),
    ("pallas_interpret", 10, 512, 1.0, CPU, ("plain", "exact")),
    ("pallas_interpret", 10, 128, 0.95, CPU, ("plain", "exact")),
    ("pallas_interpret", 300, 512, 0.95, CPU, ("plain", "exact")),
    # "pallas[:tile]": the kernel with the pick on the card, plain on CPU
    ("pallas", 13, 384, 0.95, CUDA, ("kernel", "binned")),
    ("pallas", 14, 384, 0.95, CUDA, ("kernel", "binned_deep")),
    ("pallas:16", 64, 256, 0.5, CUDA, ("kernel", "binned")),
    ("pallas", 64, 256, 0.95, CUDA, ("kernel", "binned_deep")),
    ("pallas", 10, 256, 0.5, CUDA, ("kernel", "binned")),
    ("pallas", 256, 1024, 0.95, CUDA, ("kernel", "binned_deep")),
    ("pallas", 10, 200, 0.95, CUDA, ("kernel", "exact")),
    ("pallas", 10, 512, 1.0, CUDA, ("kernel", "exact")),
    ("pallas", 10, 512, 0.95, CPU, ("plain", "binned")),
    ("pallas:8", 40, 512, 0.95, CPU, ("plain", "binned_deep")),
    # "auto": the card takes the pick at kl <= 64 on a 128-aligned cap,
    # the exact kernel to 256, the exact plain scan past it; the CPU the
    # exact plain scan
    ("auto", 10, 512, 0.95, CUDA, ("kernel", "binned")),
    ("auto", 64, 512, 0.95, CUDA, ("kernel", "binned_deep")),
    ("auto", 40, 12288, 0.95, CUDA, ("kernel", "binned_deep")),
    ("auto", 65, 512, 0.95, CUDA, ("kernel", "exact")),
    ("auto", 256, 512, 0.95, CUDA, ("kernel", "exact")),
    ("auto", 257, 512, 0.95, CUDA, ("plain", "exact")),
    ("auto", 10, 200, 0.95, CUDA, ("kernel", "exact")),
    ("auto", 10, 128, 0.95, CUDA, ("kernel", "exact")),
    ("auto", 10, 512, 1.0, CUDA, ("kernel", "exact")),
    ("auto", 10, 512, 0.95, CPU, ("plain", "exact")),
    ("auto", 300, 512, 0.95, CPU, ("plain", "exact")),
])
def test_scan_route_table(requested, kl, cap, rt, device, want):
    # the arm the scan takes: scan_route's, or where it leaves the arm to
    # the kernel (None), the kernel's own pick at a query group of 256
    # (no packaged table covers ivf_scan_extract, so the analytic pick)
    route, arm = scan_route(requested, kl, cap, device)
    if arm is None:
        arm = ivf_scan.resolve_extract(kl, cap, 256, rt < 1.0, rt, device)
    assert (route, arm) == want


@pytest.mark.parametrize("device", [CUDA, CPU])
def test_scan_route_refuses(device):
    with pytest.raises(ValueError, match="at most 256"):
        scan_route("pallas", 257, 512, device)
    with pytest.raises(ValueError, match="scan_impl"):
        scan_route("binned", 10, 512, device)
