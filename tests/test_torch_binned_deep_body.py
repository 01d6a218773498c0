"""Kernel 2's binned_deep arm and its Hopper body
(raft_tpu_torch/ops/csrc/ivf_scan_deep.cuh), on the CPU.

* ``binned_deep_body`` routes exactly the modes the Hopper body covers
  (int8, i4 and sign-bit rows under bf16 operands at rot <= 128, the int8
  rows' rot a multiple of 16), and ``_launch`` hands the C entry that
  body's extract code (a stand-in library records the call; no card);
  the exact and binned arms of the same modes take the Hopper arms' body
  (tests/test_torch_scan_hopper_arms.py).
* ``deep_smem_bytes``: the body's block stays within a block's 232,448 B
  of shared memory at rot 96 and 128 and refuses what does not fit; its
  constants are the header's.
* On small-integer inputs the plain binned_deep arm gives the same bits
  whether its dots are summed by ``torch.matmul`` or component by
  component: every dot is exact in any order, which is what lets the card
  hold the Hopper body (whose tensor cores sum in another order) to its
  plain version bit for bit on such inputs (chip_smoke.py).
* The plain version against the reference's kernel in interpret mode at
  the CAGRA self-search's arm: int8 residual L2, k = 64, rot 128.
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu_torch.ops import _build, ivf_scan
from tests.test_torch_ivf_scan_binned import _jax, _port, _workload
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

I8, I4, BITS = ivf_scan.I8, ivf_scan.I4, ivf_scan.BITS
_HEADER = Path(ivf_scan.__file__).parent / "csrc" / "ivf_scan_deep.cuh"


@pytest.mark.parametrize("kind, round_ops, rot, body", [
    (I8, True, 96, "hopper"), (I8, True, 128, "hopper"),
    (I8, True, 16, "hopper"), (I8, True, 40, "core"),
    (I8, True, 144, "core"), (I8, False, 96, "core"),
    (I4, True, 96, "hopper"), (I4, True, 40, "hopper"),
    (I4, True, 128, "hopper"), (I4, True, 136, "core"),
    (I4, False, 128, "core"), (BITS, True, 96, "hopper"),
    (BITS, True, 128, "hopper"), (BITS, True, 160, "core"),
    (BITS, False, 96, "core"), (0, True, 96, "core"), (1, True, 128, "core"),
    (ivf_scan.PQ4, True, 96, "core")])
def test_binned_deep_body_routes_by_mode(kind, round_ops, rot, body):
    assert ivf_scan.binned_deep_body(kind, round_ops, rot) == body
    want = ivf_scan.HOPPER_DEEP if body == "hopper" else 2
    assert ivf_scan.extract_code("binned_deep", 30, body) == want


class _Fn:
    """A C function of the stand-in library: records its arguments and
    takes ``argtypes`` / ``restype`` as ctypes' do."""

    def __init__(self, rc=0):
        self.calls, self.rc = [], rc

    def __call__(self, *args):
        self.calls.append(args)
        return self.rc


class _Lib:
    """Stands in for the kernel library."""

    def __init__(self):
        self.ivf_list_scan_topk = _Fn()
        self.rtt_error_string = _Fn(b"stand-in")


def _case(kind, rot, cap=256, C=3, nb=4, G=8, m=20, seed=0):
    """Random storage of ``kind`` with its sidecars, as the wrapper takes
    them."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    if kind in (0, 1, I8):
        x = rng.integers(-100, 100, (C, cap, rot))
        storage = t(x.astype(np.int8)) if kind == I8 else \
            t(x.astype(np.float32)).to([torch.float32, torch.bfloat16][kind])
    else:
        nw = rot // 8 if kind == I4 else -(-rot // 32)
        storage = t(rng.integers(-2 ** 31, 2 ** 31 - 1, (C, nw, cap),
                                 dtype=np.int64).astype(np.int32))
    return dict(
        storage=storage,
        indices=t(np.arange(C * cap, dtype=np.int32).reshape(C, cap)),
        list_sizes=t(np.full(C, cap - 3, np.int32)),
        bucket_list=t(np.arange(nb, dtype=np.int32) % C),
        bucket_q=t(rng.integers(-1, m, (nb, G)).astype(np.int32)),
        queries=t(rng.standard_normal((m, rot)).astype(np.float32)),
        norms=t(rng.uniform(1, 2, (C, cap)).astype(np.float32)),
        centers=t(rng.standard_normal((C, rot)).astype(np.float32)))


@pytest.mark.parametrize("kind, rot, extract, bf16, code, body", [
    (I8, 96, "binned_deep", True, 6, "hopper"),
    (I8, 128, "binned_deep", True, 6, "hopper"),
    (I8, 96, "binned_deep", False, 2, "core"),
    (I8, 96, "binned", True, 11, "hopper_binned"),
    (I8, 96, "exact", True, 10, "hopper_exact"),
    (I8, 96, "binned", False, 1, "core"),
    (I8, 96, "exact", False, 0, "core"),
    (I8, 96, "fold", True, 3, "core"),
    (I4, 96, "binned_deep", True, 6, "hopper"),
    (BITS, 96, "binned_deep", True, 6, "hopper"),
    (0, 96, "binned_deep", True, 2, "core"),
    (1, 128, "binned_deep", True, 2, "core")])
def test_launch_passes_the_body_extract_code(monkeypatch, kind, rot, extract,
                                             bf16, code, body):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "launches", 0)
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "by_body",
                        {"core": 0, "hopper": 0})
    w = _case(kind, rot)
    rows_scale = torch.ones(w["indices"].shape) if kind == BITS else None
    out_d, out_i = ivf_scan._launch(
        w["storage"], kind, w["indices"], w["list_sizes"],
        w["bucket_list"], w["bucket_q"], w["queries"], None, w["norms"],
        None, 30, ivf_scan.L2, bf16, w["centers"], 1.0, None, rows_scale,
        extract)
    (args,) = lib.ivf_list_scan_topk.calls
    assert args[1] == kind and args[25] == code
    assert args[16] == rot if kind != BITS else args[16] == 32 * 3
    assert out_d.shape[:2] == out_i.shape[:2] == tuple(w["bucket_q"].shape)
    assert ivf_scan.ivf_list_scan_topk.launches == 1
    want = {"core": 0, "hopper": 0}
    want[body] = 1
    assert ivf_scan.ivf_list_scan_topk.by_body == want


@pytest.mark.parametrize("kind", [I8, I4, BITS])
@pytest.mark.parametrize("rot", [96, 128])
def test_deep_smem_budget_fits_at_the_paths_widths(kind, rot):
    full = ivf_scan.deep_smem_bytes(kind, rot, norms=True, keep=True,
                                    row_scale=kind == BITS)
    assert full <= ivf_scan.SMEM_LIMIT
    assert ivf_scan.deep_smem_bytes(kind, rot, norms=False, keep=False) < full


@pytest.mark.parametrize("kind, rot, row_scale", [
    (I8, 144, False), (BITS, 1024, True), (ivf_scan.PQ4, 96, False),
    (0, 96, False)])
def test_deep_smem_budget_refuses_what_does_not_fit(kind, rot, row_scale):
    with pytest.raises(ValueError):
        ivf_scan.deep_smem_bytes(kind, rot, row_scale=row_scale)


def test_deep_smem_constants_are_the_headers():
    src = _HEADER.read_text()
    assert re.search(r"constexpr int DNS = (\d+);", src).group(1) == \
        str(ivf_scan._DEEP_STAGES)
    assert "SLOT_BYTES = DQ * DT * (16 + 8);" in src
    assert ivf_scan._DEEP_SLOTS == 64 * 128 * (16 + 8)
    assert re.search(r"SMEM_LIMIT = (\d+);", src).group(1) == \
        str(ivf_scan.SMEM_LIMIT)
    assert re.search(r"kBinnedDeepHopper = (\d+);", src).group(1) == \
        str(ivf_scan.HOPPER_DEEP)


def _componentwise(a, b):
    """``a @ b`` with each dot summed component by component in order."""
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for c in range(a.shape[-1]):
        out = out + a[..., :, c:c + 1] * b[..., c:c + 1, :]
    return out


def _small_integer_case(kind, rot, cap, seed):
    """Every dot exact in f32 whatever the order: small-integer queries,
    centers, rows and norms, scale 1, power-of-two row scales; duplicate
    rows put equal distances in one bin and in the next."""
    rng = np.random.default_rng(seed)
    C, nb, G, m = 3, 4, 10, 30
    t = torch.from_numpy
    if kind == I8:
        storage = rng.integers(-20, 21, (C, cap, rot)).astype(np.int8)
        storage[:, 131] = storage[:, 3]
        storage[:, 41] = storage[:, 40]
    else:
        nw = rot // 8 if kind == I4 else rot // 32
        storage = rng.integers(-2 ** 31, 2 ** 31 - 1, (C, nw, cap),
                               dtype=np.int64).astype(np.int32)
        storage[:, :, 131] = storage[:, :, 3]
        storage[:, :, 41] = storage[:, :, 40]
    norms = rng.integers(0, 200, (C, cap)).astype(np.float32)
    norms[:, 131], norms[:, 41] = norms[:, 3], norms[:, 40]
    args = (t(storage), t(np.arange(C * cap, dtype=np.int32).reshape(C, cap)),
            t(np.array([cap, 70, cap - 50], np.int32)),
            t(np.arange(nb, dtype=np.int32) % C),
            t(rng.integers(-1, m, (nb, G)).astype(np.int32)),
            t(rng.integers(-6, 7, (m, rot)).astype(np.float32)), None,
            t(norms), t((rng.random((C, cap)) < 0.8).astype(np.int32)))
    kw = dict(metric_kind=ivf_scan.L2, compute_dtype="bf16",
              centers=t(rng.integers(-3, 4, (C, rot)).astype(np.float32)),
              extract="binned_deep", packed_i4=kind == I4,
              packed_bits=kind == BITS)
    if kind == BITS:
        kw["row_scale"] = t((2.0 ** rng.integers(-2, 2, (C, cap)))
                            .astype(np.float32))
    return args, kw


@pytest.mark.parametrize("kind, rot, k", [
    (I8, 96, 30), (I8, 128, 64), (I4, 96, 40), (BITS, 128, 256)])
def test_plain_bits_do_not_depend_on_the_sum_order(monkeypatch, kind, rot,
                                                   k):
    args, kw = _small_integer_case(kind, rot, 384, seed=k + rot)
    assert ivf_scan.binned_deep_body(kind, True, rot) == "hopper"
    md, mi = ivf_scan.ivf_list_scan_topk_plain(*args, k=k, **kw)
    monkeypatch.setattr(ivf_scan, "dist_dot", _componentwise)
    cd, ci = ivf_scan.ivf_list_scan_topk_plain(*args, k=k, **kw)
    assert torch.equal(md, cd) and torch.equal(mi, ci)
    # ties are there to be kept in the reference's order
    fin = md[torch.isfinite(md)]
    assert fin.numel() > fin.unique().numel()


def test_plain_matches_pallas_interpret_at_the_self_search_arm():
    assert ivf_scan.binned_deep_body(I8, True, 128) == "hopper"
    k = 64
    w = _workload(917, "i8", 256, rot=128)
    jd, ji = _jax(w, "i8", k, False, True, True, "binned_deep")
    pd, pi = _port(w, "i8", k, False, True, True, "binned_deep")
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, k), pi.reshape(-1, k)
    jd, ji = jd.reshape(-1, k), ji.reshape(-1, k)
    # at rot 128 the expanded L2 form's terms (||q - c||^2 + ||x||^2) reach
    # ~700 here, and the two sides sum the dots in other orders: distances
    # near 0 inherit a few f32 ulps of those terms (6e-5 each), not of the
    # distance, hence 1e-3 absolute
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-5, atol=1e-3)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
