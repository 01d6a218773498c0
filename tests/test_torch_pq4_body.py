"""Kernel 2's pq4 arm and its Hopper body
(raft_tpu_torch/ops/csrc/ivf_scan_pq4.cuh), on the CPU.

* ``pq4_body`` routes bf16 operands at the exact, binned and binned_deep
  arms to the Hopper body where its block fits, and everything else (f32
  operands, the fold arms, wider tables) to the core's pq4 kernel;
  ``_launch`` hands the C entry that body's extract code (a stand-in
  library records the call; no card) and counts it under "pq4_hopper".
* ``pq4_smem_bytes``: the block fits at the DEEP-10M shape (p = 96) on
  every arm and refuses what does not fit; its constants are the
  header's.
* The body's formulation emulated: one-hot codes in bf16 times the bf16
  tables, one subspace a step, f32 sums in subspace order. Rounded to
  nearest it is ``_pq4_dots`` bit for bit; truncated at each step as the
  tensor cores may truncate, it is still bit for bit on small-integer
  tables (every partial sum exact) and within ``chip_smoke.pq4_atol``
  on random ones.
* The pq4 rung's searches that take the body on the card (the default at
  k = 10, binned; exact at k = 10; the default at k = 30, binned_deep)
  run the plain version here, against the reference's kernel in
  interpret mode on its own index carried across. Tolerance: distances
  1e-4 relative plus 1e-4 absolute, ids equal outside near-ties
  (tests/torch_parity.py).
"""

import contextlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ATOL, pq4_atol
from raft_tpu.neighbors import ivf_pq as jax_pq
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.ops import _build, ivf_scan
from tests.test_torch_binned_deep_body import _Lib
from tests.test_torch_ivf_pq_rungs import _carry, _manifold
from tests.torch_parity import assert_topk_match, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

PQ4 = ivf_scan.PQ4
_HEADER = Path(ivf_scan.__file__).parent / "csrc" / "ivf_scan_pq4.cuh"


@pytest.mark.parametrize("round_ops, p, pl, k, extract, body", [
    (True, 96, 1, 10, "exact", "hopper"),
    (True, 96, 1, 10, "binned", "hopper"),
    (True, 96, 1, 30, "binned_deep", "hopper"),
    (True, 96, 1, 256, "exact", "hopper"),
    (True, 48, 2, 64, "binned", "hopper"),
    (True, 24, 4, 1, "binned_deep", "hopper"),
    (True, 128, 1, 10, "exact", "core"),
    (True, 128, 1, 64, "exact", "hopper"),
    (True, 128, 1, 10, "binned", "hopper"),
    (True, 128, 1, 30, "binned_deep", "core"),
    (True, 128, 1, 256, "exact", "core"),
    (True, 256, 1, 10, "exact", "core"),
    (True, 96, 1, 10, "fold", "core"),
    (False, 96, 1, 10, "exact", "core"),
    (False, 96, 1, 30, "binned_deep", "core"),
    (False, 24, 1, 10, "binned", "core")])
def test_pq4_body_routes_by_type_arm_and_budget(round_ops, p, pl, k, extract,
                                                body):
    assert ivf_scan.pq4_body(round_ops, p, pl, k, extract) == body
    code = ivf_scan.extract_code(
        extract, k, "pq4_hopper" if body == "hopper" else "core")
    if body == "hopper":
        assert code == ivf_scan.PQ4_HOPPER + ivf_scan.EXTRACTS[extract]
    else:
        assert code < ivf_scan.HOPPER_DEEP


@pytest.mark.parametrize("extract, k, want", [
    ("exact", 10, 193_024), ("exact", 32, 193_024), ("exact", 33, 168_960),
    ("exact", 256, 226_048), ("binned", 10, 151_808),
    ("binned_deep", 30, 225_536)])
def test_pq4_smem_fits_at_the_deep10m_shape(extract, k, want):
    # p = 96: 98,304 B of tables, two stages of (12 + 2) x 1,024 B; the
    # exact arm's candidate buffer at k <= 32, its distance tile and lists
    # past it
    assert ivf_scan.pq4_smem_bytes(96, k, extract) == want
    assert want <= ivf_scan.SMEM_LIMIT
    assert ivf_scan.pq4_smem_bytes(96, k, extract, norms=False,
                                   keep=False) == want - 2 * 2 * 1024


@pytest.mark.parametrize("p, k, extract", [
    (128, 30, "binned_deep"), (128, 256, "exact"), (256, 10, "exact"),
    (96, 10, "fold")])
def test_pq4_smem_refuses_what_does_not_fit(p, k, extract):
    with pytest.raises(ValueError):
        ivf_scan.pq4_smem_bytes(p, k, extract)


def test_pq4_smem_constants_are_the_headers():
    src = _HEADER.read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    assert int(const("kPq4Hopper")) == ivf_scan.PQ4_HOPPER
    assert int(const("HQ")) == ivf_scan._PQ4_Q
    assert const("HT") == "2 * NBINS" and ivf_scan._PQ4_T == 2 * 128
    assert int(const("HNS")) == ivf_scan._PQ4_STAGES
    assert const("DIST_LD") == "HT + 4" and ivf_scan._PQ4_DIST_LD == 260
    assert "k <= 32 ? (size_t)HQ * HT * 8 + HQ * 8" in src
    assert "STATIC_BYTES = HQ * 8;" in src and ivf_scan._PQ4_STATIC == 256


def _case(p, pl, cap=384, C=3, nb=4, G=40, m=50, seed=0, small=False):
    """Random pq4 storage with its sidecars, as the wrapper takes them;
    ``small``: small-integer queries, centers and codebook (every table
    entry and partial sum exact in f32 and bf16)."""
    rng = np.random.default_rng(seed)
    t = torch.from_numpy
    nw = -(-p // 8)
    d = p * pl
    if small:
        queries = rng.integers(-6, 7, (m, d)).astype(np.float32)
        centers = rng.integers(-3, 4, (C, d)).astype(np.float32)
        books = rng.integers(-3, 4, (p, 16, pl)).astype(np.float32)
    else:
        queries = (rng.standard_normal((m, d)) * 20).astype(np.float32)
        centers = rng.standard_normal((C, d)).astype(np.float32)
        # entries over four decades, so that partial sums are often not
        # exact in f32
        books = (rng.standard_normal((p, 16, pl))
                 * 10.0 ** rng.uniform(-3, 1, (p, 16, 1))).astype(np.float32)
    words = rng.integers(-2 ** 31, 2 ** 31 - 1, (C, nw, cap), dtype=np.int64)
    return dict(
        storage=t(words.astype(np.int32)),
        indices=t(np.arange(C * cap, dtype=np.int32).reshape(C, cap)),
        list_sizes=t(np.array([cap, cap - 37, 0][:C], np.int32)),
        bucket_list=t(np.arange(nb, dtype=np.int32) % C),
        bucket_q=t(rng.integers(-1, m, (nb, G)).astype(np.int32)),
        queries=t(queries),
        norms=t(rng.uniform(1, 2, (C, cap)).astype(np.float32)),
        centers=t(centers), pq_centers=t(books))


@pytest.mark.parametrize("bf16, p, pl, k, extract, code, body", [
    (True, 96, 1, 10, "exact", 7, "pq4_hopper"),
    (True, 96, 1, 10, "binned", 8, "pq4_hopper"),
    (True, 96, 1, 30, "binned_deep", 9, "pq4_hopper"),
    (True, 48, 2, 64, "binned_deep", 9, "pq4_hopper"),
    (True, 96, 1, 10, "fold", 3, "core"),
    (False, 96, 1, 10, "exact", 0, "core"),
    (False, 96, 1, 30, "binned_deep", 2, "core"),
    (True, 128, 1, 30, "binned_deep", 2, "core")])
def test_launch_passes_the_pq4_body_extract_code(monkeypatch, bf16, p, pl, k,
                                                 extract, code, body):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "launches", 0)
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "by_body",
                        {"core": 0, "hopper": 0, "pq4_hopper": 0})
    w = _case(p, pl)
    out_d, out_i = ivf_scan._launch(
        w["storage"], PQ4, w["indices"], w["list_sizes"], w["bucket_list"],
        w["bucket_q"], w["queries"], None, w["norms"], None, k, ivf_scan.L2,
        bf16, w["centers"], 1.0, w["pq_centers"], None, extract)
    (args,) = lib.ivf_list_scan_topk.calls
    assert args[1] == PQ4 and args[25] == code
    assert (args[16], args[17], args[18], args[19]) == (p * pl, -(-p // 8),
                                                        p, pl)
    width = ivf_scan.out_width(k, extract)
    assert out_d.shape == out_i.shape == tuple(w["bucket_q"].shape) + (width,)
    assert ivf_scan.ivf_list_scan_topk.launches == 1
    want = {"core": 0, "hopper": 0, "pq4_hopper": 0}
    want[body] = 1
    assert ivf_scan.ivf_list_scan_topk.by_body == want


def _add_rz(a, b):
    """a + b in f32 rounded toward zero (each sum of two f32 values is
    exact in f64)."""
    s = a.double() + b.double()
    f = s.float()
    over = f.double().abs() > s.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _onehot_dots(qv, codes, pq_centers, truncate):
    """The Hopper body's dots emulated [bb, G, cap]: the tables as
    ``_pq4_dots`` builds them (bf16), the codes one-hot in bf16, each
    subspace's product (one nonzero term a sum, so exact) added to an f32
    sum in subspace order, rounded to nearest or, with ``truncate``,
    toward zero."""
    bb, G, _ = qv.shape
    p, _, pl = pq_centers.shape
    pqc = ivf_scan.round_bf16(pq_centers.float())
    q4 = qv.reshape(bb, G, p, 1, pl)
    lut = torch.zeros((bb, G, p, 16))
    for j in range(pl):
        lut = lut + q4[..., j] * pqc[:, :, j]
    lut = lut.to(torch.bfloat16)
    onehot = (codes[..., None] == torch.arange(16)).to(torch.bfloat16)
    acc = torch.zeros((bb, G, codes.shape[1]))
    for s in range(p):
        step = torch.einsum("bgv,bcv->bgc", lut[:, :, s].float(),
                            onehot[:, :, s].float())
        acc = _add_rz(acc, step) if truncate else acc + step
    return acc


@pytest.mark.parametrize("p, pl, small", [
    (24, 1, True), (48, 2, True), (96, 1, True), (24, 1, False),
    (48, 2, False), (96, 1, False)])
def test_onehot_contraction_matches_pq4_dots(p, pl, small):
    w = _case(p, pl, cap=64, C=2, nb=3, G=6, m=10, seed=p + pl,
              small=small)
    bl, bq = w["bucket_list"].long(), w["bucket_q"].long()
    qv = ivf_scan.round_bf16(w["queries"][bq.clamp_min(0)]
                             - w["centers"][bl][:, None, :])
    codes = ivf_scan.unpack_fields(w["storage"][bl].transpose(1, 2), p, 4)
    plain = ivf_scan._pq4_dots(qv, codes, w["pq_centers"], True)
    assert torch.equal(_onehot_dots(qv, codes, w["pq_centers"], False),
                       plain)
    trunc = _onehot_dots(qv, codes, w["pq_centers"], True)
    if small:
        assert torch.equal(trunc, plain)
        return
    # the truncating sum differs from the plain one, within the bound the
    # card is held to (a distance's bound, 2 dots, less ATOL, per row)
    assert not torch.equal(trunc, plain)
    args = (w["storage"], w["indices"], w["list_sizes"], w["bucket_list"],
            w["bucket_q"], w["queries"], None, w["norms"])
    kw = dict(pq_centers=w["pq_centers"], centers=w["centers"])
    bound = ((pq4_atol(args, kw) - ATOL) / 2).reshape(bq.shape)[..., None]
    assert bool(((trunc - plain).abs() <= bound).all())


def _tolerance_case(extract):
    w = _case(48, 2, cap=64, C=2, nb=3, G=6, m=10)
    args = (w["storage"], w["indices"], w["list_sizes"], w["bucket_list"],
            w["bucket_q"], w["queries"], None, w["norms"])
    kw = dict(pq_centers=w["pq_centers"], centers=w["centers"], k=10,
              metric_kind=ivf_scan.L2, extract=extract)
    return args, kw


def _assert_tolerance(got, want_atol, join, hidden):
    if isinstance(want_atol, torch.Tensor):
        assert torch.equal(got["atol"], want_atol)
    else:
        assert got["atol"] == want_atol
    assert got.get("join", False) is join
    assert got.get("hidden", False) is hidden


@pytest.mark.parametrize("body, extract, join, hidden", [
    ("core", "exact", False, False),
    ("core", "binned", False, False),
    ("hopper", "binned_deep", True, False),
    ("hopper_exact", "exact", True, False),
    ("hopper_binned", "binned", True, True),
    ("pq4_hopper", "exact", True, False),
    ("pq4_hopper", "binned", True, True),
    ("pq4_hopper", "binned_deep", True, True)])
def test_scan_tolerance_by_body(body, extract, join, hidden):
    """The smoke's and the A/B tool's comparisons take one table
    (``chip_smoke.scan_tolerance``): each body's tolerance, join rule and
    hidden rule."""
    from raft_tpu_torch.tools import kernel_ab

    args, kw = _tolerance_case(extract)
    want = {"core": lambda a, k: ATOL, "hopper": chip_smoke.deep_atol,
            "hopper_exact": chip_smoke.deep_atol,
            "hopper_binned": chip_smoke.deep_atol,
            "pq4_hopper": pq4_atol}[body](args, kw)
    _assert_tolerance(chip_smoke.scan_tolerance(body, args, kw), want, join,
                      hidden)
    _assert_tolerance(kernel_ab._tolerance(chip_smoke, body, args, kw), want,
                      join, hidden)


@pytest.mark.parametrize("body, join", [("core", False), ("hopper", True)])
def test_tolerance_of_a_checkout_without_the_table(body, join):
    """A checkout older than ``scan_tolerance`` has the core and the
    binned_deep Hopper body: ATOL, and deep_atol under the join rule."""
    from raft_tpu_torch.tools import kernel_ab

    args, kw = _tolerance_case("binned_deep")
    older = type("Older", (), dict(
        ATOL=ATOL, deep_atol=staticmethod(chip_smoke.deep_atol)))
    want = chip_smoke.deep_atol(args, kw) if join else ATOL
    _assert_tolerance(kernel_ab._tolerance(older, body, args, kw), want,
                      join, False)


@pytest.fixture(scope="module")
def pq4_index():
    """A reference pq4 index (pq_dim = dim = 24 at 4 bits, the rung's
    shape at CPU size) with lists of a 512-row capacity, so the binned
    arms are eligible, and the port's copy of it."""
    x, q = _manifold(23, 3000, 24, 60)
    jix = jax_pq.build(jax_pq.IndexParams(
        n_lists=8, kmeans_n_iters=8, pq_dim=24, pq_bits=4,
        cache_dtype="pq4"), x)
    cap = jix.indices.shape[1]
    assert jix.cache_kind == "pq4" and cap % 128 == 0 and cap > 128
    return jix, _carry(jix), q


@pytest.mark.parametrize("k, target, arm", [
    (10, 0.95, "binned"), (10, 1.0, "exact"), (30, 0.95, "binned_deep")])
def test_pq4_searches_match_pallas_interpret(pq4_index, k, target, arm):
    jix, pix, q = pq4_index
    cap = pix.indices.shape[1]
    # the arm the search resolves, and the body it takes on the card
    assert ivf_scan.pick_extract(k, cap, target < 1.0, target) == arm
    assert ivf_scan.pq4_body(True, 24, 1, k, arm) == "hopper"
    sp = dict(n_probes=4, local_recall_target=target)
    jd, ji = jax_pq.search(jax_pq.SearchParams(
        scan_impl="pallas_interpret", **sp), jix, q, k)
    pd, pi = ivf_pq.search(ivf_pq.SearchParams(
        scan_impl="pallas_interpret", **sp), pix, torch.from_numpy(q), k)
    assert_topk_match(pd, pi, jd, ji, k)
