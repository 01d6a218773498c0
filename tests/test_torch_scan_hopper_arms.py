"""Kernel 2's exact and binned arms over int8, i4 and sign-bit rows and
their Hopper body (raft_tpu_torch/ops/csrc/ivf_scan_arms.cuh), on the CPU.

* ``scan_body`` is a pure function of (kind, round_ops, rot, k, extract,
  cap): a table over every boundary (rot 16 / 128 / 144, int8 rot off a
  multiple of 16, k 64 / 65, caps off a multiple of 128, f32 operands,
  every other storage kind, the fold arm; f32 and bf16 rows, which take
  the body too since it learnt them, at every edge in
  ``test_torch_scan_float_arms``), and ``extract_code`` gives each
  (arm, body) its own code; ``_launch`` hands the C entry the body's code
  and counts the launch under that body (a stand-in library, no card).
* ``arms_smem_bytes``: the block stays within a block's 232,448 B at the
  paths' widths, refuses what the body does not take, and its constants
  are the header's.
* Each arm's selection emulated as the body runs it, tile by tile (exact:
  buffer what is strictly under the k-th distance of the tile before,
  merge by (distance, position); binned: a strict ``<`` per bin, then the
  k smallest slots by (distance, position)), bit for bit against
  ``ivf_list_scan_topk_plain`` on tie-heavy small integers with +inf rows
  (the keep filter), lists shorter than k, an empty list and empty slots.
* The plain versions of both arms over the three row kinds against the
  reference's ``fused_list_scan_topk`` in interpret mode, at the body's
  shapes (rot a multiple of 16, bf16 operands, k up to 64), cases that
  ``test_torch_ivf_scan_binned`` / ``_i8`` / ``_packed`` do not already
  hold.
"""

import contextlib
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from raft_tpu_torch.neighbors.common import merge_topk
from raft_tpu_torch.ops import _build, ivf_scan
from tests.test_torch_binned_deep_body import _Lib, _case
from tests.test_torch_ivf_scan_binned import _jax, _port, _workload
from tests.torch_parity import assert_topk_match, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

I8, I4, BITS, PQ4 = ivf_scan.I8, ivf_scan.I4, ivf_scan.BITS, ivf_scan.PQ4
F16, U8 = ivf_scan.F16, ivf_scan.U8
_HEADER = Path(ivf_scan.__file__).parent / "csrc" / "ivf_scan_arms.cuh"


@pytest.fixture(scope="module", autouse=True)
def _drop_jit_caches():
    """The reference's scans are traced by jit here: drop them after the
    module, so no later file meets an executable traced in this one."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kind, round_ops, rot, k, extract, cap, body", [
    (I8, True, 96, 10, "exact", 256, "hopper_exact"),
    (I8, True, 96, 10, "binned", 256, "hopper_binned"),
    (I8, True, 96, 30, "binned_deep", 256, "hopper"),
    (I8, True, 16, 1, "exact", 128, "hopper_exact"),
    (I8, True, 128, 64, "exact", 384, "hopper_exact"),
    (I8, True, 128, 64, "binned", 640, "hopper_binned"),
    (I8, True, 128, 65, "exact", 384, "core"),
    (I8, True, 128, 65, "binned_deep", 384, "hopper"),
    (I8, True, 144, 10, "exact", 256, "core"),
    (I8, True, 144, 10, "binned", 256, "core"),
    (I8, True, 40, 10, "exact", 256, "core"),
    (I8, True, 40, 10, "binned", 256, "core"),
    (I8, True, 96, 10, "exact", 390, "core"),
    (I8, True, 96, 10, "exact", 200, "core"),
    (I8, False, 96, 10, "exact", 256, "core"),
    (I8, False, 96, 10, "binned", 256, "core"),
    (I8, True, 96, 10, "fold", 256, "core"),
    (I4, True, 96, 10, "exact", 256, "hopper_exact"),
    (I4, True, 40, 13, "binned", 384, "hopper_binned"),
    (I4, True, 128, 64, "exact", 640, "hopper_exact"),
    (I4, True, 136, 10, "exact", 256, "core"),
    (I4, True, 96, 65, "exact", 256, "core"),
    (I4, False, 96, 10, "binned", 256, "core"),
    (I4, True, 96, 10, "exact", 300, "core"),
    (BITS, True, 96, 40, "exact", 256, "hopper_exact"),
    (BITS, True, 128, 10, "binned", 256, "hopper_binned"),
    (BITS, True, 160, 40, "exact", 256, "core"),
    (BITS, True, 96, 65, "exact", 256, "core"),
    (BITS, False, 96, 40, "exact", 256, "core"),
    (BITS, True, 96, 10, "fold", 256, "core"),
    (0, True, 96, 10, "exact", 256, "hopper_exact"),
    (1, True, 128, 10, "binned", 256, "hopper_binned"),
    (F16, True, 96, 10, "exact", 256, "core"),
    (U8, True, 96, 10, "binned", 256, "core"),
    (PQ4, True, 96, 10, "exact", 256, "core"),
    (PQ4, True, 96, 10, "binned", 256, "core")])
def test_scan_body_routes_by_shape_and_type(kind, round_ops, rot, k, extract,
                                            cap, body):
    assert ivf_scan.scan_body(kind, round_ops, rot, k, extract, cap) == body
    code = ivf_scan.extract_code(extract, k, body)
    want = {"hopper_exact": ivf_scan.HOPPER_EXACT,
            "hopper_binned": ivf_scan.HOPPER_BINNED,
            "hopper": ivf_scan.HOPPER_DEEP}.get(body)
    if want is None:
        assert code < ivf_scan.HOPPER_DEEP
    else:
        assert code == want


def test_extract_codes_are_distinct():
    codes = {}
    for body, extracts in (("core", ("exact", "binned", "binned_deep")),
                           ("hopper", ("binned_deep",)),
                           ("hopper_exact", ("exact",)),
                           ("hopper_binned", ("binned",)),
                           ("pq4_hopper", ("exact", "binned",
                                           "binned_deep"))):
        for ex in extracts:
            codes[(body, ex)] = ivf_scan.extract_code(ex, 10, body)
    for k in (10, 130, 200):
        codes[("core", f"fold {k}")] = ivf_scan.extract_code("fold", k)
    assert len(set(codes.values())) == len(codes), codes
    src = _HEADER.read_text()
    assert re.search(r"kExactHopper = (\d+);", src).group(1) == \
        str(ivf_scan.HOPPER_EXACT)
    assert re.search(r"kBinnedHopper = (\d+);", src).group(1) == \
        str(ivf_scan.HOPPER_BINNED)


@pytest.mark.parametrize("kind", [I8, I4, BITS])
@pytest.mark.parametrize("rot", [96, 128])
@pytest.mark.parametrize("extract", ["exact", "binned"])
def test_arms_smem_fits_a_block(kind, rot, extract):
    full = ivf_scan.arms_smem_bytes(kind, rot, 64, extract, norms=True,
                                    keep=True, row_scale=kind == BITS)
    assert full <= ivf_scan.SMEM_LIMIT
    bare = ivf_scan.arms_smem_bytes(kind, rot, 64, extract, norms=False,
                                    keep=False)
    # binned's slots (48 KB at the front) may outweigh a small ring
    assert bare <= full
    if extract == "exact":
        assert bare < full


@pytest.mark.parametrize("kind, rot, extract", [
    (F16, 96, "exact"), (PQ4, 96, "binned"), (I8, 96, "binned_deep"),
    (I4, 96, "fold")])
def test_arms_smem_refuses_what_the_body_does_not_take(kind, rot, extract):
    with pytest.raises(ValueError):
        ivf_scan.arms_smem_bytes(kind, rot, 10, extract)


def test_arms_smem_constants_are_the_headers():
    src = _HEADER.read_text()
    assert re.search(r"constexpr int KA = (\d+);", src).group(1) == \
        str(ivf_scan.ARMS_K_MAX)
    # at q queries a block (64 for these rows, arms_queries)
    assert "scan + (size_t)q * AT * 5 + (size_t)q * 8 + (size_t)q * k * 8;" \
        in src
    assert ivf_scan._ARMS_BUFFER == 64 * 128 * 5 + 64 * 8
    assert "const size_t slots = (size_t)q * AT * 6;" in src
    assert "return q / 16 * ks * 32 * 16;" in src
    assert all(ivf_scan.arms_queries(kind, 128, k, ex) == 64
               for kind in (I8, I4, BITS) for k in (1, 64)
               for ex in ("exact", "binned"))
    # int8 at rot 128 with norms and keep, as the header states
    assert ivf_scan.arms_smem_bytes(I8, 128, 10, "exact") == 98_304
    assert ivf_scan.arms_smem_bytes(I8, 128, 64, "exact") == 125_952
    assert ivf_scan.arms_smem_bytes(I8, 128, 10, "binned") == 51_712


@pytest.mark.parametrize("kind, rot, extract, k, bf16, code, body", [
    (I8, 96, "exact", 30, True, 10, "hopper_exact"),
    (I8, 128, "binned", 10, True, 11, "hopper_binned"),
    (I8, 96, "exact", 30, False, 0, "core"),
    (I8, 96, "exact", 100, True, 0, "core"),
    (I4, 96, "binned", 13, True, 11, "hopper_binned"),
    (BITS, 96, "exact", 40, True, 10, "hopper_exact"),
    (BITS, 96, "binned_deep", 40, True, 6, "hopper"),
    (0, 96, "exact", 30, True, 0, "core")])
def test_launch_passes_the_arm_code(monkeypatch, kind, rot, extract, k, bf16,
                                    code, body):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "launches", 0)
    want = {"core": 0, "hopper": 0, "hopper_exact": 0, "hopper_binned": 0,
            "pq4_hopper": 0}
    monkeypatch.setattr(ivf_scan.ivf_list_scan_topk, "by_body", dict(want))
    w = _case(kind, rot)
    rows_scale = torch.ones(w["indices"].shape) if kind == BITS else None
    out_d, out_i = ivf_scan._launch(
        w["storage"], kind, w["indices"], w["list_sizes"],
        w["bucket_list"], w["bucket_q"], w["queries"], None, w["norms"],
        None, k, ivf_scan.L2, bf16, w["centers"], 1.0, None, rows_scale,
        extract)
    (args,) = lib.ivf_list_scan_topk.calls
    assert args[1] == kind and args[25] == code and args[22] == k
    assert out_d.shape == out_i.shape == tuple(w["bucket_q"].shape) + (k,)
    assert ivf_scan.ivf_list_scan_topk.launches == 1
    want[body] = 1
    assert ivf_scan.ivf_list_scan_topk.by_body == want


# -- the arms' selection, emulated as the body runs it ------------------

def _tie_case(kind, cap, ip, seed):
    """Tie-heavy small integers, every distance exact in f32 in any order:
    queries, centers and rows in [-2, 2] (int8) or the packed words' own
    [-8, 7] and +-1, norms in [0, 12]; duplicated rows (equal distances
    in one bin and the next); a keep filter (+inf rows), a list shorter
    than k, an empty list, and empty query slots. Returns the scan's
    positional and keyword arguments."""
    rng = np.random.default_rng(seed)
    C, nb, G, m, rot = 4, 6, 24, 40, 32
    t = torch.from_numpy
    if kind == I8:
        storage = rng.integers(-2, 3, (C, cap, rot)).astype(np.int8)
        storage[:, 131] = storage[:, 3]
        storage[:, 41] = storage[:, 40]
    else:
        nw = rot // 8 if kind == I4 else rot // 32
        # few distinct words, so that rows repeat
        pool = rng.integers(-2 ** 31, 2 ** 31 - 1, (5, nw), dtype=np.int64)
        storage = pool[rng.integers(0, 5, (C, cap))].transpose(0, 2, 1)
        storage = storage.astype(np.int32)
    norms = rng.integers(0, 13, (C, cap)).astype(np.float32)
    sizes = np.array([cap, 5, 0, cap - 77], np.int32)
    bq = rng.integers(-1, m, (nb, G)).astype(np.int32)
    args = (t(storage), t(np.arange(C * cap, dtype=np.int32).reshape(C, cap)
                          * 3 + 1),
            t(sizes), t(np.array([0, 1, 2, 3, 0, 3], np.int32)), t(bq),
            t(rng.integers(-2, 3, (m, rot)).astype(np.float32)), None,
            None if ip else t(norms),
            t((rng.random((C, cap)) < 0.8).astype(np.int32)))
    kw = dict(metric_kind=ivf_scan.IP if ip else ivf_scan.L2,
              compute_dtype="bf16", packed_i4=kind == I4,
              packed_bits=kind == BITS)
    if not ip:
        kw["centers"] = t(rng.integers(-1, 2, (C, rot)).astype(np.float32))
    return args, kw


def _distances(args, kw):
    """The bucket distances [nb, G, cap] the plain version selects from,
    +inf where masked (every term a small integer, so exact)."""
    storage, _, sizes, bl, bq, q, _, norms, keep = args
    kind = ivf_scan.storage_kind(storage, kw["packed_i4"], kw["packed_bits"])
    bl, bq = bl.long(), bq.long()
    if kind == I8:
        rows = storage.double()
    else:
        rows = ivf_scan.unpack_fields(
            storage.transpose(1, 2), q.shape[1], 4 if kind == I4 else 1,
            signed=kind == I4).double()
        if kind == BITS:
            rows = 2 * rows - 1
    qv = q.double()[bq.clamp_min(0)]                        # [nb, G, d]
    if "centers" in kw:
        qv = qv - kw["centers"].double()[bl][:, None, :]
    dots = qv @ rows[bl].transpose(1, 2)                    # [nb, G, cap]
    if kw["metric_kind"] == ivf_scan.IP:
        dist = -dots
    else:
        qa = (qv * qv).sum(2, keepdim=True)
        dist = (qa + norms.double()[bl][:, None, :] - 2 * dots).clamp_min(0)
    cap = storage.shape[1] if kind == I8 else storage.shape[2]
    col = torch.arange(cap)
    valid = (col[None, :] < sizes.long()[bl][:, None]) & (keep[bl] > 0)
    valid = valid[:, None, :] & (bq >= 0)[:, :, None]
    return torch.where(valid, dist.float(), float("inf"))


def _sort_by_distance_position(d, p):
    """Rows of (distance, position) sorted by distance, then position."""
    by_p = torch.sort(p, dim=-1, stable=True).indices
    d, p = d.gather(-1, by_p), p.gather(-1, by_p)
    by_d = torch.sort(d, dim=-1, stable=True).indices
    return d.gather(-1, by_d), p.gather(-1, by_d)


def _emulate_exact(dist, k):
    """The body's exact arm: 128-row tiles in order; each buffers the
    candidates strictly under its query's k-th distance as of the tile
    before, merged with the list by (distance, position)."""
    nb, G, cap = dist.shape
    ld = torch.full((nb, G, k), float("inf"))
    lp = torch.full((nb, G, k), -1, dtype=torch.long)
    for r0 in range(0, cap, 128):
        d = dist[:, :, r0:r0 + 128]
        p = torch.arange(r0, r0 + d.shape[2]).expand(nb, G, -1)
        buf = d < ld[:, :, k - 1:k]
        cd = torch.where(buf, d, float("inf"))
        cp = torch.where(buf, p, torch.iinfo(torch.long).max)
        ld, lp = _sort_by_distance_position(torch.cat([ld, cd], -1),
                                            torch.cat([lp, cp], -1))
        ld, lp = ld[..., :k], lp[..., :k]
    return ld, lp


def _emulate_binned(dist, k):
    """The body's binned arm: each (query, bin)'s best by a strict ``<``
    tile after tile (the lowest position among equals), then the k
    smallest slots by (distance, position); an unfilled slot holds chunk
    0, position = its bin."""
    nb, G, cap = dist.shape
    bd = torch.full((nb, G, 128), float("inf"))
    bp = torch.arange(128).expand(nb, G, 128).clone()
    for r0 in range(0, cap, 128):
        d = dist[:, :, r0:r0 + 128]
        upd = d < bd
        bd = torch.where(upd, d, bd)
        bp = torch.where(upd, torch.arange(r0, r0 + 128), bp)
    sd, sp = _sort_by_distance_position(bd, bp)
    return sd[..., :k], sp[..., :k]


@pytest.mark.parametrize("extract", ["exact", "binned"])
@pytest.mark.parametrize("kind, cap, k, ip", [
    (I8, 256, 10, False), (I8, 384, 64, True), (I8, 640, 1, False),
    (I4, 384, 30, False), (I4, 256, 13, True),
    (BITS, 640, 40, False), (BITS, 256, 64, True)])
def test_arm_emulation_matches_plain_bit_for_bit(extract, kind, cap, k, ip):
    args, kw = _tie_case(kind, cap, ip, seed=cap + k + 7 * kind + ip)
    assert ivf_scan.scan_body(kind, True, args[5].shape[1], k, extract,
                              cap) == f"hopper_{extract}"
    pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, k=k, extract=extract,
                                               **kw)
    dist = _distances(args, kw)
    # the plain version selects from these very distances
    ids = args[1][args[3].long()]
    if extract == "exact":
        md, mi = merge_topk(dist, ids[:, None, :].expand(dist.shape), k,
                            select_min=True)
        assert torch.equal(md, pd)
        assert torch.equal(torch.where(torch.isinf(md), -1, mi), pi)
    ed, ep = (_emulate_exact if extract == "exact" else _emulate_binned)(
        dist, k)
    ei = torch.where(torch.isinf(ed), -1,
                     ids.gather(1, ep.clamp_min(0).reshape(ids.shape[0], -1))
                     .reshape(ep.shape))
    assert torch.equal(ed, pd)
    assert torch.equal(ei.to(torch.int32), pi)
    # ties, +inf rows and short lists are there to be met
    fin = pd[torch.isfinite(pd)]
    assert fin.numel() > fin.unique().numel()
    assert bool(torch.isinf(pd).any())


# -- the plain versions against the reference ---------------------------

@pytest.mark.parametrize("arm, extract, k, cap, ip, keep, rot", [
    ("i8", "exact", 30, 256, False, True, 96),
    ("i8", "exact", 64, 384, True, False, 128),
    ("i8", "binned", 13, 384, True, True, 96),
    ("i4", "exact", 40, 256, False, False, 96),
    ("i4", "binned", 1, 256, False, True, 128),
    ("bits", "exact", 40, 384, False, True, 96),
    ("bits", "binned", 10, 256, True, False, 128),
], ids=lambda v: str(v))
def test_arm_plain_matches_pallas_interpret(arm, extract, k, cap, ip, keep,
                                            rot):
    seed = 900 + 7 * k + cap + 3 * ip + ("i8", "i4", "bits").index(arm)
    w = _workload(seed, arm, cap, rot=rot)
    kind = {"i8": I8, "i4": I4, "bits": BITS}[arm]
    assert ivf_scan.scan_body(kind, True, -(-rot // 32) * 32 if arm == "bits"
                              else rot, k, extract, cap) == \
        f"hopper_{extract}"
    jd, ji = _jax(w, arm, k, ip, True, keep, extract)
    pd, pi = _port(w, arm, k, ip, True, keep, extract)
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = pd.reshape(-1, k), pi.reshape(-1, k)
    jd, ji = jd.reshape(-1, k), ji.reshape(-1, k)
    # the two sum the products in other orders: the expanded L2 form's
    # terms reach ~10^3 at rot 128, so 1e-3 absolute (as the binned_deep
    # body's plain test)
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-5, atol=1e-3)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
