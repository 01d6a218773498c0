"""Kernel 2's exact and binned arms over f32 and bf16 rows (storage kinds 0
and 1, the IVF-Flat scan) on the Hopper arms' body
(raft_tpu_torch/ops/csrc/ivf_scan_arms.cuh), on the CPU.

* ``scan_body`` routes f32 and bf16 rows under bf16 operands with plain
  queries, d a multiple of 16 <= 128, k <= 64 and a cap that is a
  multiple of 128 to "hopper_exact" / "hopper_binned", and every other
  edge to the core: d 16 / 96 / 128 / 136, d off a multiple of 16, k 64 /
  65, caps off a multiple of 128, f32 operands, residual or scaled
  queries, binned_deep and fold over float rows, f16 and uint8 rows.
* ``arms_smem_bytes`` fits a block at the float kinds' widths, refuses
  what the body does not take, and keeps the header's constants.
* ``_launch`` hands the C entry the arm's code for f32 and bf16 storage,
  and the core's where the route says so (a stand-in library, no card).
* Each arm's selection emulated as the body runs it (tile by tile) is held
  bit for bit against ``ivf_list_scan_topk_plain`` over f32 and bf16 rows
  on tie-heavy small integers, and on f32 rows whose low mantissa bits
  decide their rounding to bf16 (ties to even included), whose rounding
  is also held against a bit-level round-to-nearest-even.
* The plain float arm against the reference's ``fused_list_scan_topk`` in
  interpret mode under bf16 compute, at G 256 and k up to 64 (f32 and
  bf16 rows; the reference casts its block to bf16 as the body does).
"""

import contextlib
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.ops import ivf_scan as jax_scan
from raft_tpu_torch.ops import _build, ivf_scan
from tests.test_torch_binned_deep_body import _Lib, _case
from tests.test_torch_scan_hopper_arms import _emulate_binned, _emulate_exact
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

F32, BF16 = 0, 1
F16, U8, I8, PQ4 = ivf_scan.F16, ivf_scan.U8, ivf_scan.I8, ivf_scan.PQ4
_CSRC = Path(ivf_scan.__file__).parent / "csrc"


@pytest.fixture(scope="module", autouse=True)
def _drop_jit_caches():
    """The reference's scans are traced by jit here: drop them after the
    module, so no later file meets an executable traced in this one."""
    yield
    jax.clear_caches()


@pytest.mark.parametrize("kind", [F32, BF16])
@pytest.mark.parametrize("round_ops, plain, rot, k, extract, cap, body", [
    (True, True, 16, 1, "exact", 128, "hopper_exact"),
    (True, True, 96, 10, "exact", 256, "hopper_exact"),
    (True, True, 128, 10, "exact", 1024, "hopper_exact"),
    (True, True, 128, 10, "binned", 1024, "hopper_binned"),
    (True, True, 16, 13, "binned", 256, "hopper_binned"),
    (True, True, 96, 64, "exact", 384, "hopper_exact"),
    (True, True, 96, 64, "binned", 640, "hopper_binned"),
    (True, True, 96, 65, "exact", 384, "core"),
    (True, True, 136, 10, "exact", 256, "core"),
    (True, True, 136, 10, "binned", 256, "core"),
    (True, True, 40, 10, "exact", 256, "core"),
    (True, True, 24, 10, "binned", 256, "core"),
    (True, True, 96, 10, "exact", 390, "core"),
    (True, True, 96, 10, "exact", 200, "core"),
    (False, True, 96, 10, "exact", 256, "core"),
    (False, True, 128, 10, "binned", 256, "core"),
    (True, False, 96, 10, "exact", 256, "core"),
    (True, False, 128, 10, "binned", 256, "core"),
    (True, True, 96, 30, "binned_deep", 256, "core"),
    (True, True, 96, 10, "fold", 256, "core")])
def test_float_rows_route_by_shape_and_type(kind, round_ops, plain, rot, k,
                                            extract, cap, body):
    assert ivf_scan.scan_body(kind, round_ops, rot, k, extract, cap,
                              plain) == body
    code = ivf_scan.extract_code(extract, k, body)
    want = {"hopper_exact": ivf_scan.HOPPER_EXACT,
            "hopper_binned": ivf_scan.HOPPER_BINNED}.get(body)
    if want is None:
        assert code < ivf_scan.HOPPER_DEEP
    else:
        assert code == want


@pytest.mark.parametrize("kind", [F16, U8])
@pytest.mark.parametrize("extract", ["exact", "binned"])
def test_f16_and_uint8_rows_stay_on_the_core(kind, extract):
    for rot in (16, 96, 128):
        assert ivf_scan.scan_body(kind, True, rot, 10, extract, 256,
                                  True) == "core"


@pytest.mark.parametrize("kind", [F32, BF16])
@pytest.mark.parametrize("rot", [16, 96, 128])
@pytest.mark.parametrize("extract", ["exact", "binned"])
def test_float_arms_smem_fits_a_block(kind, rot, extract):
    for k in (1, 10, 64):
        full = ivf_scan.arms_smem_bytes(kind, rot, k, extract)
        assert full <= ivf_scan.SMEM_LIMIT
        bare = ivf_scan.arms_smem_bytes(kind, rot, k, extract, norms=False,
                                        keep=False)
        assert bare <= full


@pytest.mark.parametrize("kind, rot, extract", [
    (F32, 136, "exact"), (BF16, 144, "binned"), (F32, 40, "binned"),
    (BF16, 24, "exact"), (F32, 96, "binned_deep"), (BF16, 96, "fold"),
    (F16, 96, "binned"), (U8, 96, "exact")])
def test_float_arms_smem_refuses_what_the_body_does_not_take(kind, rot,
                                                             extract):
    with pytest.raises(ValueError):
        ivf_scan.arms_smem_bytes(kind, rot, 10, extract)


def test_float_arms_smem_constants_are_the_headers():
    deep = (_CSRC / "ivf_scan_deep.cuh").read_text()
    arms = (_CSRC / "ivf_scan_arms.cuh").read_text()
    assert re.search(r"constexpr int kRowsF32 = (\d+);", deep).group(1) == \
        "3"
    assert re.search(r"constexpr int kRowsBf16 = (\d+);", deep).group(1) == \
        "4"
    assert ": rows == kRowsF32  ? DT * d * 4" in deep
    assert ": rows == kRowsBf16 ? DT * d * 2" in deep
    assert ivf_scan._FLOAT_ROWS == {F32: 4, BF16: 2}
    # the launcher maps the storage kinds to those row kinds, and stages
    # the exact arm's f32 rows as bf16 at 128 queries
    assert "storage_kind == 0   ? deep::kRowsF32" in arms
    assert "storage_kind == 1 ? deep::kRowsBf16" in arms
    assert "return rows == deep::kRowsF32 && exact && q > AQ ? " \
        "deep::kRowsBf16 : rows;" in arms
    # d 128 with norms and keep, as the arms' header states, at the block
    # arms_queries picks
    got = {(kind, ex, k): (ivf_scan.arms_queries(kind, 128, k, ex),
                           ivf_scan.arms_smem_bytes(kind, 128, k, ex))
           for kind in (F32, BF16) for ex, k in (("exact", 10),
                                                  ("exact", 64),
                                                  ("binned", 10))}
    assert got == {(F32, "exact", 10): (128, 194_560),
                   (F32, "exact", 64): (64, 224_256),
                   (F32, "binned", 10): (128, 166_912),
                   (BF16, "exact", 10): (128, 194_560),
                   (BF16, "exact", 64): (64, 158_720),
                   (BF16, "binned", 10): (64, 84_480)}
    flat = " ".join(arms.split())
    for n in ("194,560", "224,256", "166,912", "158,720", "84,480"):
        assert n in flat, n


@pytest.mark.parametrize("kind", [F32, BF16])
def test_float_arms_take_128_queries_where_the_block_fits(kind):
    """The exact arm's 128-query block fits to k 47 (its lists grow by 1
    KB a k), then 64; f32 rows' binned arm always takes 128, bf16 rows'
    64 (two blocks share an SM)."""
    for rot in (16, 96, 128):
        assert ivf_scan.arms_queries(kind, rot, 47, "exact") == 128
        assert ivf_scan.arms_queries(kind, rot, 64, "binned") == \
            (128 if kind == F32 else 64)
    assert ivf_scan.arms_queries(kind, 128, 48, "exact") == 64
    assert ivf_scan.arms_smem_bytes(kind, 128, 47, "exact") == \
        ivf_scan.SMEM_LIMIT


@pytest.mark.parametrize("kind, rot, extract, k, bf16, mode, code, body", [
    (F32, 96, "exact", 10, True, "plain", 10, "hopper_exact"),
    (F32, 128, "binned", 10, True, "plain", 11, "hopper_binned"),
    (BF16, 128, "exact", 64, True, "plain", 10, "hopper_exact"),
    (BF16, 96, "binned", 13, True, "plain", 11, "hopper_binned"),
    (F32, 96, "exact", 10, True, "residual", 0, "core"),
    (BF16, 96, "exact", 10, True, "scaled", 0, "core"),
    (F32, 96, "binned", 10, True, "per-list", 1, "core"),
    (F32, 96, "exact", 10, False, "plain", 0, "core"),
    (BF16, 40, "exact", 10, True, "plain", 0, "core"),
    (F32, 96, "binned_deep", 30, True, "plain", 2, "core"),
    (F32, 96, "exact", 65, True, "plain", 0, "core")])
def test_launch_passes_the_float_arm_code(monkeypatch, kind, rot, extract, k,
                                          bf16, mode, code, body):
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
    scale = {"scaled": 0.5,
             "per-list": torch.full(w["centers"].shape, 0.5)}.get(mode, 1.0)
    out_d, out_i = ivf_scan._launch(
        w["storage"], kind, w["indices"], w["list_sizes"],
        w["bucket_list"], w["bucket_q"], w["queries"],
        torch.ones(w["queries"].shape[0]), w["norms"], None, k, ivf_scan.L2,
        bf16, w["centers"] if mode == "residual" else None, scale, None,
        None, extract)
    (args,) = lib.ivf_list_scan_topk.calls
    assert args[1] == kind and args[25] == code and args[22] == k
    assert args[11] == (0.5 if mode == "scaled" else 1.0)
    assert (args[12] is None) == (mode != "per-list")
    w_out = 128 * 2 if extract == "fold" else k
    assert out_d.shape == out_i.shape == tuple(w["bucket_q"].shape) + (w_out,)
    assert ivf_scan.ivf_list_scan_topk.launches == 1
    want[body] = 1
    assert ivf_scan.ivf_list_scan_topk.by_body == want


# -- the arms' selection over float rows, emulated as the body runs it ---

def _rne_bf16(x: np.ndarray) -> np.ndarray:
    """f32 values rounded to bf16 by their bits, to nearest with ties to
    even, held as f32 (finite inputs)."""
    b = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    r = (b + 0x7FFF + ((b >> 16) & 1)) >> 16 << 16
    return r.astype(np.uint32).view(np.float32)


def _float_case(kind, cap, ip, seed, rounding, nonfinite=False):
    """Plain-query float rows whose every distance is exact in f32 in any
    order: queries in [-2, 2], norms and qaux small integers; rows small
    integers in [-2, 2] (tie-heavy) or, with ``rounding`` (f32 only),
    multiples of 1/16 in [-20, 20] moved by 0 or +-2^-9 where |x| >= 8, so
    that rounding to bf16 meets exact ties (to even) and values pushed off
    them, and the rounded rows are multiples of 1/16. Duplicated rows
    (with their norms), a keep filter, a list shorter than k, an empty
    list, empty query slots; with ``nonfinite`` the filtered rows are NaN
    and the list tails +inf. Returns the scan's positional and keyword
    arguments."""
    rng = np.random.default_rng(seed)
    C, nb, G, m, d = 4, 6, 24, 40, 32
    t = torch.from_numpy
    if rounding:
        x = rng.integers(-320, 321, (C, cap, d)) / 16.0
        nudge = rng.choice([0.0, 2.0 ** -9, -2.0 ** -9], x.shape)
        x = (x + np.where(np.abs(x) >= 8, nudge, 0.0)).astype(np.float32)
    else:
        x = rng.integers(-2, 3, (C, cap, d)).astype(np.float32)
    norms = rng.integers(0, 13, (C, cap)).astype(np.float32)
    for src, dst in ((3, 131), (40, 41), (7, 135)):
        if dst < cap:
            x[:, dst], norms[:, dst] = x[:, src], norms[:, src]
    sizes = np.array([cap, 5, 0, cap - 77], np.int32)
    keep = (rng.random((C, cap)) < 0.8).astype(np.int32)
    if nonfinite:
        x[keep == 0] = np.nan
        x[np.arange(cap)[None, :] >= sizes[:, None]] = np.inf
    storage = t(x) if kind == F32 else t(x).to(torch.bfloat16)
    bq = rng.integers(-1, m, (nb, G)).astype(np.int32)
    args = (storage,
            t(np.arange(C * cap, dtype=np.int32).reshape(C, cap) * 3 + 1),
            t(sizes), t(np.array([0, 1, 2, 3, 0, 3], np.int32)), t(bq),
            t(rng.integers(-2, 3, (m, d)).astype(np.float32)),
            None if ip else t(rng.integers(0, 40, m).astype(np.float32)),
            None if ip else t(norms), t(keep))
    kw = dict(metric_kind=ivf_scan.IP if ip else ivf_scan.L2,
              compute_dtype="bf16")
    return args, kw


def _float_distances(args, kw):
    """The bucket distances [nb, G, cap] the plain version selects from,
    +inf where masked, from the rows rounded by ``_rne_bf16``."""
    storage, _, sizes, bl, bq, q, qaux, norms, keep = args
    rows = torch.from_numpy(_rne_bf16(np_(storage.float()))).double()
    rows = torch.nan_to_num(rows, nan=0.0, posinf=0.0)   # all masked
    bl, bq = bl.long(), bq.long()
    qv = q.double()[bq.clamp_min(0)]                        # [nb, G, d]
    dots = qv @ rows[bl].transpose(1, 2)                    # [nb, G, cap]
    if kw["metric_kind"] == ivf_scan.IP:
        dist = -dots
    else:
        qa = qaux.double()[bq.clamp_min(0)][:, :, None]
        dist = (qa + norms.double()[bl][:, None, :] - 2 * dots).clamp_min(0)
    col = torch.arange(storage.shape[1])
    valid = (col[None, :] < sizes.long()[bl][:, None]) & (keep[bl] > 0)
    valid = valid[:, None, :] & (bq >= 0)[:, :, None]
    return torch.where(valid, dist.float(), float("inf"))


def test_rne_bf16_is_round_bf16_on_ties_and_low_bits():
    """``_rne_bf16`` (the body's cvt.rn) and the plain version's
    ``round_bf16`` agree bit for bit on exact ties, values just off them
    and random f32 values."""
    from raft_tpu_torch.utils.precision import round_bf16

    ties = np.arange(-320, 321, dtype=np.float32) / 16
    off = np.concatenate([ties + 2.0 ** -9, ties - 2.0 ** -9])
    rnd = np.random.default_rng(0).standard_normal(4096).astype(np.float32)
    x = np.concatenate([ties, off, rnd * 1e3, rnd * 1e-3]).astype(np.float32)
    got = np_(round_bf16(torch.from_numpy(x)))
    assert np.array_equal(got.view(np.uint32), _rne_bf16(x).view(np.uint32))
    # odd sixteenths in [16, 20] are exact ties: some go down to even
    tied = (np.abs(ties) >= 16) & (np.arange(641) % 2 == 1)
    assert (got[:641][tied] != ties[tied]).all()
    assert (np.abs(got[:641][tied]) < np.abs(ties[tied])).any()


@pytest.mark.parametrize("extract", ["exact", "binned"])
@pytest.mark.parametrize("kind, cap, k, ip, rounding, nonfinite", [
    (F32, 256, 10, False, False, False), (F32, 384, 64, True, False, False),
    (F32, 640, 1, False, False, False), (BF16, 384, 30, False, False, False),
    (BF16, 256, 13, True, False, False), (BF16, 640, 40, False, False, False),
    (F32, 256, 10, False, True, False), (F32, 384, 30, True, True, False),
    (F32, 640, 64, False, True, False), (F32, 384, 10, False, False, True),
    (BF16, 256, 30, True, False, True)])
def test_float_arm_emulation_matches_plain_bit_for_bit(extract, kind, cap, k,
                                                       ip, rounding,
                                                       nonfinite):
    args, kw = _float_case(kind, cap, ip, cap + k + 7 * kind + ip + rounding,
                           rounding, nonfinite)
    assert ivf_scan.scan_body(kind, True, args[5].shape[1], k, extract,
                              cap) == f"hopper_{extract}"
    pd, pi = ivf_scan.ivf_list_scan_topk_plain(*args, k=k, extract=extract,
                                               **kw)
    dist = _float_distances(args, kw)
    ids = args[1][args[3].long()]
    ed, ep = (_emulate_exact if extract == "exact" else _emulate_binned)(
        dist, k)
    ei = torch.where(torch.isinf(ed), -1,
                     ids.gather(1, ep.clamp_min(0).reshape(ids.shape[0], -1))
                     .reshape(ep.shape))
    assert torch.equal(ed, pd)
    assert torch.equal(ei.to(torch.int32), pi)
    fin = pd[torch.isfinite(pd)]
    assert fin.numel() > fin.unique().numel()
    assert bool(torch.isinf(pd).any())
    if rounding:
        # the rounding moved rows, so the unrounded rows would score others
        raw = args[0].double()
        assert not torch.equal(torch.from_numpy(_rne_bf16(np_(args[0])))
                               .double(), raw)


# -- the plain float arm against the reference, at the body's shapes -----

def _ref_case(seed, kind, cap, d, nb=3, G=256, m=300, C=4):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((C, cap, d)).astype(np.float32)
    x[:, 131] = x[:, 3]                       # a duplicate in the same bin
    x[:, 41] = x[:, 40]                       # and in the next
    if kind == BF16:
        x = np.asarray(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    bq = rng.integers(0, m, (nb, G)).astype(np.int32)
    bq[0, 200:] = -1                          # G off a multiple of 64 filled
    return dict(storage=x, ids=(np.arange(C * cap, dtype=np.int32) * 5 + 2)
                .reshape(C, cap),
                sizes=np.array([cap, 9, 0, cap - 21], np.int32)[:C],
                bl=np.array([0, 1, 3], np.int32)[:nb], bq=bq,
                q=(rng.standard_normal((m, d)) * 2).astype(np.float32),
                keep=(rng.random((C, cap)) < 0.75).astype(np.int32),
                norms=(x * x).sum(2))


@pytest.mark.parametrize("kind, extract, k, cap, d, ip, keep", [
    (F32, "exact", 10, 256, 128, False, True),
    (F32, "exact", 64, 384, 96, True, False),
    (F32, "binned", 10, 256, 128, False, False),
    (F32, "binned", 64, 384, 16, False, True),
    (BF16, "exact", 40, 256, 128, False, True),
    (BF16, "binned", 13, 384, 96, True, True)], ids=lambda v: str(v))
def test_float_arm_plain_matches_pallas_interpret(kind, extract, k, cap, d,
                                                  ip, keep):
    w = _ref_case(1900 + k + cap + d + 3 * ip + kind, kind, cap, d)
    assert ivf_scan.scan_body(kind, True, d, k, extract, cap) == \
        f"hopper_{extract}"
    qsafe = np.maximum(w["bq"], 0)
    qg = w["q"][qsafe]                                    # [nb, G, d]
    jdt = jnp.bfloat16 if kind == BF16 else jnp.float32
    jd, ji = jax_scan.fused_list_scan_topk(
        jnp.asarray(w["storage"], jdt), jnp.asarray(w["ids"]),
        jnp.asarray(w["sizes"]), jnp.asarray(w["bl"]),
        jnp.asarray(qg).astype(jnp.bfloat16),
        None if ip else jnp.asarray((qg * qg).sum(2)),
        None if ip else jnp.asarray(w["norms"]),
        jnp.asarray(w["keep"]) if keep else None, k=k,
        metric_kind=jax_scan.IP if ip else jax_scan.L2, approx=True,
        recall_target=0.0, extract=extract, interpret=True)
    t = torch.from_numpy
    tdt = torch.bfloat16 if kind == BF16 else torch.float32
    pd, pi = ivf_scan.ivf_list_scan_topk(
        t(w["storage"]).to(tdt), t(w["ids"]), t(w["sizes"]), t(w["bl"]),
        t(w["bq"]), t(w["q"]), None if ip else t((w["q"] ** 2).sum(1)),
        None if ip else t(w["norms"]), t(w["keep"]) if keep else None, k=k,
        metric_kind=ivf_scan.IP if ip else ivf_scan.L2,
        compute_dtype="bf16", extract=extract)
    valid = (w["bq"] >= 0).reshape(-1)
    pd, pi = np_(pd).reshape(-1, k), np_(pi).reshape(-1, k)
    jd, ji = np_(jd).reshape(-1, k), np_(ji).reshape(-1, k)
    # (a recall target of 0 admits binned at any k <= 64, as the port's
    # structural rule does.) The two sum the products in other orders: the
    # expanded L2 form's
    # terms reach ~10^3 at d 128 (as the arms' other plain tests)
    assert_topk_match(pd[valid], pi[valid], jd[valid], ji[valid], k,
                      rtol=1e-5, atol=1e-3)
    assert (pi[~valid] == -1).all() and np.isinf(pd[~valid]).all()
