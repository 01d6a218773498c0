"""Kernel 1's exact arm and its Hopper body
(raft_tpu_torch/ops/csrc/fused_exact_hopper.cuh), on the CPU.

* ``exact_body`` routes f32 or bf16 queries over f32 or bf16 rows with d
  a multiple of 16 up to 128 and k <= 64 to the Hopper body, everything
  else (other types, widths, k) to the core's kExact; ``_launch`` calls the
  body's C entry with the launch's geometry (a stand-in library records
  the call; no card) and counts it under "exact_hopper".
* ``exact_smem_bytes``, ``exact_block_queries`` and the routing constants
  are the header's; ``exact_chunk_rows`` fills the card's SMs.
* The body emulated: its f32 route's 3xTF32 dots (hi = tf32(v), lo =
  tf32(v - hi) rounded to nearest away from zero, the tensor cores' sums
  truncated toward zero, each 16 dims' sum added to the dot at round to
  nearest) and its selection (64-row tiles in chunks, a distance buffered
  where strictly under the query's k-th distance of the tile before,
  lists by (distance, row), the chunks merged by ``merge_topk``). On
  small integers the whole emulated body is its plain version bit for
  bit, ties included; on SIFT-like f32 rows (the smoke's recipe, made with
  numpy from a seed) its distances stay within compare's 1e-4 + 1e-4
  relative of the plain version's and ids agree on tie-free keys.
* The plain exact arm at a shape the body takes against the reference's
  ``fused_topk(variant="exact", interpret=True)``.
"""

import contextlib
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATOL, RTOL, exact_atol, fold_atol, scan_tolerance
from raft_tpu_torch.neighbors.common import merge_topk
from raft_tpu_torch.ops import _build, fused_topk
from tests.test_torch_binned_deep_body import _Fn
from tests.torch_parity import assert_topk_match, np_, torch_threads  # noqa: F401,E501

pytestmark = pytest.mark.usefixtures("torch_threads")

# the module, which its function of the same name shadows in the package
jax_ft = importlib.import_module("raft_tpu.ops.fused_topk")

_HEADER = Path(fused_topk.__file__).parent / "csrc" / "fused_exact_hopper.cuh"
BF16, F32, F16 = torch.bfloat16, torch.float32, torch.float16


@pytest.mark.parametrize("qdtype, xdtype, d, k, body", [
    (F32, F32, 128, 10, "exact_hopper"),
    (F32, BF16, 96, 64, "exact_hopper"),
    (BF16, BF16, 128, 42, "exact_hopper"),
    (BF16, F32, 16, 1, "exact_hopper"),
    (F32, F32, 112, 33, "exact_hopper"),
    (F32, F32, 128, 65, "core"),
    (BF16, BF16, 128, 256, "core"),
    (F32, F32, 136, 10, "core"),
    (F32, F32, 40, 10, "core"),
    (F32, F32, 8, 10, "core"),
    (F16, F32, 128, 10, "core"),
    (F32, F16, 128, 10, "core"),
    (F32, torch.uint8, 128, 10, "core")])
def test_exact_body_routes_by_type_width_and_k(qdtype, xdtype, d, k, body):
    assert fused_topk.exact_body(qdtype, xdtype, d, k) == body


def test_exact_smem_constants_are_the_headers():
    src = _HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("ET") == fused_topk._EXH_T
    assert const("ENS") == fused_topk._EXH_STAGES
    assert const("EKA") == fused_topk._EXH_KMAX
    assert const("EDMAX") == fused_topk._EXH_DMAX
    assert const("SMEM_LIMIT") == fused_topk.SMEM_LIMIT
    assert "SIDE = 2 * ET * 4;" in src
    assert "STATIC_BYTES = 2 * ENS * 8;" in src
    assert fused_topk._EXH_STATIC == 2 * fused_topk._EXH_STAGES * 8
    assert "if (x_bf16) return 2 * d + (d % 32 == 0 ? 32 : 0);" in src
    assert ("return (size_t)q * d * (bf16_ops ? 2 : 4) +\n"
            "         (size_t)ns * (ET * row_bytes(bf16_ops, x_bf16, d) + "
            "SIDE) +\n"
            "         (size_t)q * ET * 5 + (size_t)q * 4 + "
            "(size_t)q * k * 8;") in src
    # the header's numbers at d 128, k 10: six stages under bf16 operands,
    # three for the f32 oracle
    assert fused_topk.exact_ring_stages(True, True, 128, 10, 128) == 6
    assert fused_topk.exact_ring_stages(True, True, 128, 64, 128) == 5
    assert fused_topk.exact_ring_stages(False, False, 128, 10, 128) == 3
    assert fused_topk.exact_ring_stages(False, False, 128, 42, 128) == 2
    assert fused_topk.exact_smem_bytes(True, True, 128, 10, 128, 6) == \
        185_856
    assert fused_topk.exact_smem_bytes(False, False, 128, 10, 128, 3) == \
        217_088
    assert "185,856 B (bf16, 6 stages) and 217,088 B (f32, 3)" in src
    # 128 queries a block except f32 rows under f32 queries past k 57
    assert [fused_topk.exact_block_queries(False, False, 128, k)
            for k in (1, 42, 57, 58, 64)] == [128, 128, 128, 64, 64]
    for bf16_ops, x_bf16 in ((True, True), (True, False), (False, True)):
        assert fused_topk.exact_block_queries(bf16_ops, x_bf16, 128,
                                              64) == 128
    assert fused_topk.exact_smem_bytes(False, False, 128, 64, 64, 2) <= \
        fused_topk.SMEM_LIMIT
    # bf16 rows under f32 operands: a stride of 8 words mod 32
    for d in range(16, 129, 16):
        words = fused_topk.exact_row_bytes(False, True, d) // 4
        assert words % 16 == 8


@pytest.mark.parametrize("m, n, sms, chunks", [
    (1000, 1_000_000, 132, 16),      # the recall oracle: 8 x 16 = 128
    (10_000, 1_000_000, 132, 5),     # the fast path's: 79 x 5 = 395
    (70, 3000, 132, 5),              # at least 8 tiles a chunk
    (70, 300, 132, 1)])
def test_exact_chunk_rows_fill_the_sms(m, n, sms, chunks):
    rows = fused_topk.exact_chunk_rows(m, n, 128, sms)
    assert rows % 64 == 0
    assert -(-n // rows) == chunks


class _Lib:
    """Stands in for kernel 1's library."""

    def __init__(self):
        self.fused_knn_topk = _Fn()
        self.fused_knn_fold_hopper = _Fn()
        self.fused_knn_exact_hopper = _Fn()
        self.rtt_error_string = _Fn(b"stand-in")


@pytest.mark.parametrize("qdtype, xdtype, d, k, keep, metric, body", [
    (F32, F32, 128, 10, False, fused_topk.L2, "exact_hopper"),
    (F32, BF16, 96, 64, True, fused_topk.COSINE, "exact_hopper"),
    (BF16, BF16, 128, 42, True, fused_topk.L2, "exact_hopper"),
    (BF16, F32, 64, 33, False, fused_topk.IP, "exact_hopper"),
    (F32, F32, 128, 64, False, fused_topk.L2, "exact_hopper"),
    (F32, F32, 40, 10, False, fused_topk.L2, "core"),
    (F32, F32, 128, 100, True, fused_topk.IP, "core")])
def test_launch_takes_the_exact_body(monkeypatch, qdtype, xdtype, d, k, keep,
                                     metric, body):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(
        torch.cuda, "get_device_properties",
        lambda dev: type("P", (), {"multi_processor_count": 132}))
    monkeypatch.setattr(fused_topk.fused_knn_topk, "launches", 0)
    monkeypatch.setattr(fused_topk.fused_knn_topk, "by_body",
                        {"core": 0, "fold_hopper": 0, "exact_hopper": 0})
    rng = np.random.default_rng(d + k)
    m, n = 300, 20_000
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    kp = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32)) \
        if keep else None
    out_d, out_i = fused_topk._launch(q.to(qdtype), x.to(xdtype), k, metric,
                                      None, None, kp, "exact")
    bf16 = qdtype == BF16
    if body == "exact_hopper":
        (args,) = lib.fused_knn_exact_hopper.calls
        assert not lib.fused_knn_topk.calls
        bq = fused_topk.exact_block_queries(bf16, xdtype == BF16, d, k)
        ns = fused_topk.exact_ring_stages(bf16, xdtype == BF16, d, k, bq)
        rows = fused_topk.exact_chunk_rows(m, n, bq, 132)
        n_chunks = -(-n // rows)
        # m, n, d, k, chunk_rows, n_chunks, metric, bf16 operands, block_q,
        # stages; the keys start at all ones
        assert args[6:16] == (m, n, d, k, rows, n_chunks, metric, int(bf16),
                              bq, ns)
        assert args[16] is not None
        assert args[3] == int(xdtype == BF16)
        assert (args[5] is None) == (not keep)
        assert (args[4] is None) == (metric == fused_topk.IP)
    else:
        (args,) = lib.fused_knn_topk.calls
        assert not lib.fused_knn_exact_hopper.calls
        assert args[13:15] == (int(bf16), 0)      # round_ops, fold_r
        n_chunks = args[11]
    assert out_d.shape == out_i.shape == (m, n_chunks * k)
    want = {"core": 0, "fold_hopper": 0, "exact_hopper": 0}
    want[body] = 1
    assert fused_topk.fused_knn_topk.launches == 1
    assert fused_topk.fused_knn_topk.by_body == want


def _sift_like(n, d, seed, intrinsic=16):
    """chip_smoke.sift_like's recipe in numpy: rows near a 16-dim manifold
    around 64 with a spread of 24, noise of 2, clipped to [0, 255]."""
    proj = np.random.default_rng(12345).standard_normal(
        (intrinsic, d)) / intrinsic ** 0.5
    rng = np.random.default_rng(seed)
    z = 24.0 * rng.standard_normal((n, intrinsic))
    x = 64.0 + z @ proj + 2.0 * rng.standard_normal((n, d))
    return torch.from_numpy(np.clip(x, 0.0, 255.0).astype(np.float32))


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32: the nearest value with 10 fraction bits, ties
    away from zero (on the magnitude's bits)."""
    bits = v.float().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _rz(t: torch.Tensor) -> torch.Tensor:
    """f64 sums to f32, truncated toward zero, as the tensor cores may."""
    f = t.float()
    over = f.double().abs() > t.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _body_dots_f32(q, x):
    """The f32 route's dots emulated: 3xTF32 products (lo.hi of both
    k-steps, hi.lo of both, then hi.hi of both; a 16-dim group's k-step s
    holds dims 16 g + 4 t + 2 s + {0, 1} for t < 4) into a fresh
    truncating sum, each group's sum added to the dot at round to
    nearest."""
    q, x = q.float(), x.float()
    qh, xh = _tf32(q), _tf32(x)
    ql, xl = _tf32(q - qh), _tf32(x - xh)
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    for g in range(q.shape[1] // 16):
        steps = [[16 * g + 4 * t + 2 * s + e for t in range(4)
                  for e in range(2)] for s in range(2)]
        tmp = torch.zeros_like(acc)
        for a, b in ((ql, xh), (qh, xl), (qh, xh)):
            for c in steps:
                tmp = _rz(tmp.double() + a[:, c].double() @ b[:, c].double().T)
        acc = acc + tmp
    return acc


def _body_topk(dist, k, chunk_rows, tile):
    """The body's selection emulated over a full distance matrix [m, n]
    (+inf where filtered out): per chunk of rows, tile after tile, a
    distance enters where strictly under the query's k-th distance of the
    tile before, lists kept by (distance, row); the chunks' lists merged
    by ``merge_topk``."""
    m, n = dist.shape
    cols = torch.arange(n, dtype=torch.int32)
    out_d, out_i = [], []
    for c0 in range(0, n, chunk_rows):
        ld = torch.full((m, k), float("inf"))
        li = torch.full((m, k), -1, dtype=torch.int32)
        for t0 in range(c0, min(n, c0 + chunk_rows), tile):
            t1 = min(n, t0 + tile, c0 + chunk_rows)
            td = dist[:, t0:t1]
            cand = torch.where(td < ld[:, -1:], td, float("inf"))
            d2 = torch.cat([ld, cand], 1)
            i2 = torch.cat([li, cols[t0:t1].expand(m, -1)], 1)
            # by (distance, row): rows ascend along the concatenation
            order = torch.sort(d2, dim=1, stable=True).indices[:, :k]
            ld, li = d2.gather(1, order), i2.gather(1, order)
            li = torch.where(torch.isinf(ld), -1, li)
        out_d.append(ld)
        out_i.append(li)
    return merge_topk(torch.cat(out_d, 1), torch.cat(out_i, 1), k,
                      select_min=True)


def _emulated(q, x, k, metric_kind, keep=None, chunk_rows=None):
    """The whole f32 route emulated: dots, the plain version's epilogue
    (the kernel's operations), the filter and the selection."""
    qa = fused_topk._aux(q.float(), metric_kind, None)
    xn = fused_topk._norms(x, metric_kind, False, None)
    dist = fused_topk._epilogue(
        _body_dots_f32(q, x), metric_kind,
        None if qa is None else qa[:, None],
        None if xn is None else xn[None, :])
    if keep is not None:
        dist = torch.where(keep[None, :] > 0, dist, float("inf"))
    rows = chunk_rows or fused_topk.exact_chunk_rows(q.shape[0],
                                                     x.shape[0], 128, 132)
    return _body_topk(dist, k, rows, fused_topk._EXH_T)


@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP,
                                         fused_topk.COSINE],
                         ids=["l2", "ip", "cosine"])
@pytest.mark.parametrize("k", [1, 10, 33, 64])
def test_body_on_small_integers_is_the_plain_version(metric_kind, k):
    """Small integers: every product and partial sum exact and every lo
    0, so the emulated body equals the plain version bit for bit, ties
    (many: values in [-3, 3]) included, across chunks and a ragged end."""
    rng = np.random.default_rng(k + 7 * metric_kind)
    m, n, d = 24, 700, 48
    q = torch.from_numpy(rng.integers(-3, 4, (m, d)).astype(np.float32))
    x = torch.from_numpy(rng.integers(-3, 4, (n, d)).astype(np.float32))
    keep = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32))
    assert fused_topk.exact_body(F32, F32, d, k) == "exact_hopper"
    for kp in (None, keep):
        pd, pi = fused_topk.fused_knn_topk(q, x, k, metric_kind=metric_kind,
                                           keep=kp)
        bd, bi = _emulated(q, x, k, metric_kind, kp, chunk_rows=192)
        assert torch.equal(bd, pd) and torch.equal(bi, pi)


@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP,
                                         fused_topk.COSINE],
                         ids=["l2", "ip", "cosine"])
def test_body_arithmetic_within_compares_tolerance(metric_kind):
    """SIFT-like f32 rows: the emulated 3xTF32 distances within 1e-4 +
    1e-4 relative of the plain version's (under L2 and cosine every pair,
    not only the top k; an inner product near 0 carries its terms'
    rounding, in any order, so there the top k, as compare holds it), and
    the emulated body's top k equal the plain version's within that
    tolerance, ids on tie-free keys."""
    q = _sift_like(40, 128, seed=2)
    x = _sift_like(2000, 128, seed=1)
    if metric_kind != fused_topk.L2:
        q, x = q - 64.0, x - 64.0
    qa = fused_topk._aux(q, metric_kind, None)
    xn = fused_topk._norms(x, metric_kind, False, None)
    body = fused_topk._epilogue(
        _body_dots_f32(q, x), metric_kind,
        None if qa is None else qa[:, None],
        None if xn is None else xn[None, :])
    plain = fused_topk._distance_blocks(q, x, metric_kind, None,
                                        None)(0, x.shape[0])
    assert exact_atol((q, x, 10), {"metric_kind": metric_kind}) == ATOL
    diff = (body - plain).abs()
    if metric_kind != fused_topk.IP:
        assert bool((diff <= ATOL + RTOL * plain.abs()).all())
    bd, bi = _emulated(q, x, 10, metric_kind, chunk_rows=640)
    pd, pi = fused_topk.fused_knn_topk(q, x, 10, metric_kind=metric_kind)
    assert_topk_match(bd, bi, pd, pi, 10)


def test_split_recovers_f32_and_bf16_rows_need_no_lo():
    """hi + lo carries ~22 bits of an f32 value; a bf16 value is its own
    hi (its lo is 0, so two products suffice)."""
    rng = np.random.default_rng(3)
    v = torch.from_numpy(rng.standard_normal(10_000).astype(np.float32))
    hi = _tf32(v)
    lo = _tf32(v - hi)
    rel = ((hi.double() + lo.double() - v.double()).abs()
           / v.double().abs()).max()
    assert float(rel) <= 2.0 ** -21
    b = v.to(BF16).float()
    assert torch.equal(_tf32(b), b)
    assert torch.equal(_tf32(b - _tf32(b)), torch.zeros_like(b))


def test_exact_tolerance_by_route():
    """The f32 route is held at compare's ATOL (no looser), the bf16
    route at fold_atol, its arithmetic being the fold body's; both under
    the join rule (a near-tie with the row past the k-th is unseen in the
    plain row)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(rng.uniform(0, 255, (30, 64)).astype(np.float32))
    x = torch.from_numpy(rng.uniform(0, 255, (500, 64)).astype(np.float32))
    kw = {"metric_kind": fused_topk.L2}
    assert scan_tolerance("exact_hopper", (q, x, 10), kw) == {
        "atol": ATOL, "join": True}
    tol = scan_tolerance("exact_hopper", (q.to(BF16), x, 42), kw)
    assert tol["join"]
    assert torch.equal(tol["atol"], fold_atol((q.to(BF16), x, 42), kw))


@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP],
                         ids=["l2", "ip"])
@pytest.mark.parametrize("dtype", [F32, BF16], ids=["f32", "bf16"])
def test_plain_exact_matches_reference_interpreted(metric_kind, dtype):
    """The plain exact arm at a shape the Hopper body takes (d 32, k 42,
    a ragged end) against the reference's kernel in interpret mode:
    distances within tolerance, ids equal on tie-free keys."""
    rng = np.random.default_rng(11)
    m, n, d, k = 20, 2 * 256 + 77, 32, 42
    q = rng.standard_normal((m, d)).astype(np.float32)
    x = rng.standard_normal((n, d)).astype(np.float32)
    norms = None if metric_kind == fused_topk.IP else \
        np_(fused_topk._norms(torch.from_numpy(x).to(dtype), metric_kind,
                              dtype == BF16, None))
    jdt = jnp.bfloat16 if dtype == BF16 else jnp.float32
    assert fused_topk.exact_body(dtype, dtype, d, k) == "exact_hopper"
    jd, ji = jax_ft.fused_topk(
        jnp.asarray(q, jdt), jnp.asarray(x, jdt),
        k, metric_kind=metric_kind,
        norms=None if norms is None else jnp.asarray(norms),
        variant="exact", tile_q=32, tile_n=256, interpret=True)
    pd, pi = fused_topk.fused_knn_topk(
        torch.from_numpy(q).to(dtype), torch.from_numpy(x).to(dtype), k,
        metric_kind=metric_kind,
        norms=None if norms is None else torch.from_numpy(norms))
    assert_topk_match(pd, pi, np.asarray(jd), np.asarray(ji), k)
