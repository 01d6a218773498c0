"""Kernel 1's fold arm and its Hopper body
(raft_tpu_torch/ops/csrc/fused_fold_hopper.cuh), on the CPU.

* ``fold_body`` routes bf16 queries with d a multiple of 16 whose block
  fits and tiles of at most 2048 rows to the Hopper body, and everything
  else (f32 queries, other widths, wider tiles) to the core's kFold2..4;
  ``_launch`` calls the body's C entry with the fold's geometry (a
  stand-in library records the call; no card) and counts it under
  "fold_hopper".
* ``fold_smem_bytes`` and the routing constants are the header's.
* The body's formulation emulated: exact bf16 products summed 16 a k-step
  into an f32 sum truncated toward zero, as the tensor cores may sum
  them. On small integers (every partial sum exact) its distances are the
  plain version's bit for bit; on random rows they stay within
  ``chip_smoke.fold_atol`` of them.
* The plain fold buffer against the reference's ``fold_lane_stacks`` on
  tie-heavy small-integer distances: stacks equal bit for bit, ties
  included (the strict-`<` cascade keeps the earlier chunk).
"""

import contextlib
import importlib
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATOL, fold_atol, scan_tolerance
from raft_tpu_torch.ops import _build, fused_topk
from raft_tpu_torch.utils.precision import round_bf16
from tests.test_torch_binned_deep_body import _Fn
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")

# the module, which its function of the same name shadows in the package
jax_ft = importlib.import_module("raft_tpu.ops.fused_topk")

_HEADER = Path(fused_topk.__file__).parent / "csrc" / "fused_fold_hopper.cuh"
BF16, F32 = torch.bfloat16, torch.float32


@pytest.mark.parametrize("qdtype, d, tile_n, k, body", [
    (BF16, 128, 2048, 42, "fold_hopper"),
    (BF16, 96, 512, 10, "fold_hopper"),
    (BF16, 16, 256, 200, "fold_hopper"),
    (BF16, 288, 2048, 42, "fold_hopper"),
    (BF16, 304, 2048, 42, "core"),
    (BF16, 352, 2048, 130, "fold_hopper"),
    (BF16, 368, 2048, 256, "core"),
    (BF16, 40, 2048, 42, "core"),
    (BF16, 128, 4096, 42, "core"),
    (F32, 128, 2048, 42, "core"),
    (torch.float16, 128, 2048, 42, "core")])
def test_fold_body_routes_by_type_width_and_tile(qdtype, d, tile_n, k, body):
    assert fused_topk.fold_body(qdtype, d, tile_n, k) == body


def test_fold_smem_constants_are_the_headers():
    src = _HEADER.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);",
                             src).group(1))

    assert const("FC") == fused_topk._FOLDH_C
    assert const("FS") == fused_topk._FOLDH_STAGES
    assert const("MAX_CHUNKS") * 128 == fused_topk._FOLDH_MAX_TILE
    assert "SIDE = 2 * FC * 4;" in src
    assert "return R == 2 ? 2 : 1;" in src
    assert ("(size_t)(block_queries(R) + FS * FC) * d * 2 + "
            "(size_t)FS * SIDE") in src
    # 128 queries a block at R = 2 (k <= 128), 64 at R = 3 and 4
    assert [fused_topk.fold_block_queries(k) for k in (10, 128, 129, 256)] \
        == [128, 128, 64, 64]
    # the fast path's block: 128 queries, two 128-row chunks and their
    # norms and keep flags at d = 128
    assert fused_topk.fold_smem_bytes(128, 42) == 100_352
    assert fused_topk.fold_smem_bytes(288, 42) <= fused_topk.SMEM_LIMIT < \
        fused_topk.fold_smem_bytes(304, 42)
    assert fused_topk.fold_smem_bytes(352, 200) <= fused_topk.SMEM_LIMIT < \
        fused_topk.fold_smem_bytes(368, 200)


class _Lib:
    """Stands in for kernel 1's library."""

    def __init__(self):
        self.fused_knn_topk = _Fn()
        self.fused_knn_fold_hopper = _Fn()
        self.rtt_error_string = _Fn(b"stand-in")


@pytest.mark.parametrize("qdtype, xdtype, d, k, tile_n, keep, body", [
    (BF16, BF16, 128, 42, 2048, False, "fold_hopper"),
    (BF16, F32, 64, 130, 1024, True, "fold_hopper"),
    (BF16, BF16, 48, 200, 512, False, "fold_hopper"),
    (F32, BF16, 128, 42, 2048, False, "core"),
    (BF16, BF16, 40, 42, 2048, False, "core")])
def test_launch_takes_the_fold_body(monkeypatch, qdtype, xdtype, d, k,
                                    tile_n, keep, body):
    lib = _Lib()
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0}))
    monkeypatch.setattr(fused_topk.fused_knn_topk, "launches", 0)
    monkeypatch.setattr(fused_topk.fused_knn_topk, "by_body",
                        {"core": 0, "fold_hopper": 0})
    rng = np.random.default_rng(d + k)
    m, n = 70, 3 * tile_n + 37
    q = torch.from_numpy(rng.standard_normal((m, d)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((n, d)).astype(np.float32))
    kp = torch.from_numpy((rng.random(n) < 0.7).astype(np.int32)) \
        if keep else None
    out_d, out_i = fused_topk._launch(q.to(qdtype), x.to(xdtype), k,
                                      fused_topk.L2, None, None, kp, "fold",
                                      tile_n)
    R = fused_topk.fold_depth(k)
    n_tiles = -(-n // tile_n)
    assert out_d.shape == out_i.shape == (m, n_tiles * 128 * R)
    if body == "fold_hopper":
        (args,) = lib.fused_knn_fold_hopper.calls
        assert not lib.fused_knn_topk.calls
        # m, n, d, tile_n, n_tiles, metric, fold_r; bf16 rows flagged
        assert args[6:13] == (m, n, d, tile_n, n_tiles, fused_topk.L2, R)
        assert args[3] == int(xdtype == BF16)
        assert (args[5] is None) == (not keep)
    else:
        (args,) = lib.fused_knn_topk.calls
        assert not lib.fused_knn_fold_hopper.calls
        assert args[10:15] == (tile_n, n_tiles, fused_topk.L2,
                               int(qdtype == BF16), R)
    want = {"core": 0, "fold_hopper": 0}
    want[body] = 1
    assert fused_topk.fused_knn_topk.launches == 1
    assert fused_topk.fused_knn_topk.by_body == want


def _body_dots(q, x):
    """The Hopper body's dots emulated: bf16 operands, their exact
    products summed 16 components at a time (exact in f64) and each group
    added to an f32 sum rounded toward zero."""
    qb = round_bf16(q.float()).double()
    xb = round_bf16(x.float()).double()
    acc = torch.zeros((q.shape[0], x.shape[0]), dtype=torch.float32)
    for c0 in range(0, q.shape[1], 16):
        t = acc.double() + qb[:, c0:c0 + 16] @ xb[:, c0:c0 + 16].T
        f = t.float()
        over = f.double().abs() > t.abs()
        acc = torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)
    return acc


def _distances(q, x, metric_kind, dots):
    qf = q.float()
    xb = round_bf16(x.float())
    qa = (qf * qf).sum(1)
    if metric_kind == fused_topk.COSINE:
        qa = qa.sqrt()
    xn = (xb * xb).sum(1)
    return fused_topk._epilogue(dots, metric_kind, qa[:, None], xn[None, :])


@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP,
                                         fused_topk.COSINE],
                         ids=["l2", "ip", "cosine"])
def test_body_arithmetic_within_fold_atol(metric_kind):
    rng = np.random.default_rng(5 + metric_kind)
    m, n, d = 40, 300, 128
    # small integers: every partial sum exact, so bit for bit
    qi = torch.from_numpy(rng.integers(-6, 7, (m, d)).astype(np.float32))
    xi = torch.from_numpy(rng.integers(-6, 7, (n, d)).astype(np.float32))
    plain = fused_topk._distance_blocks(qi.to(BF16), xi.to(BF16),
                                        metric_kind, None, None)(0, n)
    body = _distances(qi, xi, metric_kind, _body_dots(qi, xi))
    assert torch.equal(plain, body)
    # SIFT-like magnitudes and normal rows: within the stated tolerance
    for q, x in ((rng.uniform(0, 255, (m, d)), rng.uniform(0, 255, (n, d))),
                 (rng.standard_normal((m, d)), rng.standard_normal((n, d)))):
        q = torch.from_numpy(q.astype(np.float32)).to(BF16)
        x = torch.from_numpy(x.astype(np.float32)).to(BF16)
        plain = fused_topk._distance_blocks(q, x, metric_kind, None,
                                            None)(0, n)
        body = _distances(q, x, metric_kind, _body_dots(q, x))
        atol = fold_atol((q, x, 10), {"metric_kind": metric_kind})
        assert atol.shape == (m,) and bool((atol >= ATOL).all())
        diff = (plain - body).abs()
        assert bool((diff <= atol[:, None] + 1e-4 * plain.abs()).all())
    tol = scan_tolerance("fold_hopper", (q, x, 10),
                         {"metric_kind": metric_kind})
    assert tol["join"] and tol["hidden"]
    assert torch.equal(tol["atol"], atol)
    assert scan_tolerance("core", (q, x, 10), {}) == {"atol": ATOL}


@pytest.mark.parametrize("R", [2, 3, 4])
def test_plain_fold_matches_reference_lane_stacks_on_ties(R):
    """Distances drawn from {0, ..., 4} and +inf over 12 chunks: most
    newcomers tie a slot, so the stacks show the cascade's tie rule."""
    rng = np.random.default_rng(R)
    G, T = 6, 12 * 128
    dist = rng.integers(0, 5, (G, T)).astype(np.float32)
    dist[rng.random((G, T)) < 0.1] = np.inf
    ids = np.broadcast_to(np.arange(T, dtype=np.int32), (G, T)).copy()
    jd, ji = jax_ft.fold_lane_stacks(jnp.asarray(dist), jnp.asarray(ids), R)
    pd, pi = fused_topk.fold_lane_stacks(torch.from_numpy(dist),
                                         torch.from_numpy(ids), R)
    assert pd.shape == (G, R, 128)
    for r in range(R):
        np.testing.assert_array_equal(np_(pd[:, r]), np.asarray(jd[r]))
        np.testing.assert_array_equal(np_(pi[:, r]), np.asarray(ji[r]))


@pytest.mark.parametrize("metric_kind", [fused_topk.L2, fused_topk.IP],
                         ids=["l2", "ip"])
def test_plain_fold_buffer_on_the_bodys_shapes(metric_kind):
    """The plain fold at a shape the Hopper body takes (bf16, d = 32, R =
    2, two tiles of 256, a ragged end, a keep filter) on tie-heavy small
    integers, against the reference's kernel in interpret mode: buffers
    equal bit for bit."""
    rng = np.random.default_rng(9)
    m, n, d, k, tile = 20, 2 * 256 + 77, 32, 10, 256
    q = rng.integers(-2, 3, (m, d)).astype(np.float32)
    x = rng.integers(-2, 3, (n, d)).astype(np.float32)
    norms = None if metric_kind == fused_topk.IP else (x * x).sum(1)
    assert fused_topk.fold_body(BF16, d, tile, k) == "fold_hopper"
    jd, ji = jax_ft._fused_topk_tiles(
        jnp.asarray(q, jnp.bfloat16), jnp.asarray(x, jnp.bfloat16),
        None if norms is None else jnp.asarray(norms), None, k=k,
        metric_kind=metric_kind, variant="fold", tile_q=32, tile_n=tile,
        interpret=True)
    pd, pi = fused_topk.fused_knn_fold(
        torch.from_numpy(q).to(BF16), torch.from_numpy(x).to(BF16), k,
        metric_kind=metric_kind,
        norms=None if norms is None else torch.from_numpy(norms),
        tile_n=tile)
    np.testing.assert_array_equal(np_(pd), np.asarray(jd)[:m])
    np.testing.assert_array_equal(np_(pi), np.asarray(ji)[:m])
