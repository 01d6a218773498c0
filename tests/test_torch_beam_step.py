"""The port's CAGRA beam step (raft_tpu_torch.ops.beam_step) against the
JAX Pallas kernel in interpret mode.

The port keeps per-query state row-major [m, L]; the reference's is
[L, m], so outputs are compared after transposing. Both arms are compared
exactly — buffers, explored flags and parents — on tie-free inputs:

* pre-scored arm: distance == id (ties only between copies of one id, the
  windowed dedup's invariant), as the reference's own tests do;
* packed arm: the scaled query holds powers of two, so every byte product
  is exact in bf16 and every sum exact in f32 — whatever order the
  reference's one-hot matmul adds in — and the scores agree bit for bit.

With a general query the scores agree to rounding only: the port rounds
each byte product to bf16 as the TPU does and as the reference's XLA
mirror of the scoring does here (to 1e-5 relative), while the reference
kernel in interpret mode on the CPU keeps the products unrounded (XLA's
excess precision for bf16), so against it the gap is bounded by one bf16
rounding of each product.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.analysis.contract_drivers import _packed_score_xla
from raft_tpu.ops.beam_step import beam_merge_step as jax_step
from raft_tpu_torch.neighbors import cagra
from raft_tpu_torch.ops import beam_step
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _t(a):
    """numpy [X, m] (reference layout) -> torch [m, X]."""
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).T))


def _assert_same(port_outs, ref_outs):
    assert len(port_outs) == len(ref_outs)
    for p, r in zip(port_outs, ref_outs):
        np.testing.assert_array_equal(np_(p), np.asarray(r).T)


def _sorted_buffer(rng, L, m, ids):
    bd = rng.standard_normal((L, m)).astype(np.float32) + 10.0
    be = (rng.random((L, m)) < 0.5).astype(np.int32)
    order = np.argsort(bd, axis=0)
    return (np.take_along_axis(bd, order, 0), ids,
            np.take_along_axis(be, order, 0))


@pytest.mark.parametrize("L,C,m,width,window", [
    (16, 32, 128, 4, 3),        # the contract's base case, window 3
    (12, 20, 100, 3, 2),        # off powers of two and off the lane tile
])
def test_prescored_arm_matches_pallas_interpret(L, C, m, width, window):
    rng = np.random.default_rng(L * C + window)
    bi = rng.permutation(4 * (L + C) * m)[:L * m].reshape(L, m)
    bi = bi.astype(np.int32)
    be = (rng.random((L, m)) < 0.5).astype(np.int32)
    ci = rng.permutation(np.arange(4 * (L + C) * m, 8 * (L + C) * m))
    ci = ci[:C * m].reshape(C, m).astype(np.int32)
    for c in range(m):                    # copies of buffer ids
        nd = max(1, min(C // 4, L))
        ci[rng.choice(C, nd, replace=False), c] = \
            bi[rng.choice(L, nd, replace=False), c]
    ci[rng.random((C, m)) < 0.05] = -1    # empty slots
    bd, cd = bi.astype(np.float32), ci.astype(np.float32)
    order = np.argsort(bd, axis=0, kind="stable")
    bd, bi, be = (np.take_along_axis(a, order, 0) for a in (bd, bi, be))
    ref = jax_step(jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(be),
                   cand_d=jnp.asarray(cd), cand_i=jnp.asarray(ci),
                   width=width, window=window, interpret=True)
    port = beam_step.beam_merge_step(_t(bd), _t(bi), _t(be), cand_d=_t(cd),
                                     cand_i=_t(ci), width=width,
                                     window=window)
    _assert_same(port, ref)


def _packed_case(seed, deg, d, m, width, ip, exact=True, n=400):
    """Packed rows (the port's packer, which agrees with the reference's
    word for word: test_torch_cagra), a scaled query, parents."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    graph = rng.integers(0, n, (n, deg)).astype(np.int32)
    graph[rng.random((n, deg)) < 0.05] = -1            # unfilled slots
    metric = "inner_product" if ip else "sqeuclidean"
    idx = cagra.from_graph(x, graph, metric, device="cpu")
    if exact:
        qs = (rng.choice([-4, -2, -1, 0, 1, 2, 4], (m, d))
              * 2.0 ** -6).astype(np.float32)
    else:
        q = rng.standard_normal((m, d)).astype(np.float32)
        qs = q * (1.0 if ip else 2.0) * idx.code_scale
    qs = np.array(jnp.asarray(qs, jnp.bfloat16).astype(jnp.float32))
    parents = rng.integers(0, n, (width, m)).astype(np.int32)
    parents[rng.random((width, m)) < 0.1] = -1          # masked blocks
    return np_(idx.nbr_pack), np_(idx.flat_codes), qs, parents


def _qrep(qs, deg, d):
    m = qs.shape[0]
    q = jnp.asarray(qs, jnp.bfloat16)
    return jnp.tile(jnp.transpose(q.reshape(m, d // 4, 4), (0, 2, 1)),
                    (1, 1, deg))


@pytest.mark.parametrize("deg,d,L,m,width,ip,emit", [
    (8, 32, 8, 90, 3, True, False),         # m off the lane tile
    (16, 64, 16, 128, 4, False, True),      # emitted candidates
])
def test_packed_arm_matches_pallas_interpret(deg, d, L, m, width, ip, emit):
    table, _, qs, parents = _packed_case(deg + d + L + m, deg, d, m, width,
                                         ip)
    rng = np.random.default_rng(m)
    bd, bi, be = _sorted_buffer(
        rng, L, m, rng.integers(0, 400, (L, m)).astype(np.int32))
    pack = jnp.asarray(table[np.maximum(parents.T, 0)])
    ref = jax_step(jnp.asarray(bd), jnp.asarray(bi), jnp.asarray(be),
                   qrep=_qrep(qs, deg, d), pack=pack,
                   parents=jnp.asarray(parents), deg=deg, d=d, width=width,
                   ip=ip, interpret=True, emit_cands=emit)
    port = beam_step.beam_merge_step(
        _t(bd), _t(bi), _t(be),
        qs=torch.from_numpy(qs).to(torch.bfloat16),
        nbr_pack=torch.from_numpy(table), parents=_t(parents), deg=deg, d=d,
        width=width, ip=ip, emit_cands=emit)
    _assert_same(port, ref)
    assert beam_step.beam_merge_step.launches == 0     # CPU: plain version


def test_packed_score_plain_matches_reference_scoring():
    deg, d, ip = 16, 64, False
    m, width = 64, 3
    table, codes, qs, parents = _packed_case(d, deg, d, m, width, ip,
                                             exact=False)
    pack = jnp.asarray(table[np.maximum(parents.T, 0)])
    qrep = _qrep(qs, deg, d)
    pd, pi = beam_step.packed_score_plain(
        torch.from_numpy(qs).to(torch.bfloat16), torch.from_numpy(table),
        torch.from_numpy(parents.T.copy()), deg, d, ip)
    pd, pi = np_(pd), np_(pi)
    fin = np.isfinite(pd)
    scale = np.abs(pd[fin]).max()
    # the reference's XLA mirror rounds each byte product to bf16 too
    xd, xi = _packed_score_xla(pack, qrep, jnp.asarray(parents), deg, d, ip)
    np.testing.assert_array_equal(pi, np.asarray(xi).T)
    np.testing.assert_array_equal(fin, np.isfinite(np.asarray(xd).T))
    np.testing.assert_allclose(pd[fin], np.asarray(xd).T[fin], rtol=1e-5,
                               atol=1e-6 * scale)
    # interpret mode keeps the products unrounded: within one bf16
    # rounding (2^-9 relative) of each product's magnitude
    jd, ji = _packed_score_xla(pack, qrep, jnp.asarray(parents), deg, d, ip,
                               interpret_match=True)
    np.testing.assert_array_equal(pi, np.asarray(ji).T)
    _, _, o_id, _ = beam_step.packed_row_layout(deg, d, ip)
    nbrs = table[np.maximum(parents.T, 0), o_id:o_id + deg].reshape(m, -1)
    mag = np.einsum("mcd,md->mc",
                    np.abs(codes[np.maximum(nbrs, 0)].astype(np.float32)),
                    np.abs(qs))
    gap = np.abs(pd[fin] - np.asarray(jd).T[fin])
    assert np.all(gap <= mag[fin] * 2.0 ** -9 + 1e-5 * scale)
