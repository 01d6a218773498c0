"""The port's nn-descent local join (raft_tpu_torch.ops.graph_join) against
the JAX Pallas kernel in interpret mode, on the cases of its kernel
contract (raft_tpu/ops/graph_join.py:299-341) with every hazard its
contract cases plant: empty candidate slots, an in-row duplicate, a
candidate already on the list, short lists, a row with no valid candidate.

The JAX kernel takes the candidate vectors pre-gathered; the port reads
them from ``data`` by id, so both get the same rows and the same norms.
Tolerance: ids exactly (keep-min per id, ties to the smallest id on both
sides); distances to 1e-5 relative (plus 1e-5 absolute), since the f32
dots are summed in different orders.

The hazard cases (what a dedup or a selection can get wrong: many
duplicate ids, candidates repeating the list, distinct ids at equal
distances, -0.0, rows of -1 candidates only, C = 0, K + C = 2048, C off a
multiple of 32, d = 30) run on small integers, where every dot, norm and
distance is exact in f32 in any summation order: ids and distances must be
equal, ties included, against the Pallas kernel (K <= 128, C >= 1) and
against the rule written out in numpy.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from raft_tpu.ops import graph_join as jax_join
from raft_tpu_torch.ops import graph_join
from tests.torch_parity import np_, torch_threads  # noqa: F401

pytestmark = pytest.mark.usefixtures("torch_threads")


def _case(seed, B, C, d, K, ip):
    rng = np.random.default_rng(seed)
    N = max(4 * (K + C), 64)
    vecs = rng.standard_normal((N, d)).astype(np.float32)
    q = rng.standard_normal((B, d)).astype(np.float32)
    cand = rng.integers(0, N, (B, C)).astype(np.int32)
    cand[rng.random((B, C)) < 0.15] = -1                 # invalid slots
    if C >= 2:
        cand[:, 1] = cand[:, 0]                          # in-row duplicate
    cur_i = np.stack([rng.choice(N, size=K, replace=False).astype(np.int32)
                      for _ in range(B)])
    live = rng.integers(1, K + 1, B)                     # short lists too
    cur_i[np.arange(K)[None, :] >= live[:, None]] = -1
    if C >= 3:
        cand[:, 2] = cur_i[:, 0]                         # already listed
    cand[B - 1, :] = -1                                  # starved row
    norms = (vecs ** 2).sum(1).astype(np.float32)
    qn = (q ** 2).sum(1).astype(np.float32)
    dots = np.einsum("bd,bkd->bk", q, vecs[np.maximum(cur_i, 0)])
    cur_d = -dots if ip else np.maximum(
        qn[:, None] + norms[np.maximum(cur_i, 0)] - 2.0 * dots, 0.0)
    cur_d = np.where(cur_i < 0, np.inf, cur_d).astype(np.float32)
    return q, cand, vecs, norms, qn, cur_d, cur_i


def _int_case(seed, B, C, d, K, ip, hazard):
    """Small-integer rows, queries and current distances, unsorted unique
    current lists (some short), and the named hazard planted."""
    rng = np.random.default_rng(seed)
    N = 24 if hazard == "dup_ids" else max(4 * (K + C), 64)
    vecs = rng.integers(-3, 4, (N, d)).astype(np.float32)
    q = rng.integers(-3, 4, (B, d)).astype(np.float32)
    cand = rng.integers(-1, N, (B, C)).astype(np.int32)
    cur_i = np.stack([rng.choice(N, size=K, replace=False).astype(np.int32)
                      for _ in range(B)])
    live = rng.integers(1, K + 1, B)
    cur_i[np.arange(K)[None, :] >= live[:, None]] = -1
    lo = -8 * d if ip else 0
    cur_d = rng.integers(lo, 8 * d, (B, K)).astype(np.float32)
    if hazard == "list_repeat":
        m = min(K, C)
        cand[:, :m] = cur_i[:, rng.permutation(K)[:m]]
    elif hazard == "twin_rows":
        vecs[N // 2:] = vecs[:N // 2]
    elif hazard == "neg_zero":
        vecs[:N // 8] = 0.0
        cur_d[:, 0] = -0.0
    elif hazard == "self_row":
        q[:] = vecs[np.maximum(cand[:, 0], 0)]
        cur_d[:, 0] = -0.0
    elif hazard == "starved":
        cand[::3] = -1
    cur_d = np.where(cur_i < 0, np.inf, cur_d).astype(np.float32)
    norms = (vecs ** 2).sum(1).astype(np.float32)
    qn = (q ** 2).sum(1).astype(np.float32)
    return q, cand, vecs, norms, qn, cur_d, cur_i


def _both(q, cand, vecs, norms, qn, cur_d, cur_i, ip):
    cs = np.maximum(cand, 0)
    jd, ji = jax_join.graph_local_join(
        jnp.asarray(q), jnp.asarray(cand), jnp.asarray(vecs[cs]),
        jnp.asarray(cur_d), jnp.asarray(cur_i),
        None if ip else jnp.asarray(qn),
        None if ip else jnp.asarray(norms[cs]), ip=ip, interpret=True)
    t = torch.from_numpy
    pd, pi = graph_join.graph_local_join(
        t(q), t(cand), t(vecs), t(norms), t(cur_d), t(cur_i), qn=t(qn),
        ip=ip)
    return np_(pd), np_(pi), np.asarray(jd), np.asarray(ji)


def _base(B, C, d, K, ip):
    return pytest.param(B, C, d, K, ip, None, id=f"{B}-{C}-{d}-{K}-{ip}")


def _hazard(B, C, d, K, ip, hazard):
    return pytest.param(B, C, d, K, ip, hazard,
                        id=f"{hazard}-{B}-{C}-{d}-{K}-{ip}")


# the hazard cases on small integers (_int_case), shared with the rule test
_HAZARDS = [
    (16, 120, 16, 16, False, "dup_ids"),      # n = 24 < C: many duplicates
    (12, 80, 16, 32, False, "list_repeat"),   # candidates repeat the list
    (12, 80, 16, 32, False, "twin_rows"),     # equal distances, two ids
    (12, 80, 16, 32, True, "neg_zero"),       # -0.0: zero rows under IP
    (12, 80, 16, 32, False, "self_row"),      # -0.0: the node's own row
    (15, 64, 16, 16, False, "starved"),       # rows of -1 candidates only
    (4, 2040, 16, 8, False, None),            # K + C = 2048
    (12, 45, 16, 32, False, "list_repeat"),   # C off a multiple of 32
    (12, 64, 30, 16, False, "list_repeat"),   # d = 30
]


@pytest.mark.parametrize("B,C,d,K,ip,hazard", [
    _base(24, 37, 32, 8, False),     # the contract's base case
    _base(24, 37, 32, 8, True),      # inner product
    _base(9, 5, 16, 32, False),      # fewer candidates than K
    _base(24, 37, 30, 8, False),     # d off a multiple of 4
    _base(8, 120, 32, 24, False),    # a larger pool
    _base(12, 40, 16, 1, False),     # K = 1
] + [_hazard(*h) for h in _HAZARDS])
def test_plain_matches_pallas_interpret(B, C, d, K, ip, hazard):
    if hazard is None and K + C < 2048:
        case = _case(B + C + K, B, C, d, K, ip)
    else:
        case = _int_case(B + C + K, B, C, d, K, ip, hazard)
    pd, pi, jd, ji = _both(*case, ip=ip)
    np.testing.assert_array_equal(pi, ji)
    if hazard is None and K + C < 2048:
        np.testing.assert_allclose(pd, jd, rtol=1e-5, atol=1e-5)
    else:                              # integers: exact in any order
        np.testing.assert_array_equal(pd, jd)
    # rows are unique, sorted, and tail out as (+inf, -1)
    for r in range(pi.shape[0]):
        live = pi[r][pi[r] >= 0]
        assert len(set(live.tolist())) == len(live)
    assert np.all(np.isinf(pd) == (pi < 0))
    assert np.all(np.diff(np.where(np.isinf(pd), 1e30, pd), axis=1) >= 0)


def _assert_reference_rule(case, K, ip, exact):
    """The port against the rule written out in numpy: keep each id's
    smallest distance, order by (distance, id), drop -1 and +inf, pad
    with (+inf, -1)."""
    q, cand, vecs, norms, qn, cur_d, cur_i = case
    t = torch.from_numpy
    pd, pi = graph_join.graph_local_join(t(q), t(cand), t(vecs), t(norms),
                                         t(cur_d), t(cur_i), qn=t(qn),
                                         ip=ip)
    cs = np.maximum(cand, 0)
    dots = np.einsum("bd,bcd->bc", q, vecs[cs])
    new = -dots if ip else np.maximum(qn[:, None] + norms[cs] - 2.0 * dots,
                                      0.0)
    for r in range(q.shape[0]):
        best = {}
        for dist, i in list(zip(cur_d[r], cur_i[r])) + list(
                zip(new[r], cand[r])):
            if i >= 0 and np.isfinite(dist):
                best[int(i)] = min(best.get(int(i), np.inf),
                                   float(dist) + 0.0)
        want = sorted(best.items(), key=lambda kv: (kv[1], kv[0]))[:K]
        n_live = len(want)
        np.testing.assert_array_equal(np_(pi)[r, :n_live],
                                      [i for i, _ in want])
        if exact:
            np.testing.assert_array_equal(np_(pd)[r, :n_live],
                                          [v for _, v in want])
        else:
            np.testing.assert_allclose(np_(pd)[r, :n_live],
                                       [v for _, v in want], rtol=1e-5,
                                       atol=1e-5)
        assert np.all(np_(pi)[r, n_live:] == -1)
        assert np.all(np.isinf(np_(pd)[r, n_live:]))


def test_k128_against_the_reference_rule():
    """K = 128, the reference kernel's cap (too slow to extract in
    interpret mode here): the port against the rule written out in numpy —
    keep each id's smallest distance, order by (distance, id)."""
    B, C, d, K = 6, 300, 16, 128
    _assert_reference_rule(_case(128, B, C, d, K, True), K, True, False)


@pytest.mark.parametrize("B,C,d,K,ip,hazard", [
    _hazard(*h) for h in _HAZARDS] + [
    _hazard(6, 300, 16, 128, False, "list_repeat"),   # K = 128
    _hazard(4, 1920, 16, 128, True, "neg_zero"),      # K + C = 2048
    _hazard(8, 0, 16, 24, False, None),               # C = 0
    _hazard(8, 0, 16, 24, True, "neg_zero"),
])
def test_k128_against_the_reference_rule_hazards(B, C, d, K, ip, hazard):
    """The hazard cases, on small integers, against the same rule; also
    K = 128, K + C = 2048 at K = 128, and C = 0, which the Pallas kernel
    does not take."""
    case = _int_case(B + C + K, B, C, d, K, ip, hazard)
    _assert_reference_rule(case, K, ip, True)


def test_node_ids_for_q_and_wrapper_counts_no_cpu_launch():
    """Node rows given as ids into data are the rows themselves; the CPU
    path runs the plain version and counts no kernel launch."""
    q, cand, vecs, norms, qn, cur_d, cur_i = _case(9, 16, 20, 8, 8, False)
    ids = np.arange(16, dtype=np.int32) * 3
    t = torch.from_numpy
    before = graph_join.graph_local_join.launches
    a = graph_join.graph_local_join(t(ids), t(cand), t(vecs), t(norms),
                                    t(cur_d), t(cur_i))
    b = graph_join.graph_local_join(t(vecs[ids]), t(cand), t(vecs),
                                    t(norms), t(cur_d), t(cur_i),
                                    qn=t(norms[ids]))
    assert graph_join.graph_local_join.launches == before
    np.testing.assert_array_equal(np_(a[1]), np_(b[1]))
    np.testing.assert_array_equal(np_(a[0]), np_(b[0]))
