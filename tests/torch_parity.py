"""Shared helpers for the tests of the PyTorch port (tests/test_torch_*.py).

The port and the JAX reference sum products in different orders, so f32
distances agree to a relative tolerance and ids agree except at genuine
near-ties (tests/test_pallas_parity.py:38-42 records why those flip).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module")
def torch_threads():
    """Pin torch to a few threads for the module, restoring the old
    setting afterwards (the suite runs several workers at once)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


def np_(x) -> np.ndarray:
    """A torch tensor or JAX array as numpy."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_topk_match(d_port, i_port, d_ref, i_ref, k: int,
                      rtol: float = 1e-4, atol: float = 1e-4) -> None:
    """Distances equal within tolerance over the first k columns; ids equal
    at every position whose reference distance is not within tolerance of
    another distance in its row (given width > k, the (k+1)-th counts
    too), and as sets over the tie-free prefix."""
    d_port, i_port = np_(d_port), np_(i_port)
    d_ref, i_ref = np_(d_ref), np_(i_ref)
    np.testing.assert_allclose(d_port[:, :k], d_ref[:, :k], rtol=rtol,
                               atol=atol)
    tol = atol + rtol * np.abs(np.where(np.isfinite(d_ref), d_ref, 0.0))
    for r in range(d_ref.shape[0]):
        row = d_ref[r]
        for j in range(k):
            others = np.delete(row, j)
            tied = np.isfinite(row[j]) and np.any(
                np.abs(others - row[j]) <= tol[r, j])
            if not tied:
                assert i_port[r, j] == i_ref[r, j], (
                    f"row {r} position {j}: id {i_port[r, j]} != "
                    f"{i_ref[r, j]} (distance {row[j]})")


def recall(found, truth) -> float:
    found, truth = np_(found), np_(truth)
    k = truth.shape[1]
    hits = sum(len(set(found[i, :k].tolist()) & set(truth[i].tolist()))
               for i in range(truth.shape[0]))
    return hits / truth.size
