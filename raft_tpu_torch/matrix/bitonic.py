"""Bitonic sorting network on the last axis (counterpart of
``raft_tpu/matrix/bitonic.py:70 sort_by_key``).

The network is the reference's, compare-exchange for compare-exchange:
at stage ``k`` and substage ``j`` element ``i`` meets ``i ^ j``, the pair
sorts ascending when bit ``log2(k)`` of ``i`` is 0, and the two swap only
when strictly out of order. Equal keys therefore come out in the same
order as in the reference — which a stable ``torch.sort`` would not give,
and which CAGRA's windowed dedup depends on (duplicates must sit
adjacent). The CUDA beam-step kernel (``ops/csrc/cagra_beam_step.cu``)
runs the same network in shared memory.

Rows sort ascending by key along the LAST axis, with payloads carried by
the same predicate; the length must be a power of two (callers pad with
+inf keys).
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _asc_masks(L: int, descending: bool, device: torch.device):
    """The substages in network order as (j, ascending-direction mask
    shaped [L / (2j), j] to line up with the pair view of the row)."""
    idx = np.arange(L)
    stages = []
    k = 2
    while k <= L:
        asc = (idx & k) == 0
        j = k // 2
        while j >= 1:
            m = asc.reshape(L // (2 * j), 2, j)[:, 0, :]
            # descending flips every comparison (negating the keys would
            # overflow INT_MIN and conflate +0.0 / -0.0)
            stages.append((j, torch.from_numpy(~m if descending else m)
                           .to(device)))
            j //= 2
        k *= 2
    return stages


def _substage(keys, payloads, j: int, asc: torch.Tensor):
    """One compare-exchange substage: partner i <-> i ^ j."""
    shape = keys.shape
    view = shape[:-1] + (shape[-1] // (2 * j), 2, j)

    def pair(x):
        x = x.reshape(view)
        return x[..., 0, :], x[..., 1, :]

    k0, k1 = pair(keys)
    swap = torch.where(asc, k0 > k1, k0 < k1)

    def exchange(x0, x1):
        lo = torch.where(swap, x1, x0)
        hi = torch.where(swap, x0, x1)
        return torch.stack([lo, hi], dim=-2).reshape(shape)

    keys = exchange(k0, k1)
    payloads = tuple(exchange(*pair(p)) for p in payloads)
    return keys, payloads


def sort_by_key(keys: torch.Tensor, *payloads: torch.Tensor,
                descending: bool = False):
    """Sort rows of ``keys`` (last axis, power-of-two length), carrying
    ``payloads`` through the same permutation. Returns (keys, payloads)."""
    L = keys.shape[-1]
    if L & (L - 1):
        raise ValueError(f"bitonic length must be a power of two, got {L}")
    for j, asc in _asc_masks(L, bool(descending), keys.device):
        keys, payloads = _substage(keys, payloads, j, asc)
    return keys, payloads
