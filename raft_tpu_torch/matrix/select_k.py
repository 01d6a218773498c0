"""select_k — k smallest (or largest) per row.

Counterpart of ``raft_tpu/matrix/select_k.py``, which has no Pallas kernel
(its rungs are XLA selection networks). Here one stable sort serves every
shape and every ``impl``; what differs by ``impl`` is the order of the
keys, which follows the reference's arm of that name:

* "top_k" (``lax.top_k``): XLA's total order of floats, -NaN < -inf < ...
  < -0.0 < +0.0 < ... < +inf < +NaN, so the sign of a NaN matters: a
  select-max takes +NaN first and -NaN last, a select-min (the reference
  takes the largest of the negated keys) takes -NaN first and +NaN last;
* "hierarchical": NaNs are quarantined to the worst key class: never
  selected before a finite value, tied with genuine worst-infinity
  entries (column order breaks the tie), and reported as NaN with their
  real column;
* "tournament": the reference documents NaN as unsupported (its merge
  network lets NaN surface first); the port keeps the quarantine of
  "hierarchical" there (ROADMAP.md, reference caveats);
* "auto": the arm :func:`dispatch_select_impl` resolves, as the
  reference's does (its ``op``, candidates and analytic fallback through
  ``tuning.choose``), and that arm's order.

Every arm keeps the reference's other contracts exactly:

* ties go to the lower column (``lax.top_k`` is stable);
* integer keys stay in the integer domain (exact above 2**24, including
  ``INT32_MIN``), and the values come back in the input dtype;
* ``in_idx`` carries source indices through the selection.

``sorted`` takes the reference's values; the result is always sorted.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device


_IMPLS = ("auto", "top_k", "tournament", "hierarchical")


def _dtype_name(dtype: torch.dtype) -> str:
    """The dtype's name as the reference's table keys spell it
    ("float32", "int32", "bool", ...)."""
    return str(dtype).replace("torch.", "")


def dispatch_select_impl(batch: int, n: int, k: int, dtype: torch.dtype,
                         op: str = "select_k",
                         fallback: Optional[str] = None,
                         device=None) -> str:
    """The reference's selection dispatch (``raft_tpu/matrix/select_k.py:
    106-151``) for a call on ``device``: ``tuning.choose(op, {n, k, batch,
    dtype}, candidates, fallback)``. The candidates are "top_k", plus
    "tournament" for floating types, plus "hierarchical" where n >= 4 K
    (K = k rounded up to a power of two); the analytic ``fallback`` (when
    None) is "tournament" for floats, else "hierarchical", once k > 256
    and n >= 8 K, and "top_k" otherwise. ``op`` names the table section
    ("merge_topk" for candidate merges), and ``fallback`` overrides the
    analytic pick on a miss (the merges pass "auto", deferring to
    select_k's own dispatch)."""
    from raft_tpu_torch import tuning

    floating = dtype.is_floating_point
    candidates = ["top_k"] + (["tournament"] if floating else [])
    K = 1 << (int(k) - 1).bit_length()
    if n >= 4 * K:
        candidates.append("hierarchical")
    if fallback is None:
        fallback = ("tournament" if k > 256 and n >= 8 * K and floating
                    else "hierarchical"
                    if k > 256 and n >= 8 * K and "hierarchical" in candidates
                    else "top_k")
    return tuning.choose(
        op, {"n": int(n), "k": int(k), "batch": int(batch),
             "dtype": _dtype_name(dtype)},
        candidates, fallback, device=device)


def select_k(in_val, k: int, in_idx=None, select_min: bool = True,
             sorted: bool = True,  # noqa: A002 - the reference's name
             impl: str = "auto", device=None,
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Select the k best per row of ``in_val`` [batch, n] (or [n]).

    Runs on ``device`` (default: the CUDA card). Returns
    (out_val [batch, k], out_idx [batch, k] int32 — ``in_idx``'s dtype
    when ``in_idx`` is given). ``sorted`` and ``impl`` as in the module
    docstring."""
    if impl not in _IMPLS:
        raise ValueError(f"impl must be one of {_IMPLS}, got {impl!r}")
    in_val = as_tensor(in_val, resolve_device(device))
    if impl == "tournament" and not in_val.is_floating_point():
        raise ValueError(f"impl='tournament' is float-only, got "
                         f"{in_val.dtype}")
    squeeze = in_val.dim() == 1
    if squeeze:
        in_val = in_val[None, :]
    batch, n = in_val.shape
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for row length {n}")
    if impl == "auto":
        impl = dispatch_select_impl(batch, n, int(k), in_val.dtype,
                                    device=in_val.device)
    vals, idxs = _select(in_val, int(k), bool(select_min), impl)
    if in_idx is not None:
        in_idx = torch.as_tensor(in_idx, device=in_val.device)
        if squeeze and in_idx.dim() == 1:
            in_idx = in_idx[None, :]
        idxs = torch.gather(in_idx, 1, idxs.long())
    if squeeze:
        return vals[0], idxs[0]
    return vals, idxs


# integer types PyTorch sorts but cannot gather: carried as int64 (exact)
_WIDEN = (torch.uint16, torch.uint32)
# float types by the signed integer of their width
_BITS = {torch.float16: torch.int16, torch.bfloat16: torch.int16,
         torch.float32: torch.int32, torch.float64: torch.int64}


def _total_order_keys(x: torch.Tensor) -> torch.Tensor:
    """Signed integer keys in XLA's total order of the floats ``x``: the
    bits as a signed integer, with the magnitude bits of negative values
    flipped, so -NaN < -inf < ... < -0.0 < +0.0 < ... < +inf < +NaN."""
    itype = _BITS[x.dtype]
    bits = x.contiguous().view(itype)
    keys = bits >> (torch.iinfo(itype).bits - 1)
    keys &= torch.iinfo(itype).max
    keys ^= bits
    return keys


def _select(x: torch.Tensor, k: int, select_min: bool, impl: str):
    work = x.to(torch.int64) if x.dtype in _WIDEN else x
    if x.dtype == torch.bool:
        keys = x.to(torch.uint8)
    elif x.is_floating_point() and impl == "top_k" and x.dtype in _BITS:
        keys = _total_order_keys(x)
    elif x.is_floating_point():
        worst = float("inf") if select_min else float("-inf")
        keys = torch.where(torch.isnan(x), torch.full_like(x, worst), x)
    else:
        keys = work
    order = torch.sort(keys, dim=1, descending=not select_min,
                       stable=True).indices[:, :k]
    return torch.gather(work, 1, order).to(x.dtype), order.to(torch.int32)
