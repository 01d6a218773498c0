"""select_k — k smallest (or largest) per row.

Counterpart of ``raft_tpu/matrix/select_k.py``, which has no Pallas kernel
(its rungs are XLA selection networks). Here one stable sort serves every
shape: it keeps the reference's contracts exactly —

* ties go to the lower column (``lax.top_k`` is stable);
* NaNs are quarantined to the worst key class: never selected before a
  finite value, tied with genuine worst-infinity entries (column order
  breaks the tie), and reported as NaN with their real column;
* integer keys stay in the integer domain (exact above 2**24, including
  ``INT32_MIN``), and the values come back in the input dtype;
* ``in_idx`` carries source indices through the selection.

``sorted`` and ``impl`` take the reference's values; every ``impl``
("auto" | "top_k" | "tournament" | "hierarchical", all exact selections
in the reference) runs the same sort, and the result is always sorted.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.resources import as_tensor, resolve_device


_IMPLS = ("auto", "top_k", "tournament", "hierarchical")


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
    n = in_val.shape[1]
    if not 0 < k <= n:
        raise ValueError(f"k={k} out of range for row length {n}")
    vals, idxs = _select(in_val, int(k), bool(select_min))
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


def _select(x: torch.Tensor, k: int, select_min: bool):
    work = x.to(torch.int64) if x.dtype in _WIDEN else x
    if x.dtype == torch.bool:
        keys = x.to(torch.uint8)
    elif x.is_floating_point():
        worst = float("inf") if select_min else float("-inf")
        keys = torch.where(torch.isnan(x), torch.full_like(x, worst), x)
    else:
        keys = work
    order = torch.sort(keys, dim=1, descending=not select_min,
                       stable=True).indices[:, :k]
    return torch.gather(work, 1, order).to(x.dtype), order.to(torch.int32)
