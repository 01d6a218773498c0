"""Matmul precision policy for distance math.

Counterpart of ``raft_tpu/utils/precision.py``: distance products feed
k-selection, so they run at full f32: TF32 (about three decimal digits)
would flip distance near-ties. PyTorch's default already keeps f32
matrix products out of TF32; this module states the policy and sets it
(the port runs no convolution, so cuDNN's own TF32 switch is not
touched). bf16 operands are multiplied exactly and summed in f32 — the
reference's "bf16 operands, f32 accumulation".
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def dist_dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` with f32 accumulation (operands widened to f32 first, so
    bf16 products are exact and the sum is f32)."""
    return torch.matmul(a.float(), b.float())


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to bf16 and held as f32 — the operand rounding of the
    reference's bf16 compute paths."""
    return x.to(torch.bfloat16).float()
