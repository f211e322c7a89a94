"""How a kernel's output is held against its plain PyTorch version.

Both sides do their math in fp32 on the same inputs and differ only in the
order of their sums. A float32 output is held to an absolute ``F32_ATOL``.
A bfloat16 output is that fp32 result rounded once, so the two sides
differ by at most one bf16 step, which is at most 2^-7 of the value: each
element is held to ``BF16_RTOL`` of its own size, ``|got - want| /
(|want| + BF16_FLOOR)``. The floor only keeps elements near zero from
dividing by ~0; it is well under the outputs' typical size.
"""
from __future__ import annotations

import torch

F32_ATOL = 1e-5
BF16_RTOL = 1e-2
BF16_FLOOR = 1e-3


def tolerance(dtype: torch.dtype) -> float:
    """The bound on ``parity_error(...)[1]`` for outputs of ``dtype``."""
    return F32_ATOL if dtype == torch.float32 else BF16_RTOL


def parity_error(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(max |got - want|, the error held to ``tolerance(want.dtype)``)."""
    diff = (got.float() - want.float()).abs()
    held = diff / (want.float().abs() + BF16_FLOOR) \
        if want.dtype == torch.bfloat16 else diff
    return diff.max().item(), held.max().item()
