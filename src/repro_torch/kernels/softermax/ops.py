"""Row-wise Softermax (K6): the CUDA kernel's wrapper, its trainable op
and the dispatcher.

``softermax_rows`` launches the hand-written Hopper kernel
(``csrc/softermax.cu``), which replaces the Pallas TPU kernel
``repro/kernels/softermax/softermax.py:81``. It is bound by bytes (see the
source's note). Its launch count is ``softermax_rows.launches``. The TPU
wrapper's ``block_rows``, ``block_v`` and ``interpret`` are TPU tiling and
do not carry over.

``softermax_op`` is the dispatcher over the last axis of any shape: a CUDA
tensor goes to the kernel — through a ``torch.autograd.Function`` whose
backward is the closed-form gradient ``ln2 · y · (g − Σ g·y)`` when a
gradient is wanted, directly otherwise — and a CPU tensor to the plain
version ``softermax_rows_ref`` computed in float32 and returned in x's
dtype, as the kernel computes (and as the TPU kernel does). There is no
fallback between the two: a build or launch failure raises.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import LN_2
from repro_torch.kernels import build
from repro_torch.kernels.dtypes import row_code
from repro_torch.kernels.softermax.ref import softermax_rows_ref


def softermax_rows(x: torch.Tensor, *, intmax: bool = True) -> torch.Tensor:
    """K6 on the card: x (rows, V) float32 or bfloat16 → the base-2
    softmax of each row (IntMax on or off) in x's dtype."""
    if not x.is_cuda:
        raise ValueError("softermax_rows runs on CUDA tensors only")
    if x.dim() != 2:
        raise ValueError(f"softermax_rows: x {tuple(x.shape)} must be "
                         "(rows, V)")
    code = row_code(x.dtype, "softermax_rows")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = build.load_library()
    err = lib.smx_softermax_rows(build.ptr(x), build.ptr(out), x.shape[0],
                                 x.shape[1], code, int(intmax),
                                 build.stream_ptr(x.device))
    build.check(err, "softermax_rows")
    softermax_rows.launches += 1
    return out


softermax_rows.launches = 0


class _SoftermaxRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, intmax):
        y = softermax_rows(x, intmax=intmax)
        ctx.save_for_backward(y)
        return y

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        # the ceil of IntMax carries no gradient; y does not depend on the
        # max it subtracts
        (y,) = ctx.saved_tensors
        yf, gf = y.float(), g.float()
        dx = LN_2 * yf * (gf - torch.sum(gf * yf, dim=-1, keepdim=True))
        return dx.to(y.dtype), None


def softermax_op(x: torch.Tensor, *, intmax: bool = True) -> torch.Tensor:
    """Softermax over the last axis of any shape: K6 on a CUDA tensor (the
    trainable op where a gradient is wanted), the closed form in float32 on
    a CPU tensor."""
    if not x.is_cuda:
        return softermax_rows_ref(x.float(), intmax).to(x.dtype)
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and x.requires_grad:
        y = _SoftermaxRows.apply(x2, intmax)
    else:
        y = softermax_rows(x2, intmax=intmax)
    return y.reshape(shape)
