"""Row-wise Softermax (K6): the CUDA kernel's wrapper, its trainable op
and the dispatcher.

``softermax_rows`` replaces the Pallas TPU kernel
``repro/kernels/softermax/softermax.py:81`` with one of two hand-written
Hopper kernels in ``csrc/softermax.cu``, by an explicit rule on the row
length (``register_route``): rows of up to ``REG_CAP`` values take the
register kernel, which reads each row once into registers and writes it
once; longer rows take the two-pass kernel, which re-reads the row for its
normalize pass. Both are bound by bytes (see the source's note). A failed
build or launch raises, on either route; nothing falls back. Launch
counts: ``softermax_rows.launches`` counts both routes,
``.launches_reg`` the register route alone. The TPU wrapper's
``block_rows``, ``block_v`` and ``interpret`` are TPU tiling and do not
carry over.

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


REG_CAP = 2048     # longest row the register kernel holds (csrc REG_CAP)


def register_route(x: torch.Tensor) -> bool:
    """THE dispatch rule: rows (the last axis) of up to ``REG_CAP`` values
    take the register kernel, longer rows the two-pass kernel."""
    return x.shape[-1] <= REG_CAP


def _launch(x: torch.Tensor, intmax: bool, reg=None):
    """One launch of the route ``register_route`` picks, or of the one
    ``reg`` names (the register or the two-pass kernel); returns the output
    and whether the register kernel ran."""
    if not x.is_cuda:
        raise ValueError("softermax_rows runs on CUDA tensors only")
    if x.dim() != 2:
        raise ValueError(f"softermax_rows: x {tuple(x.shape)} must be "
                         "(rows, V)")
    code = row_code(x.dtype, "softermax_rows")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, None
    if reg is None:
        reg = register_route(x)
    lib = build.load_library()
    fn = lib.smx_softermax_rows_reg if reg else lib.smx_softermax_rows
    err = fn(build.ptr(x), build.ptr(out), x.shape[0], x.shape[1], code,
             int(intmax), build.stream_ptr(x.device))
    build.check(err, "softermax_rows (registers)" if reg else
                "softermax_rows")
    return out, reg


def softermax_rows(x: torch.Tensor, *, intmax: bool = True) -> torch.Tensor:
    """K6 on the card: x (rows, V) float32 or bfloat16 → the base-2
    softmax of each row (IntMax on or off) in x's dtype."""
    out, reg = _launch(x, intmax)
    if reg is None:                           # nothing to launch
        return out
    if reg:
        softermax_rows.launches_reg += 1
    softermax_rows.launches += 1
    return out


softermax_rows.launches = 0
softermax_rows.launches_reg = 0


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
