"""Fixed-point Softermax (K7): the CUDA kernels' wrapper, its trainable op
and the dispatcher.

``softermax_quant_rows`` replaces the Pallas TPU kernel
``repro/kernels/softermax_quant/softermax_quant.py:67`` with one of two
hand-written Hopper kernels in ``csrc/softermax_quant.cu``, by an explicit
rule on the row length (``register_route``): rows of up to ``REG_CAP``
values take the register kernel, which reads each row once into registers
as the bits of its closed-form numerators and writes it once; longer rows
take the two-pass kernel, which re-reads the row for its normalize pass.
Both equal the mirror ``softermax_quant_plain`` bit for bit and are bound
by bytes (see the source's note). A failed build or launch raises, on
either route; nothing falls back. Launch counts:
``softermax_quant_rows.launches`` counts both routes, ``.launches_reg``
the register route alone. Like the TPU kernel they take the Table-I
formats only (``DEFAULT_BITWIDTHS``), and VectorSize 16; another slice
width raises.

``softermax_quant_op`` is the dispatcher over the last axis of any shape:
a CUDA tensor goes to the kernels, a CPU tensor to
``softermax_quant_plain``; there is no fallback between the two. Where a
gradient is wanted either runs inside a ``torch.autograd.Function`` whose
backward is the straight-through vector-Jacobian product of the plain
``softermax_fixed``, recomputed from the saved scores — the JAX package has
no backward kernel for K7 and differentiates ``softermax_fixed`` itself.
"""
from __future__ import annotations

import torch

from repro_torch.core.softermax import softermax_fixed
from repro_torch.kernels import build
from repro_torch.kernels.dtypes import row_code
from repro_torch.kernels.softermax_quant.plain import softermax_quant_plain

VECTOR_SIZE = 16
REG_CAP = 2048     # longest row the register kernel holds (csrc REG_CAP)


def register_route(x: torch.Tensor) -> bool:
    """THE dispatch rule: rows (the last axis) of up to ``REG_CAP`` values
    take the register kernel, longer rows the two-pass kernel."""
    return x.shape[-1] <= REG_CAP


def _launch(x: torch.Tensor, vector_size: int = VECTOR_SIZE, reg=None):
    """One launch of the route ``register_route`` picks, or of the one
    ``reg`` names (the register or the two-pass kernel); returns the output
    and whether the register kernel ran."""
    if not x.is_cuda:
        raise ValueError("softermax_quant_rows runs on CUDA tensors only")
    if x.dim() != 2:
        raise ValueError(f"softermax_quant_rows: x {tuple(x.shape)} must be "
                         "(rows, V)")
    if vector_size != VECTOR_SIZE:
        raise ValueError(f"softermax_quant_rows: the kernel's VectorSize is "
                         f"{VECTOR_SIZE}, not {vector_size}")
    code = row_code(x.dtype, "softermax_quant_rows")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out, None
    if reg is None:
        reg = register_route(x)
    lib = build.load_library()
    fn = lib.smx_softermax_quant_reg if reg else lib.smx_softermax_quant
    err = fn(build.ptr(x), build.ptr(out), x.shape[0], x.shape[1], code,
             build.stream_ptr(x.device))
    build.check(err, "softermax_quant_rows (registers)" if reg else
                "softermax_quant_rows")
    return out, reg


def softermax_quant_rows(x: torch.Tensor, *,
                         vector_size: int = VECTOR_SIZE) -> torch.Tensor:
    """K7 on the card: x (rows, V) float32 or bfloat16 → the fixed-point
    Softermax of each row in x's dtype (every value on the Q(1,7) grid)."""
    out, reg = _launch(x, vector_size)
    if reg is None:                           # nothing to launch
        return out
    if reg:
        softermax_quant_rows.launches_reg += 1
    softermax_quant_rows.launches += 1
    return out


softermax_quant_rows.launches = 0
softermax_quant_rows.launches_reg = 0


def _forward(x: torch.Tensor, vector_size: int) -> torch.Tensor:
    if x.is_cuda:
        return softermax_quant_rows(x, vector_size=vector_size)
    return softermax_quant_plain(x, vector_size)


class _SoftermaxQuant(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, vector_size):
        ctx.save_for_backward(x)
        ctx.vector_size = vector_size
        return _forward(x, vector_size)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xr = x.detach().requires_grad_()
            y = softermax_fixed(xr, block=ctx.vector_size)
            (dx,) = torch.autograd.grad(y, xr, g)
        return dx, None


def softermax_quant_op(x: torch.Tensor, *,
                       vector_size: int = VECTOR_SIZE) -> torch.Tensor:
    """Fixed-point Softermax over the last axis of any shape: K7 on a CUDA
    tensor, the kernel's mirror on a CPU tensor; either inside the
    trainable op where a gradient is wanted."""
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    if torch.is_grad_enabled() and x.requires_grad:
        y = _SoftermaxQuant.apply(x2, vector_size)
    else:
        y = _forward(x2, vector_size)
    return y.reshape(shape)
