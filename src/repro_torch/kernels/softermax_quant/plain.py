"""The plain PyTorch version of the fixed-point kernel (K7): a step-for-step
mirror of the Pallas kernel body ``_quant_kernel``
(``repro/kernels/softermax_quant/softermax_quant.py:26``) and its wrapper's
pad, which the CUDA kernel equals bit for bit.

Per row, VectorSize slices at a time: Q(6,2) input → IntMax → LPW 2^x to
Q(1,15) → Q(10,6) PowSum with shift renormalization → at the end each
numerator recomputed against the *final* max, times the LPW reciprocal
(Q(1,7)), quantized to Q(1,7). Columns are padded to a multiple of the
slice with the Q(6,2) minimum, -32; masked scores (NEG_INF) clip to -32
and, like the pad, enter the PowSum.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import quant


def softermax_quant_plain(x: torch.Tensor,
                          vector_size: int = 16) -> torch.Tensor:
    """Fixed-point Softermax over the last axis of any shape, in x's
    dtype (computed in float32)."""
    bw = quant.DEFAULT_BITWIDTHS
    shape = x.shape
    V = shape[-1]
    x2 = x.reshape(-1, V)
    pv = (-V) % vector_size
    if pv:
        x2 = F.pad(x2, (0, pv), value=bw.inp.min_value)
    xq = bw.inp.quantize_exact(x2.float())          # Q(6,2) scores
    rows, Vp = xq.shape
    m = torch.full((rows,), float(bw.inp.min_value), dtype=torch.float32,
                   device=x.device)
    d = torch.zeros_like(m)
    for s in range(Vp // vector_size):
        xv = xq[:, s * vector_size:(s + 1) * vector_size]
        # IntMax unit: ceil per element, then slice max and running max
        m_new = torch.maximum(m, torch.amax(torch.ceil(xv), dim=1))
        # power-of-two unit (LPW) → Q(1,15); reduction unit accumulate
        un = quant.lpw_exp2(xv - m_new[:, None], out_fmt=bw.unnormed)
        local_d = torch.sum(un, dim=1)
        # shift-renormalize the running PowSum (integer exponent: exact)
        d = bw.powsum.quantize_exact(d * quant.pow2_exact(m - m_new)
                                     + local_d)
        m = m_new
    # normalization unit: numerators against the final max, times the LPW
    # reciprocal of the PowSum
    un_fin = quant.lpw_exp2(xq - m[:, None], out_fmt=bw.unnormed)
    recip = quant.lpw_reciprocal(d, out_fmt=bw.recip)
    y = bw.outp.quantize_exact(un_fin * recip[:, None])
    y = torch.where(d[:, None] > 0, y, torch.zeros_like(y))
    return y[:, :V].to(x.dtype).reshape(shape)
