"""The plain PyTorch versions of the fixed-point kernel (K7): a step-for-step
mirror of the Pallas kernel body ``_quant_kernel``
(``repro/kernels/softermax_quant/softermax_quant.py:26``) and its wrapper's
pad, which both CUDA kernels equal bit for bit; and the register kernel's
own arithmetic (``softermax_quant_reg_plain``, ``lpw_numerator``), which
equals that mirror bit for bit.

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


# The f32 bits of the exp2 c LUT's entries (Q(1,15) values in [1, 2)), as
# the register kernel picks them (csrc/softermax_quant.cu::numer_bits).
_C_BITS = (0x3F800000, 0x3F983800, 0x3FB50500, 0x3FD74500)


def _numerator_bits(k: torch.Tensor) -> torch.Tensor:
    """int32 bits of c[k & 3] * 2^(15 + (k >> 2)) for Q(6,2) integers k
    (a score times 4): what the register kernel keeps for each value."""
    lut = torch.tensor(_C_BITS, dtype=torch.int32, device=k.device)
    return lut[(k & 3).long()] + (((k >> 2) + 15) << 23)


def _rounded_numerators(bits: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """round(c[k & 3] * 2^(15 + (k >> 2) - m)), half to even: the Q(1,15)
    numerators against the integer max m, in units of 2^-15 (float32)."""
    return torch.round((bits - (m.to(torch.int32) << 23))
                       .view(torch.float32))


def lpw_numerator(k: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The LPW numerator of the Q(6,2) score k / 4 against the integer max
    m in closed form, Q15(c[k & 3] * 2^max((k >> 2) - m, -40)), as the
    register kernel computes it: on the Q(6,2) grid the fraction of k / 4 -
    m is (k & 3) / 4 whatever m is, so the LPW's slope term is 0 and the
    value is a c LUT entry times a power of two. Rounded to Q(1,15) (half
    to even, saturating); below 2^-16 it rounds to 0, as the -40 clamp
    does."""
    k, m = torch.broadcast_tensors(k.to(torch.int32), m.to(torch.int32))
    u = _rounded_numerators(_numerator_bits(k), m)
    un = quant.DEFAULT_BITWIDTHS.unnormed
    return torch.clamp(u, max=un.max_value * un.scale) / un.scale


def softermax_quant_reg_plain(x: torch.Tensor,
                              vector_size: int = 16) -> torch.Tensor:
    """The register kernel's arithmetic on the CPU: the scores as Q(6,2)
    integers k, the slice maxima ceil(k_max / 4), the running max, the local
    sums of closed-form numerators as integers in units of 2^-15, the PowSum
    carry on 64 d (min(rint(D * shift + 64 local_d), 65535), where D *
    shift is exact), then the numerators against the final max times the
    LPW reciprocal, to Q(1,7). Equals ``softermax_quant_plain`` bit for
    bit."""
    bw = quant.DEFAULT_BITWIDTHS
    shape = x.shape
    V = shape[-1]
    x2 = x.reshape(-1, V).float()
    pv = (-V) % vector_size
    if pv:
        x2 = F.pad(x2, (0, pv), value=bw.inp.min_value)
    k = torch.round(torch.clamp(x2, bw.inp.min_value, bw.inp.max_value)
                    * bw.inp.scale).to(torch.int32)
    rows, Vp = k.shape
    ks = k.reshape(rows, Vp // vector_size, vector_size)
    bits = _numerator_bits(ks)
    m0 = torch.full((rows, 1), int(bw.inp.min_value), dtype=torch.int32,
                    device=x.device)
    # running max after each slice, on top of the Q(6,2) minimum
    m_run = torch.cummax(torch.cat([m0, (ks.amax(-1) + 3) >> 2], dim=1),
                         dim=1).values
    local = _rounded_numerators(bits, m_run[:, 1:, None]).sum(-1)
    shift = quant.pow2_exact((m_run[:, :-1] - m_run[:, 1:]).float())
    d64 = torch.zeros(rows, dtype=torch.float32, device=x.device)
    cap = bw.powsum.max_value * bw.powsum.scale
    for s in range(ks.shape[1]):
        d64 = torch.clamp(torch.round(d64 * shift[:, s] + local[:, s] *
                                      (bw.powsum.scale / bw.unnormed.scale)),
                          max=cap)
    recip = quant.lpw_reciprocal(d64 / bw.powsum.scale, out_fmt=bw.recip)
    u = _rounded_numerators(bits, m_run[:, -1, None, None]).reshape(rows, Vp)
    y = torch.clamp(u * (recip[:, None] / bw.unnormed.scale * bw.outp.scale),
                    max=bw.outp.max_value * bw.outp.scale)
    y = torch.round(y) / bw.outp.scale
    return y[:, :V].to(x.dtype).reshape(shape)
