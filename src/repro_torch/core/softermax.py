"""Softermax algorithm variants on torch tensors: the paper's Figure-3
progression, as the JAX package's ``repro.core.softermax``.

Every function works over the last axis (or the named one); masked
positions carry ``numerics.NEG_INF`` (finite) so online recurrences stay
nan-free, and fully-masked rows produce all-zero outputs.

* ``softmax_e``             — the max-subtracted base-e baseline.
* ``softmax_base2``         — base replacement: 2^x instead of e^x
  (§III.A); ``fold_log2e=True`` makes it equal to the e-base softmax.
* ``softmax_online``        — the online normalizer, one column at a time
  (§III.C).
* ``softermax``             — base-2 + integer max, closed form (§III.C).
* ``softermax_online_scan`` — block-online Softermax, the kernels' semantics.
* ``softermax_merge``       — exact combine of partial online states
  (split-K).
* ``softermax_finalize``    — the Normalization Unit, ``acc / d`` with
  d == 0 → 0.
* ``softermax_fixed``       — bit-faithful fixed point with the Table-I
  Q-formats and LPW units (§III.B), differentiable through STEs.
* ``attention_softmax``     — the dispatch every model uses. On a CUDA
  tensor ``softermax`` and ``base2`` run the row kernel K6
  (``kernels/softermax``) and ``softermax_fixed`` the fixed-point kernel K7
  (``kernels/softermax_quant``); on the CPU each is the plain function,
  as in the reference.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import quant
from repro_torch.core.numerics import (LOG2_E, NEG_INF, exp2, int_ceil,
                                       pow2_int)


def softmax_e(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Standard max-subtracted softmax, base e: the paper's baseline."""
    m = torch.amax(x, dim=axis, keepdim=True)
    ex = torch.exp(x - m)
    d = torch.sum(ex, dim=axis, keepdim=True)
    return _safe_div(ex, d)


def softmax_base2(x: torch.Tensor, axis: int = -1,
                  fold_log2e: bool = False) -> torch.Tensor:
    """Base-2 softmax: 2^(x-m) / sum 2^(x-m). With ``fold_log2e=True`` the
    input is pre-scaled by log2(e) (in x's dtype), making the result equal
    to the e-base softmax up to rounding."""
    if fold_log2e:
        # log2(e) rounded to x's dtype on the host (no device scalar copy)
        x = x * torch.tensor(LOG2_E, dtype=x.dtype).item()
    m = torch.amax(x, dim=axis, keepdim=True)
    ex = exp2(x - m)
    d = torch.sum(ex, dim=axis, keepdim=True)
    return _safe_div(ex, d)


def softmax_online(x: torch.Tensor, base2: bool = False) -> torch.Tensor:
    """Milakov-Gimelshein online softmax over the last axis, one column at
    a time: a running max ``m`` and a running denominator ``d``, rescaled
    by base**(m_old - m_new) on a new max."""
    ex = exp2 if base2 else torch.exp
    x2 = x.reshape(-1, x.shape[-1])
    m = torch.full(x2.shape[:1], NEG_INF, dtype=x2.dtype, device=x2.device)
    d = torch.zeros_like(m)
    for xv in x2.unbind(-1):
        m_new = torch.maximum(m, xv)
        d = d * ex(m - m_new) + ex(xv - m_new)
        m = m_new
    y = _safe_div(ex(x2 - m[:, None]), d[:, None])
    return y.reshape(x.shape)


def softermax(x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """The full Softermax in closed form: ``m = max_i ceil(x_i)``,
    ``y_i = 2^(x_i - m) / sum_j 2^(x_j - m)``. The integer max changes only
    the shared scaling of numerator and denominator; its payoff is that
    every online rescale 2^(m_old - m_new) has an integer exponent."""
    m = torch.amax(int_ceil(x), dim=axis, keepdim=True)
    m = torch.clamp(m, min=NEG_INF)          # fully-masked rows stay finite
    ex = exp2(x - m)
    d = torch.sum(ex, dim=axis, keepdim=True)
    return _safe_div(ex, d)


def softermax_online_scan(x: torch.Tensor, block: int = 128) -> torch.Tensor:
    """Block-online Softermax over the last axis, as the Unnormed Softmax
    Unit streams it: per-slice IntMax and local power-of-two sums, the
    running sum renormalized by an exact power of two (the shift), then
    the Normalization Unit's pass."""
    *lead, V = x.shape
    pad = (-V) % block
    if pad:
        x = F.pad(x, (0, pad), value=NEG_INF)
    Vp = x.shape[-1]
    xb = x.reshape(-1, Vp // block, block)
    rows = xb.shape[0]
    m = torch.full((rows,), NEG_INF, dtype=x.dtype, device=x.device)
    d = torch.zeros_like(m)
    for xv in xb.unbind(1):                          # (rows, block)
        m_new = torch.maximum(m, torch.amax(int_ceil(xv), dim=-1))
        local_d = torch.sum(exp2(xv - m_new[:, None]), dim=-1)
        d = d * pow2_int(m - m_new, xv.dtype) + local_d
        m = m_new
    y = _safe_div(exp2(xb.reshape(rows, Vp) - m[:, None]), d[:, None])
    return y.reshape(*lead, Vp)[..., :V]


def softermax_merge(m: torch.Tensor, d: torch.Tensor, acc: torch.Tensor,
                    axis: int = 0):
    """Combine partial Softermax states ``(m, d, acc)`` along ``axis``:

        m*   = max(m₁, m₂)
        d*   = d₁·2^(m₁-m*) + d₂·2^(m₂-m*)
        acc* = acc₁·2^(m₁-m*) + acc₂·2^(m₂-m*)

    Associative and commutative (exactly so for the rescales under IntMax),
    which is what makes split-K decode legal. Empty partitions carry the
    identity ``(NEG_INF, 0, 0)``; the ``d > 0`` select keeps the merge
    identity-exact. ``m`` and ``d`` carry a trailing singleton where ``acc``
    has the feature dim. Returns the merged state with ``axis`` removed."""
    m_star = torch.amax(m, dim=axis, keepdim=True)
    scale = torch.where(d > 0, exp2(m - m_star), torch.zeros_like(d))
    d_out = torch.sum(d * scale, dim=axis)
    acc_out = torch.sum(acc * scale, dim=axis)
    return m_star.squeeze(axis), d_out, acc_out


def softermax_finalize(acc: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    """Normalization Unit for a (merged) partial state: ``acc / d`` with
    fully-masked rows (d == 0) mapped to 0."""
    return _safe_div(acc, d)


def softermax_fixed(x: torch.Tensor,
                    bitwidths: Optional[quant.SoftermaxBitwidths] = None,
                    block: int = 16) -> torch.Tensor:
    """Bit-faithful fixed-point Softermax with the paper's Table-I formats,
    over the last axis, ``block`` elements at a time (the hardware's
    VectorSize): input to Q(6,2) → IntMax → LPW power of two to Q(1,15) →
    PowSum accumulated in Q(10,6) with shift renormalization → LPW
    reciprocal in Q(1,7) → output multiply quantized to Q(1,7).

    As the reference, the numerators are quantized against the *running*
    max of their block and then shifted to the final max, the pad holds
    ``bitwidths.inp.min_value`` and the running max starts at the default
    Q(6,2) minimum. Differentiable through the STEs; the running maxima
    (ceils) carry no gradient. The PowSum recurrence rounds at every block,
    so it walks the blocks in order; everything else is computed for all
    blocks at once."""
    bw = bitwidths or quant.DEFAULT_BITWIDTHS
    *lead, V = x.shape
    xq = bw.inp.quantize(x)                          # Q(6,2) input
    pad = (-V) % block
    if pad:
        xq = F.pad(xq, (0, pad), value=bw.inp.min_value)
    Vp = xq.shape[-1]
    xb = xq.reshape(-1, Vp // block, block)
    rows = xb.shape[0]
    run_m = _running_block_intmax(
        xb, float(quant.DEFAULT_BITWIDTHS.inp.min_value))  # (rows, nblocks)
    # LPW 2^(x - m_running): unnormed numerators in Q(1,15)
    un = quant.lpw_exp2(xb - run_m[..., None], out_fmt=bw.unnormed)
    local_d = torch.sum(un, dim=-1)                  # exact: dyadic values
    m = torch.full((rows,), float(quant.DEFAULT_BITWIDTHS.inp.min_value),
                   dtype=xb.dtype, device=xb.device)
    d = torch.zeros((rows,), dtype=xb.dtype, device=xb.device)
    for b in range(run_m.shape[1]):
        m_new = run_m[:, b]
        shift = quant.pow2_exact(m - m_new).to(xb.dtype)
        d = bw.powsum.quantize(d * shift + local_d[:, b])
        m = m_new
    # Normalization Unit: shift each block's numerators to the final max,
    # then multiply by the LPW reciprocal of the PowSum
    shift = quant.pow2_exact(run_m - m[:, None]).to(xb.dtype)
    un = (un * shift[..., None]).reshape(rows, Vp)
    recip = quant.lpw_reciprocal(d, out_fmt=bw.recip)
    y = bw.outp.quantize(un * recip[:, None])
    y = torch.where(d[:, None] > 0, y, torch.zeros_like(y))
    return y.reshape(*lead, Vp)[..., :V]


def _running_block_intmax(xb: torch.Tensor, init_m: float) -> torch.Tensor:
    """Running IntMax after each block (rows, nblocks): the max of
    ``init_m`` and the ceils of every block so far."""
    local_m = torch.amax(torch.ceil(xb.detach()), dim=-1)
    return torch.cummax(torch.clamp(local_m, min=init_m), dim=1).values


_KERNEL_IMPLS = ("base2", "softermax", "softermax_fixed")


def attention_softmax(scores: torch.Tensor, impl: str = "softermax",
                      axis: int = -1) -> torch.Tensor:
    """The dispatch every model uses: impl in {"softmax" (base e), "base2",
    "base2_folded", "softermax" (the paper), "softermax_fixed"
    (bit-faithful QAT)}. On a CUDA tensor "softermax" and "base2" go to the
    row kernel K6 (IntMax on and off) and "softermax_fixed" to K7; they
    launch or raise. The base-e softmax and the folded base 2 stay plain:
    K6 computes base 2 only."""
    if scores.is_cuda and impl in _KERNEL_IMPLS:
        return _attention_softmax_kernel(scores, impl, axis)
    if impl == "softmax":
        return softmax_e(scores, axis=axis)
    if impl == "base2":
        return softmax_base2(scores, axis=axis)
    if impl == "base2_folded":
        return softmax_base2(scores, axis=axis, fold_log2e=True)
    if impl == "softermax":
        return softermax(scores, axis=axis)
    if impl == "softermax_fixed":
        moved = axis not in (-1, scores.ndim - 1)
        if moved:
            scores = torch.movedim(scores, axis, -1)
        shape = scores.shape
        out = softermax_fixed(scores.reshape(-1, shape[-1])).reshape(shape)
        return torch.movedim(out, -1, axis) if moved else out
    raise ValueError(f"unknown softmax impl: {impl!r}")


def _attention_softmax_kernel(scores, impl, axis):
    # imported here: the kernels' plain versions import this module
    from repro_torch.kernels.softermax import softermax_op
    from repro_torch.kernels.softermax_quant import softermax_quant_op
    moved = axis not in (-1, scores.ndim - 1)
    x = torch.movedim(scores, axis, -1) if moved else scores
    if impl == "softermax_fixed":
        y = softermax_quant_op(x)
    else:
        y = softermax_op(x, intmax=impl == "softermax")
    return torch.movedim(y, -1, axis) if moved else y


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with fully-masked rows (den == 0) mapped to 0, not nan."""
    pos = den > 0
    q = num / torch.where(pos, den, torch.ones_like(den))
    return torch.where(pos, q, torch.zeros_like(q))
