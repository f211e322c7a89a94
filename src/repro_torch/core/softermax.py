"""Softermax algorithm variants on torch tensors (the serving subset).

The same semantics as the JAX package's ``repro.core.softermax``: every
function works over the last axis (or the named one), masked positions
carry ``numerics.NEG_INF`` (finite) so online recurrences stay nan-free, and
fully-masked rows produce all-zero outputs.

* ``softmax_base2``      — base replacement: 2^x instead of e^x (§III.A);
  ``fold_log2e=True`` makes it equal to the e-base softmax.
* ``softermax``          — base-2 + integer max, closed form (§III.C).
* ``softermax_merge``    — exact combine of partial online states (split-K).
* ``softermax_finalize`` — the Normalization Unit, ``acc / d`` with d == 0 → 0.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import LOG2_E, NEG_INF, exp2, int_ceil


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


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """num/den with fully-masked rows (den == 0) mapped to 0, not nan."""
    pos = den > 0
    q = num / torch.where(pos, den, torch.ones_like(den))
    return torch.where(pos, q, torch.zeros_like(q))
