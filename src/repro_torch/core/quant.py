"""Fixed-point arithmetic, LPW function units and QAT utilities (§III.B),
on torch tensors: the JAX package's ``repro.core.quant``.

The paper's Table-I Q-formats, bit-faithful at the interfaces:

    Inp Q(6,2) | LocalMax Q(6,2) | Unnormed Q(1,15) | PowSum Q(10,6)
    | Recip Q(1,7) | Outp Q(1,7)

Q(i, f) has ``i`` integer bits (the sign included when signed) and ``f``
fractional bits. Values are floats snapped to the representable grid
(round half to even, saturating), which is bit-equivalent for these narrow
formats.

The linear-piecewise (LPW) units mirror the hardware:

* ``lpw_exp2``       — 4-segment LPW of 2^frac on [0, 1), shifted by the
  integer part. With Q(6,2) inputs frac(x·4) is always 0, so the slope LUT
  is unused and the unit is a 4-entry c-LUT (§IV.A).
* ``lpw_reciprocal`` — normalize to [1, 2) by a leading-one shift, 4-segment
  LPW of 1/m, shift back.

Every shift by an integer power of two is built from the exponent bits
(``pow2_exact``), so it is exact on every device: the reference documents
these shifts as exact, but XLA's CPU ``exp2`` is a few ulp off for integer
arguments of magnitude 13 and more. The two agree wherever a rounding does
not sit exactly on a tie (ROADMAP Queue 3).

Everything is differentiable through clipped straight-through estimators
(``xc + (q - xc).detach()``), so softermax-aware finetuning works as is.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Q-format fixed point with clipped STE.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Q(int_bits, frac_bits) fixed-point format."""

    int_bits: int
    frac_bits: int
    signed: bool = True

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def scale(self) -> float:
        return float(2.0 ** self.frac_bits)

    @property
    def max_value(self) -> float:
        if self.signed:
            return float(2.0 ** (self.int_bits - 1) - 1.0 / self.scale)
        return float(2.0 ** self.int_bits - 1.0 / self.scale)

    @property
    def min_value(self) -> float:
        return float(-(2.0 ** (self.int_bits - 1))) if self.signed else 0.0

    def quantize(self, x: torch.Tensor) -> torch.Tensor:
        """Round-to-nearest saturating quantization with a clipped-STE
        gradient: forward q, gradient d(clip)/dx (0 where saturated)."""
        xc = _clip(x, self.min_value, self.max_value)
        q = torch.round(xc * self.scale) / self.scale
        return xc + (q - xc).detach()

    def quantize_exact(self, x: torch.Tensor) -> torch.Tensor:
        """Quantization without STE (non-differentiable reference paths)."""
        xc = torch.clamp(x, self.min_value, self.max_value)
        return torch.round(xc * self.scale) / self.scale


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """``jnp.clip``'s value and gradient: min(max(x, lo), hi), whose
    gradient at x == lo or x == hi is 1/2, as JAX's max/min split a tie
    (``torch.clamp`` passes 1 there)."""
    lo_t = torch.full((), lo, dtype=x.dtype, device=x.device)
    hi_t = torch.full((), hi, dtype=x.dtype, device=x.device)
    return torch.minimum(torch.maximum(x, lo_t), hi_t)


@dataclasses.dataclass(frozen=True)
class SoftermaxBitwidths:
    """Paper Table I."""

    inp: QFormat = QFormat(6, 2, signed=True)
    localmax: QFormat = QFormat(6, 2, signed=True)
    unnormed: QFormat = QFormat(1, 15, signed=False)
    powsum: QFormat = QFormat(10, 6, signed=False)
    recip: QFormat = QFormat(1, 7, signed=False)
    outp: QFormat = QFormat(1, 7, signed=False)


DEFAULT_BITWIDTHS = SoftermaxBitwidths()


def pow2_exact(k: torch.Tensor) -> torch.Tensor:
    """2**k in float32 for integral float ``k`` in [-126, 127], built from
    the exponent bits: exact on every device (no gradient; every caller's
    exponent is a floor or a ceil, whose gradient is 0)."""
    e = (k.detach().to(torch.int32) + 127) << 23
    return e.view(torch.float32)


# ---------------------------------------------------------------------------
# LPW power-of-two unit (§IV.A, "Power of Two Unit").
# ---------------------------------------------------------------------------

_N_SEGMENTS = 4
# Endpoint-interpolation LUTs for 2^t on [0,1): c[k] = 2^(k/4), m[k] = slope.
_EXP2_C = np.array([2.0 ** (k / _N_SEGMENTS) for k in range(_N_SEGMENTS)])
_EXP2_M = np.array(
    [2.0 ** ((k + 1) / _N_SEGMENTS) - 2.0 ** (k / _N_SEGMENTS)
     for k in range(_N_SEGMENTS)])
# LUT entries are themselves stored in Q(1,15) in hardware.
_LUT_FMT = QFormat(1, 15, signed=False)
_EXP2_C_Q = np.round(_EXP2_C * _LUT_FMT.scale) / _LUT_FMT.scale
_EXP2_M_Q = np.round(_EXP2_M * _LUT_FMT.scale) / _LUT_FMT.scale


@functools.lru_cache(maxsize=32)
def _lut(table: tuple, dtype: torch.dtype, device: torch.device):
    return torch.tensor(table, dtype=dtype, device=device)


def _lut_select(seg: torch.Tensor, table, dtype) -> torch.Tensor:
    """4-entry LUT: each float64 entry rounded to ``dtype`` at use, as the
    reference's ``jnp.asarray(float(table[k]), dtype)``."""
    lut = _lut(tuple(float(v) for v in table), dtype, seg.device)
    return lut[seg.long()]


def lpw_exp2(t: torch.Tensor,
             out_fmt: QFormat = DEFAULT_BITWIDTHS.unnormed) -> torch.Tensor:
    """4-segment LPW approximation of 2^t for t <= 0, quantized to
    ``out_fmt``: t = ip + fr with fr in [0, 1), the LPW of 2^fr, shifted
    right by -ip (an exact power of two, the shift clamped at 2^-40)."""
    ip = torch.floor(t)
    fr = t - ip                                     # in [0, 1)
    x_scaled = fr * _N_SEGMENTS
    seg = torch.clamp(x_scaled.to(torch.int32), 0, _N_SEGMENTS - 1)
    u = x_scaled - seg.to(t.dtype)                  # 0 for Q(6,2) inputs
    c = _lut_select(seg, _EXP2_C_Q, t.dtype)
    m = _lut_select(seg, _EXP2_M_Q, t.dtype)
    lpw = m * u + c
    ip = torch.clamp(ip, -40.0, 127.0)      # t <= 0: only the lower clamp
    val = lpw * pow2_exact(ip).to(t.dtype)
    return out_fmt.quantize(val)


# ---------------------------------------------------------------------------
# LPW reciprocal unit (§IV.B, "Normalization Unit").
# ---------------------------------------------------------------------------

_RECIP_C = np.array([1.0 / (1.0 + k / _N_SEGMENTS)
                     for k in range(_N_SEGMENTS)])
_RECIP_M = np.array(
    [1.0 / (1.0 + (k + 1) / _N_SEGMENTS) - 1.0 / (1.0 + k / _N_SEGMENTS)
     for k in range(_N_SEGMENTS)])


def lpw_reciprocal(d: torch.Tensor,
                   out_fmt: QFormat = DEFAULT_BITWIDTHS.recip
                   ) -> torch.Tensor:
    """LPW 1/d for d > 0 (0 where d <= 0): normalize to [1, 2) by a
    leading-one shift, LPW, shift back. The mantissa reciprocal is
    quantized to ``out_fmt`` (Table I's Q(1,7) ``Recip.``); the un-shift
    is exact."""
    safe = torch.maximum(d, torch.full((), 2.0 ** -20, dtype=d.dtype,
                                       device=d.device))
    e = torch.floor(torch.log2(safe))              # leading-one position
    shift = pow2_exact(-e).to(d.dtype)
    mant = safe * shift                             # in [1, 2)
    x_scaled = (mant - 1.0) * _N_SEGMENTS
    seg = torch.clamp(x_scaled.to(torch.int32), 0, _N_SEGMENTS - 1)
    u = x_scaled - seg.to(d.dtype)
    c = _lut_select(seg, _RECIP_C, d.dtype)
    m = _lut_select(seg, _RECIP_M, d.dtype)
    recip_mant = out_fmt.quantize(m * u + c)        # in (0.5, 1]
    val = recip_mant * shift
    return torch.where(d > 0, val, torch.zeros_like(val))


def qformat_clip_count(x: torch.Tensor, fmt: QFormat,
                       where: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Number of entries a saturating cast to ``fmt`` would clip (the
    telemetry overflow counters); ``where`` masks entries that do not
    take part (e.g. causally invalid scores holding NEG_INF)."""
    hit = (x > fmt.max_value) | (x < fmt.min_value)
    if where is not None:
        hit = hit & where
    return torch.sum(hit)


# ---------------------------------------------------------------------------
# Int8 QAT with percentile calibration (§V, "99.999% percentile
# calibrator").
# ---------------------------------------------------------------------------


def _percentile(x: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(x, q)`` with linear interpolation over all of
    ``x``, step for step in float32 as JAX computes it (q / 100 and the
    index ``q · (n - 1)`` in float32; the last multiply-add fused, as
    XLA's CPU backend emits it — emulated in float64). It sorts and
    interpolates by hand: ``torch.quantile`` refuses inputs above 2^24
    elements."""
    flat = torch.sort(x.reshape(-1).float()).values
    f32 = dict(dtype=torch.float32, device=flat.device)
    n = torch.tensor(flat.numel(), **f32)
    pos = torch.tensor(q, **f32) / 100 * (n - 1)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1 - high_w
    low = torch.clamp(low, 0, n - 1).long()
    high = torch.clamp(high, 0, n - 1).long()
    lo_part = flat[low] * low_w
    return (flat[high].double() * high_w.double() + lo_part.double()).float()


def percentile_scale(x: torch.Tensor,
                     percentile: float = 99.999) -> torch.Tensor:
    """Symmetric int8 scale from the |x| percentile (the paper's
    calibrator)."""
    amax = _percentile(torch.abs(x), percentile)
    return torch.clamp(amax, min=1e-8) / 127.0


def fake_quant_int8(x: torch.Tensor, scale) -> torch.Tensor:
    """Symmetric int8 fake-quant with clipped STE (weights and
    activations)."""
    scale = torch.as_tensor(scale, dtype=x.dtype, device=x.device)
    xc = torch.minimum(torch.maximum(x, -127.0 * scale), 127.0 * scale)
    q = torch.round(xc / scale) * scale
    return xc + (q - xc).detach()


class Int8Calibrator:
    """Running percentile calibrator: ``observe`` calibration batches,
    then ``scale`` is fixed for QAT/finetuning."""

    def __init__(self, percentile: float = 99.999):
        self.percentile = percentile
        self._amaxes: list[float] = []

    def observe(self, x: torch.Tensor) -> None:
        self._amaxes.append(float(_percentile(torch.abs(x),
                                              self.percentile)))

    @property
    def scale(self) -> float:
        if not self._amaxes:
            raise ValueError("calibrator has no observations")
        return max(float(np.median(self._amaxes)), 1e-8) / 127.0
