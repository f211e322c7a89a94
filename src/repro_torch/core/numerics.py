"""Numeric helpers shared by the softermax implementations.

Base-2 exponentials are the paper's central numeric substitution: moving the
network itself to base 2 deletes the per-element ``log2(e)`` multiply that
hardware pays to evaluate ``e^x`` as ``2^(x*log2(e))``.
"""
from __future__ import annotations

import math

import torch

# exact in double precision; cast at use sites.
LOG2_E = math.log2(math.e)
LN_2 = math.log(2.0)

# A very negative (but finite, representable in bf16) score used for masking.
# -inf is avoided inside online recurrences: (-inf) - (-inf) = nan.
NEG_INF = -1e9


def exp2(x: torch.Tensor) -> torch.Tensor:
    """2**x elementwise."""
    return torch.exp2(x)


def pow2_int(k: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """2**k for *integer* k — the Softermax renormalization factor. ``exp2``
    of an exactly-integral float is exact in IEEE arithmetic, which is why
    the integer-max co-design makes the online renormalization lossless."""
    return torch.exp2(k.to(dtype))


def int_ceil(x: torch.Tensor) -> torch.Tensor:
    """Ceiling used by the IntMax unit (a float carrying an integral value)."""
    return torch.ceil(x)
