"""Oracle of the fixed-point kernel (K7): the block-online fixed-point
Softermax of ``core.softermax``, as the JAX package's
``repro.kernels.softermax_quant.ref``.

On rounding points: ``softermax_fixed`` quantizes the unnormed numerators
at the *running* max and then shifts them by an exact power of two; the
kernel (like the silicon, and like its mirror ``plain.py``) recomputes each
numerator against the *final* max. The two can differ by 1 ulp of Q(1,15)
at ties, which after the Q(1,7) output quantization is at most one output
step, 2^-7: the contract between the kernel and this oracle.
"""
from __future__ import annotations

import torch

from repro_torch.core.softermax import softermax_fixed


def softermax_quant_ref(x: torch.Tensor,
                        vector_size: int = 16) -> torch.Tensor:
    return softermax_fixed(x, block=vector_size)
