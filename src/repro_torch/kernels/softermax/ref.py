"""The plain PyTorch version of the Softermax row kernel (K6): its closed
form, as the JAX package's ``repro.kernels.softermax.ref``."""
from __future__ import annotations

import torch

from repro_torch.core.softermax import softermax, softmax_base2


def softermax_rows_ref(x: torch.Tensor, intmax: bool = True) -> torch.Tensor:
    """Base-2 softmax over the last axis with an integer (IntMax) or a
    plain max."""
    if intmax:
        return softermax(x, axis=-1)
    return softmax_base2(x, axis=-1)
