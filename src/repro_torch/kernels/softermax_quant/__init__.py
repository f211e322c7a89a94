"""Bit-faithful fixed-point Softermax (K7, the ``softermax_fixed`` path)
with its plain PyTorch mirror, its oracle and the dispatcher."""
from repro_torch.kernels.softermax_quant.ops import (softermax_quant_op,
                                                     softermax_quant_rows)
from repro_torch.kernels.softermax_quant.plain import softermax_quant_plain
from repro_torch.kernels.softermax_quant.ref import softermax_quant_ref

__all__ = ["softermax_quant_op", "softermax_quant_rows",
           "softermax_quant_plain", "softermax_quant_ref"]
