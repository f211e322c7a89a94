"""Bit-faithful fixed-point Softermax (K7, the ``softermax_fixed`` path)
with its plain PyTorch mirrors, its oracle and the dispatcher."""
from repro_torch.kernels.softermax_quant.ops import (REG_CAP,
                                                     register_route,
                                                     softermax_quant_op,
                                                     softermax_quant_rows)
from repro_torch.kernels.softermax_quant.plain import (
    lpw_numerator, softermax_quant_plain, softermax_quant_reg_plain)
from repro_torch.kernels.softermax_quant.ref import softermax_quant_ref

__all__ = ["REG_CAP", "lpw_numerator", "register_route",
           "softermax_quant_op", "softermax_quant_rows",
           "softermax_quant_plain", "softermax_quant_reg_plain",
           "softermax_quant_ref"]
