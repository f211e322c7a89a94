"""Row-wise Softermax (K6, the float Softermax of the naive attention
path) with its plain PyTorch version and dispatcher."""
from repro_torch.kernels.softermax.ops import (REG_CAP, register_route,
                                               softermax_op, softermax_rows)
from repro_torch.kernels.softermax.ref import softermax_rows_ref

__all__ = ["REG_CAP", "register_route", "softermax_op", "softermax_rows",
           "softermax_rows_ref"]
