from repro_torch.kernels.flash_attention.ops import (
    flash_attention, flash_attention_bwd, flash_attention_op,
    flash_attention_op_refbwd, scale_queries, tensor_core_route)
from repro_torch.kernels.flash_attention.plain import (
    flash_attention_bwd_plain, flash_attention_plain, split_bf16)
from repro_torch.kernels.flash_attention.ref import attention_ref

__all__ = ["flash_attention", "flash_attention_bwd", "flash_attention_op",
           "flash_attention_op_refbwd", "scale_queries",
           "tensor_core_route", "flash_attention_plain",
           "flash_attention_bwd_plain", "split_bf16", "attention_ref"]
