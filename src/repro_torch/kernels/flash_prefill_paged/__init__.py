from repro_torch.kernels.flash_prefill_paged.ops import (
    flash_prefill_paged, flash_prefill_paged_op)
from repro_torch.kernels.flash_prefill_paged.ref import (
    paged_prefill_ref, paged_prefill_split_ref, prefill_gather_oracle)

__all__ = ["flash_prefill_paged", "flash_prefill_paged_op",
           "paged_prefill_ref", "paged_prefill_split_ref",
           "prefill_gather_oracle"]
