from repro_torch.kernels.flash_decode_paged.ops import (flash_decode_paged,
                                                        flash_decode_paged_op)
from repro_torch.kernels.flash_decode_paged.ref import (
    decode_ref, gather_kv, gather_kv_dequant, gather_scales, pad_table,
    paged_decode_ref, paged_decode_split_ref, split_layout)

__all__ = ["flash_decode_paged", "flash_decode_paged_op", "decode_ref",
           "gather_kv", "gather_kv_dequant", "gather_scales", "pad_table",
           "paged_decode_ref", "paged_decode_split_ref", "split_layout"]
