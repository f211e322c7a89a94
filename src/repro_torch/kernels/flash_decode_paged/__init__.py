from repro_torch.kernels.flash_decode_paged.ops import (
    bulk_lanes, bulk_route, flash_decode_paged, flash_decode_paged_op,
    flash_decode_paged_single, flash_decode_paged_single_op, live_lanes)
from repro_torch.kernels.flash_decode_paged.plain import \
    paged_decode_single_plain
from repro_torch.kernels.flash_decode_paged.ref import (
    decode_gather_oracle, decode_ref, gather_kv, gather_kv_dequant,
    gather_scales, lane_blocks, pad_table, paged_decode_live_split_ref,
    paged_decode_ref, paged_decode_split_ref, split_layout)

__all__ = ["bulk_lanes", "bulk_route", "flash_decode_paged",
           "flash_decode_paged_op", "flash_decode_paged_single", "flash_decode_paged_single_op",
           "paged_decode_single_plain", "decode_gather_oracle", "decode_ref",
           "gather_kv", "gather_kv_dequant", "gather_scales", "lane_blocks",
           "live_lanes", "pad_table", "paged_decode_live_split_ref",
           "paged_decode_ref", "paged_decode_split_ref", "split_layout"]
