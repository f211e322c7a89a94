"""Decode attention over a contiguous KV cache (K5, the static engine's
decode kernel) with its plain PyTorch version and dispatcher."""
from repro_torch.kernels.flash_decode.ops import (bulk_route,
                                                  bulk_tile_rows,
                                                  flash_decode,
                                                  flash_decode_op,
                                                  split_lanes)
from repro_torch.kernels.flash_decode.ref import decode_ref

__all__ = ["bulk_route", "bulk_tile_rows", "flash_decode", "flash_decode_op",
           "split_lanes", "decode_ref"]
