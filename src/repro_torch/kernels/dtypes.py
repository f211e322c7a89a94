"""dtype codes shared with the CUDA entry points (``csrc/common.cuh``)."""
from __future__ import annotations

import torch

_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def q_code(dtype: torch.dtype) -> int:
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"queries must be float32 or bfloat16, got {dtype}")
    return _CODES[dtype]


def kv_code(dtype: torch.dtype) -> int:
    if dtype not in _CODES:
        raise ValueError(f"KV pools must be float32, bfloat16 or int8, "
                         f"got {dtype}")
    return _CODES[dtype]


def row_code(dtype: torch.dtype, name: str) -> int:
    """The code of a row kernel's input (K6, K7): float32 or bfloat16."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{name}: rows must be float32 or bfloat16, got "
                         f"{dtype}")
    return _CODES[dtype]
