"""Plain PyTorch version of the contiguous-cache decode kernel (K5).

``decode_ref`` is the closed-form Softermax decode over a contiguous
``(B, Hkv, S, D)`` cache whose first ``lengths[b]`` rows are live — the
JAX package's ``repro.kernels.flash_decode.ref.decode_ref``. The CPU runs
it in place of the kernel; on the card it is what the kernel is held to.
Queries are reshaped to ``(B, Hkv, group, D)``, so KV is never expanded
across the query group.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import NEG_INF
from repro_torch.core.softermax import softermax, softmax_base2


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor, *, intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled, k/v (B, Hkv, S, D), lengths (B,) →
    (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = qg @ k.float().transpose(-1, -2)              # (B, Hkv, G, S)
    mask = (torch.arange(S, device=q.device)[None, :] <
            lengths.to(q.device)[:, None])[:, None, None, :]
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    p = softermax(s) if intmax else softmax_base2(s)
    o = p @ v.float()
    return o.reshape(B, Hq, D).to(q.dtype)
