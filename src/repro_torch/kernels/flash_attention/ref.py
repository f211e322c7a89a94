"""Full-matrix oracle for flash attention: the whole score matrix with the
same softmax variant. Queries sit at the end of the KV axis (the causal
mask is ``qi + Sk - Sq >= kj``). Differentiable, so its autograd gradient
is the cross-check of the flash backward."""
from __future__ import annotations

import torch

from repro_torch.core.numerics import NEG_INF
from repro_torch.core.softermax import softermax, softmax_base2


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D) pre-scaled; k, v (B, Hkv, Sk, D) → (B, Hq, Sq, D)
    in q's dtype; all math in fp32."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    s = qg @ k.float()[:, :, None].transpose(-1, -2)     # (B,Hkv,G,Sq,Sk)
    if causal:
        dev = q.device
        qi = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
        kj = torch.arange(Sk, device=dev)[None, :]
        s = torch.where(qi >= kj, s, torch.full_like(s, NEG_INF))
    p = softermax(s, axis=-1) if intmax else softmax_base2(s, axis=-1)
    o = p @ v.float()[:, :, None]
    return o.reshape(B, Hq, Sq, D).to(q.dtype)
