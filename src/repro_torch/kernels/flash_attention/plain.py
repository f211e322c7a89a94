"""Plain PyTorch versions of the dense flash-attention kernels (K3, K4).

Both walk the KV axis in tiles, as the kernels do, with every query row at
once: a row that cannot see a tile gets an all-``NEG_INF`` score slice,
which leaves its running max alone and adds ``p = 0``, so the result is
that of skipping the tile. All math is fp32, as in the kernels and the
reference.

* ``flash_attention_plain`` — the forward: the Softermax online recurrence
  over KV tiles, returning ``o`` and, with ``return_stats``, the row
  statistics ``(m, d)`` (B, Hq, Sq, 1) fp32.
* ``flash_attention_bwd_plain`` — the backward from the saved ``(m, d)``:
  ``p = 2^(s-m)/max(d, 1e-30)``, ``delta = Σ dO·O``, ``dS = ln2·p·(dP −
  delta)``; dK and dV are summed over each KV head's query heads (GQA).
* ``split_bf16`` — how the tensor-core kernels carry an f32 operand (``p``
  and ``dS``) into a bf16 ``wgmma``: as three bf16 terms whose sum is the
  f32 value.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import LN_2, NEG_INF

KV_TILE = 64     # the kernels' KV tile


def split_bf16(x: torch.Tensor) -> tuple:
    """f32 ``x`` as three bf16 tensors ``(hi, mid, lo)``, each the bf16
    rounding of what the earlier ones left (``hi = bf16(x)``, ``mid =
    bf16(x - hi)``, ``lo = bf16(x - hi - mid)``; every difference is exact
    in f32), each holding 8 of x's 24 significant bits. ``hi + mid + lo``
    equals ``x`` exactly for |x| >= 2^-110, and is within 2^-134, half the
    smallest bf16 subnormal, below; the pair ``hi + mid`` alone is within
    2^-16·|x| (or that 2^-134). The tensor-core kernels feed ``p`` and
    ``dS`` to ``wgmma`` as these three terms."""
    out, rest = [], x.float()
    for _ in range(3):
        t = rest.to(torch.bfloat16)
        out.append(t)
        rest = rest - t.float()
    return tuple(out)


def _causal_mask(s, k0, Sq, Sk, causal):
    if not causal:
        return s
    dev = s.device
    qi = torch.arange(Sq, device=dev)[:, None] + (Sk - Sq)
    kj = k0 + torch.arange(s.shape[-1], device=dev)[None, :]
    return torch.where(qi >= kj, s, torch.full_like(s, NEG_INF))


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          *, causal: bool = True, intmax: bool = True,
                          block_k: int = KV_TILE,
                          return_stats: bool = False):
    """q (B, Hq, Sq, D) pre-scaled; k, v (B, Hkv, Sk, D) → o (B, Hq, Sq, D)
    in q's dtype [, m, d (B, Hq, Sq, 1) fp32]."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    qg = q.reshape(B, Hkv, G, Sq, D).float()
    m = torch.full((B, Hkv, G, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=q.device)
    d = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, G, Sq, D), dtype=torch.float32,
                      device=q.device)
    for k0 in range(0, Sk, block_k):
        kt = k[:, :, None, k0:k0 + block_k].float()
        vt = v[:, :, None, k0:k0 + block_k].float()
        s = _causal_mask(qg @ kt.transpose(-1, -2), k0, Sq, Sk, causal)
        sl = torch.ceil(s) if intmax else s
        m_new = torch.maximum(m, torch.amax(sl, dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        acc = acc * alpha + p @ vt
        d = d * alpha + torch.sum(p, dim=-1, keepdim=True)
        m = m_new
    pos = d > 0
    recip = torch.where(pos, 1.0 / torch.where(pos, d, torch.ones_like(d)),
                        torch.zeros_like(d))
    o = (acc * recip).reshape(B, Hq, Sq, D).to(q.dtype)
    if return_stats:
        return o, m.reshape(B, Hq, Sq, 1), d.reshape(B, Hq, Sq, 1)
    return o


def flash_attention_bwd_plain(q, k, v, o, do, m, d, *, causal: bool = True,
                              block_k: int = KV_TILE):
    """Gradients (dq, dk, dv) in the dtypes of (q, k, v); dk and dv
    (B, Hkv, Sk, D) summed over the query heads of each KV head."""
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv

    def grouped(t):
        return t.reshape(B, Hkv, G, Sq, t.shape[-1]).float()

    qg, og, dog = grouped(q), grouped(o), grouped(do)
    mg, dg = grouped(m), torch.clamp(grouped(d), min=1e-30)
    delta = torch.sum(dog * og, dim=-1, keepdim=True)
    dq = torch.zeros_like(qg)
    dks, dvs = [], []
    for k0 in range(0, Sk, block_k):
        kt = k[:, :, None, k0:k0 + block_k].float()
        vt = v[:, :, None, k0:k0 + block_k].float()
        s = _causal_mask(qg @ kt.transpose(-1, -2), k0, Sq, Sk, causal)
        p = torch.exp2(s - mg) / dg                      # masked → 0
        dp = dog @ vt.transpose(-1, -2)
        ds = LN_2 * p * (dp - delta)
        dvs.append(torch.sum(p.transpose(-1, -2) @ dog, dim=2))
        dks.append(torch.sum(ds.transpose(-1, -2) @ qg, dim=2))
        dq = dq + ds @ kt
    dk = torch.cat(dks, dim=2).to(k.dtype)
    dv = torch.cat(dvs, dim=2).to(v.dtype)
    return dq.reshape(B, Hq, Sq, D).to(q.dtype), dk, dv
