"""Plain PyTorch version of the per-query-head paged decode kernel (K8).

``paged_decode_single_plain`` mirrors the function of the TPU kernel
``flash_decode_paged_single`` (``_paged_decode_kernel_single``) and of its
CUDA port ``csrc/flash_decode_paged_single.cu``: every query head walks its
own sequence's block table one pool block per step, in table order, reading
its GQA group's K/V block for itself. Per block:

    s = q·K_blk (fp32; times k_scale for int8 pools), masked past the length
    m_new = max(m, ceil(max s))          (max s without IntMax)
    alpha = 2^(m - m_new), p = 2^(s - m_new)
    acc = acc·alpha + (p·v_scale)·V_blk,  d = d·alpha + sum p

and at the end ``acc / d`` with ``d == 0`` mapped to 0. Blocks that start at
or past a row's length are skipped (the kernel's ``pl.when``), so a row of
length 0 returns 0 — as the TPU kernel does, and unlike ``paged_decode_ref``,
which spreads such a row uniformly over its garbage block.

Vectorised over ``B·Hq``; the table width is walked in Python.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import NEG_INF
from repro_torch.core.softermax import softermax_finalize


def paged_decode_single_plain(q, k_pool, v_pool, block_tables, lengths, *,
                              k_scale=None, v_scale=None,
                              intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled; pools (N, Hkv, BS, D); int8 scales
    (N, Hkv, BS); tables (B, nb); lengths (B,) → (B, Hq, D) in q's dtype."""
    B, Hq, D = q.shape
    _, Hkv, BS, _ = k_pool.shape
    nb = block_tables.shape[1]
    dev = q.device
    qf = q.float()
    lens = lengths.to(device=dev, dtype=torch.int64)
    bt = block_tables.to(device=dev, dtype=torch.int64)
    head = (torch.arange(Hq, device=dev) // (Hq // Hkv))[None, :]  # KV head
    m = torch.full((B, Hq), NEG_INF, dtype=torch.float32, device=dev)
    d = torch.zeros((B, Hq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hq, D), dtype=torch.float32, device=dev)
    cols = torch.arange(BS, device=dev)
    n_live = min(nb, -(-int(lens.max()) // BS)) if B else 0
    for j in range(n_live):
        live = j * BS < lens                              # (B,)
        # a block past the length is never read: its table entry may be
        # garbage
        blk = torch.where(live, bt[:, j], torch.zeros_like(bt[:, j]))
        idx = (blk[:, None], head)                        # (B, Hq) gather
        k = k_pool[idx].float()                           # (B, Hq, BS, D)
        v = v_pool[idx].float()
        s = torch.einsum("bhd,bhrd->bhr", qf, k)
        if k_scale is not None:
            s = s * k_scale[idx].float()
        valid = (j * BS + cols)[None, :] < lens[:, None]  # (B, BS)
        s = torch.where(valid[:, None, :], s, torch.full_like(s, NEG_INF))
        mx = torch.amax(s, dim=-1)
        m_new = torch.maximum(m, torch.ceil(mx) if intmax else mx)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        pv = p * v_scale[idx].float() if v_scale is not None else p
        acc_new = acc * alpha[..., None] + torch.einsum("bhr,bhrd->bhd",
                                                        pv, v)
        d_new = d * alpha + p.sum(-1)
        keep = live[:, None]
        acc = torch.where(keep[..., None], acc_new, acc)
        d = torch.where(keep, d_new, d)
        m = torch.where(keep, m_new, m)
    return softermax_finalize(acc, d[..., None]).to(q.dtype)
