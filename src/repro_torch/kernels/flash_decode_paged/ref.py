"""Plain PyTorch versions of the paged decode kernel.

``gather_kv`` materializes a request's logical cache from the pool through
its block table; ``paged_decode_ref`` is then the closed-form Softermax
decode (``flash_decode.ref.decode_ref``) on the gathered cache — the CPU
execution path of the serving engine. KV is gathered once per *KV* head
and queries are reshaped to ``(B, Hkv, group, …)``, so KV is never
expanded across the query group.

``paged_decode_split_ref`` mirrors the kernel's split-K structure: the
padded KV walk is cut into ``split_k`` partitions, each reduced to its
partial ``(m, d, acc)`` in closed form, merged with ``softermax_merge`` —
including the identity ``(NEG_INF, 0, 0)`` of partitions that sit wholly
past a sequence's length.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.numerics import NEG_INF
from repro_torch.core.softermax import softermax_finalize, softermax_merge
from repro_torch.kernels.flash_decode.ref import decode_ref


def split_layout(W: int, kv_tile_blocks: int, split_k: int):
    """THE clamped tile/split geometry for a table of ``W`` blocks —
    ``(T, S, spl, Wp)``: T blocks per kv tile, S split lanes of ``spl``
    tiles each, table padded to ``Wp = S*spl*T`` blocks. The kernel
    wrappers and the split version partition identically through it."""
    T = max(1, min(kv_tile_blocks, W))
    tiles = -(-W // T)
    S = max(1, min(split_k, tiles))
    spl = -(-tiles // S)
    return T, S, spl, S * spl * T


def pad_table(block_tables: torch.Tensor, Wp: int) -> torch.Tensor:
    """(B, W) table padded to (B, Wp) int32 with garbage block 0."""
    bt = block_tables.to(torch.int32)
    if Wp == bt.shape[1]:
        return bt.contiguous()
    return F.pad(bt, (0, Wp - bt.shape[1])).contiguous()


def gather_kv(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, BS, D) pool + (B, nb) table -> (B, Hkv, nb*BS, D) caches."""
    B, nb = block_tables.shape
    _, Hkv, BS, D = pool.shape
    g = pool[block_tables.long()]             # (B, nb, Hkv, BS, D)
    return g.movedim(2, 1).reshape(B, Hkv, nb * BS, D)


def gather_scales(scales: torch.Tensor,
                  block_tables: torch.Tensor) -> torch.Tensor:
    """(N, Hkv, BS) scale pool + (B, nb) table -> (B, Hkv, nb*BS)."""
    B, nb = block_tables.shape
    _, Hkv, BS = scales.shape
    g = scales[block_tables.long()]           # (B, nb, Hkv, BS)
    return g.movedim(2, 1).reshape(B, Hkv, nb * BS)


def gather_kv_dequant(pool: torch.Tensor, scales, block_tables: torch.Tensor,
                      dtype=torch.float32) -> torch.Tensor:
    """Gather + (optional) int8 dequant; ``scales=None`` is the plain path
    and returns the pool's own dtype."""
    g = gather_kv(pool, block_tables)
    if scales is None:
        return g
    s = gather_scales(scales, block_tables)
    return (g.float() * s[..., None].float()).to(dtype)


def paged_decode_ref(q, k_pool, v_pool, block_tables, lengths, *,
                     k_scale=None, v_scale=None,
                     intmax: bool = True) -> torch.Tensor:
    k = gather_kv_dequant(k_pool, k_scale, block_tables)
    v = gather_kv_dequant(v_pool, v_scale, block_tables)
    return decode_ref(q, k, v, lengths, intmax=intmax)


def paged_decode_split_ref(q, k_pool, v_pool, block_tables, lengths, *,
                           split_k: int = 1, kv_tile_blocks: int = 1,
                           k_scale=None, v_scale=None,
                           intmax: bool = True) -> torch.Tensor:
    """Partition-structured version of the split-K kernel (see module
    docstring). Equal to ``paged_decode_ref`` up to fp reduction order."""
    B, Hq, D = q.shape
    _, Hkv, BS, _ = k_pool.shape
    W = block_tables.shape[1]
    G = Hq // Hkv
    _, S, _, Wp = split_layout(W, kv_tile_blocks, split_k)
    bt = pad_table(block_tables, Wp)
    k = gather_kv_dequant(k_pool, k_scale, bt).float()  # (B, Hkv, Wp*BS, D)
    v = gather_kv_dequant(v_pool, v_scale, bt).float()
    P = (Wp * BS) // S                                   # columns per lane
    k = k.reshape(B, Hkv, S, P, D)
    v = v.reshape(B, Hkv, S, P, D)
    qg = q.reshape(B, Hkv, G, D).float()
    s = torch.einsum("bhgd,bhspd->bhgsp", qg, k)
    kj = torch.arange(Wp * BS, dtype=torch.int32,
                      device=q.device).reshape(S, P)
    valid = kj[None] < lengths.to(torch.int32)[:, None, None]   # (B, S, P)
    valid = valid[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)              # (B, Hkv, G, S, 1)
    m = torch.ceil(m) if intmax else m
    # masked columns contribute exactly 0, but a *fully* masked partition
    # would see exp2(0) = 1 per column — zero those explicitly so empty
    # partitions carry the merge identity
    p = torch.where(valid, torch.exp2(s - m), torch.zeros_like(s))
    d = torch.sum(p, dim=-1, keepdim=True)
    m = torch.where(d > 0, m, torch.full_like(m, NEG_INF))
    acc = torch.einsum("bhgsp,bhspd->bhgsd", p, v)
    _, d2, acc2 = softermax_merge(m, d, acc, axis=3)
    o = softermax_finalize(acc2, d2)                     # (B, Hkv, G, D)
    return o.reshape(B, Hq, D).to(q.dtype)
