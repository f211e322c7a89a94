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

``lane_blocks`` is THE lane layout of the bulk-copy route
(``csrc/paged_decode_bulk.cuh``): lanes split a row's LIVE blocks
(``ceil(len / BS)``, at most the table width) in equal shares of whole
blocks, not the padded table; ``paged_decode_live_split_ref`` is the split
version with that layout on the caller's count of lanes, merged in order
with ``softermax_merge``. How many lanes the card launches is the kernel
wrapper's choice (``ops.live_lanes``).

``decode_gather_oracle`` MEASURES the gather traffic of one decode launch
as the TPU kernel moves it (every padded table entry, block 0 included),
off the shapes of the gathers it actually runs; the analytic model
``serve/kernel_costs.py`` is pinned against it.
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


def lane_blocks(length: int, BS: int, W: int, n: int):
    """The blocks ``[start, stop)`` each of ``n`` lanes walks of a row of
    ``length`` tokens in a table of ``W`` blocks: equal shares of the row's
    live blocks, the first ``live % n`` lanes one block more. The kernel
    computes the same on the card from ``lengths[b]``."""
    live = min(-(-max(length, 0) // BS), W)
    base, rem = divmod(live, n)
    out = []
    for j in range(n):
        start = j * base + min(j, rem)
        out.append((start, start + base + (j < rem)))
    return out


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


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def decode_gather_oracle(k_pool, v_pool, block_tables, lengths, *,
                         kv_tile_blocks: int = 1, split_k: int = 1,
                         k_scale=None, v_scale=None) -> dict:
    """Pad the table exactly as the kernel wrapper does (``split_layout``),
    run the gathers on it, and count bytes off the gathered tensors.

    Returns ``{"gather_bytes", "useful_bytes", "waste_bytes",
    "grid_steps", "padded_width"}``; waste counts table entries at or past
    each row's real block cover ``ceil(len/BS)`` (pow2 bucketing, tile
    padding, dead tail blocks alike), int8 scale siblings included."""
    B, W = block_tables.shape
    _, Hkv, BS, D = k_pool.shape
    _, S, spl, Wp = split_layout(W, kv_tile_blocks, split_k)
    bt = pad_table(block_tables, Wp)
    gk = gather_kv(k_pool, bt)                # the real takes: bytes come
    gv = gather_kv(v_pool, bt)                # off their shapes
    gather = _nbytes(gk) + _nbytes(gv)
    per_block = gk.element_size() * BS * D * 2
    if k_scale is not None:
        gks = gather_scales(k_scale, bt)
        gvs = gather_scales(v_scale, bt)
        gather += _nbytes(gks) + _nbytes(gvs)
        per_block += gks.element_size() * BS * 2
    useful_blocks = sum(min(-(-int(ln) // BS), Wp) for ln in list(lengths))
    useful = useful_blocks * Hkv * per_block
    return {"gather_bytes": gather, "useful_bytes": useful,
            "waste_bytes": gather - useful, "grid_steps": B * Hkv * S * spl,
            "padded_width": Wp}


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


def paged_decode_live_split_ref(q, k_pool, v_pool, block_tables, lengths, *,
                                n_lanes: int = 1, k_scale=None, v_scale=None,
                                intmax: bool = True) -> torch.Tensor:
    """Lane-structured version of the bulk-copy route: each of the
    ``n_lanes`` lanes reduces its share of the
    row's live blocks (``lane_blocks``) to a partial ``(m, d, acc)`` in
    closed form — the merge identity ``(NEG_INF, 0, 0)`` where it holds no
    block — and the lanes merge with ``softermax_merge``. Table entries past
    a row's live blocks are never read. Equal to ``paged_decode_ref`` up to
    fp reduction order, and a row of length 0 is 0."""
    B, Hq, D = q.shape
    _, Hkv, BS, _ = k_pool.shape
    W = block_tables.shape[1]
    G, n = Hq // Hkv, n_lanes
    dev = q.device
    lens = lengths.to(device=dev, dtype=torch.int64).clamp(0, W * BS)
    live = (lens + BS - 1) // BS                         # (B,) live blocks
    blk = torch.arange(W, device=dev)[None]              # (1, W)
    bt = torch.where(blk < live[:, None], block_tables.to(dev).long(),
                     torch.zeros_like(blk))
    k = gather_kv_dequant(k_pool, k_scale, bt).float()   # (B, Hkv, W*BS, D)
    v = gather_kv_dequant(v_pool, v_scale, bt).float()
    # lane of every block: the first rem lanes hold base + 1 blocks
    base, rem = (live // n)[:, None], (live % n)[:, None]
    big = rem * (base + 1)
    lane = torch.where(blk < big, blk // (base + 1),
                       rem + (blk - big) // base.clamp(min=1))
    lane = lane.repeat_interleave(BS, dim=1)             # (B, W*BS)
    valid = torch.arange(W * BS, device=dev)[None] < lens[:, None]
    own = valid[:, None] & (lane[:, None] ==
                            torch.arange(n, device=dev)[None, :, None])
    own = own[:, None, None]                             # (B, 1, 1, n, C)
    s = torch.einsum("bhgd,bhcd->bhgc", q.reshape(B, Hkv, G, D).float(),
                     k)[:, :, :, None]                   # (B, Hkv, G, 1, C)
    s = torch.where(own, s, torch.full_like(s, NEG_INF))
    m = torch.amax(s, dim=-1, keepdim=True)              # (B, Hkv, G, n, 1)
    m = torch.ceil(m) if intmax else m
    p = torch.where(own, torch.exp2(s - m), torch.zeros_like(s))
    d = torch.sum(p, dim=-1, keepdim=True)
    m = torch.where(d > 0, m, torch.full_like(m, NEG_INF))
    acc = torch.einsum("bhgnc,bhcd->bhgnd", p, v)
    _, d2, acc2 = softermax_merge(m, d, acc, axis=3)
    return softermax_finalize(acc2, d2).reshape(B, Hq, D).to(q.dtype)
