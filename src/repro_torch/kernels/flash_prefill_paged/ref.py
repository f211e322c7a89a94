"""Plain PyTorch versions of the paged chunked-prefill kernel.

``paged_prefill_ref`` materializes each sequence's logical KV through its
block table and runs the closed-form Softermax with the positional causal
mask — logical column ``j`` is visible to query row ``pos0 + i`` iff
``j <= pos0 + i``. That one mask covers the prefix, the chunk's causal
triangle and the unwritten tail of the last block.

``paged_prefill_split_ref`` is the CPU execution path of the serving
engine's chunked prefill: the same attention, but the leading prefix
blocks — provably below every query position under the engine's table
bucketing — skip the mask compare and select; only a static-size tail
region is masked.

``prefill_gather_oracle`` MEASURES one launch's gather traffic as the TPU
kernel moves it (the kv walk re-streamed once per query tile); the
analytic model ``serve/kernel_costs.py`` is pinned against it.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import NEG_INF
from repro_torch.kernels.flash_decode_paged.ref import (_nbytes, gather_kv,
                                                        gather_kv_dequant,
                                                        gather_scales,
                                                        pad_table,
                                                        split_layout)


def _recip(d: torch.Tensor) -> torch.Tensor:
    pos = d > 0
    return torch.where(pos, 1.0 / torch.where(pos, d, torch.ones_like(d)),
                       torch.zeros_like(d))


def prefill_gather_oracle(k_pool, v_pool, block_tables, q_pos0, q_len: int,
                          *, kv_tile_blocks: int = 1, block_q: int = 128,
                          cover_blocks=None, k_scale=None,
                          v_scale=None) -> dict:
    """Pad the table as the kernel wrapper does, run the gathers of ONE kv
    walk, and multiply by the query tiles ``nq`` (the grid ``(B*Hkv, nq,
    nk)`` re-streams the walk once per query tile). ``cover_blocks`` (B,)
    are the REAL table entries per row; by default the exact cover of
    ``pos0 + q_len`` positions."""
    B, W = block_tables.shape
    _, Hkv, BS, D = k_pool.shape
    _, _, nk, Wp = split_layout(W, kv_tile_blocks, 1)
    BQ = min(block_q, q_len)
    nq = -(-q_len // BQ)
    bt = pad_table(block_tables, Wp)
    gk = gather_kv(k_pool, bt)
    gv = gather_kv(v_pool, bt)
    walk = _nbytes(gk) + _nbytes(gv)
    per_block = gk.element_size() * BS * D * 2
    if k_scale is not None:
        gks = gather_scales(k_scale, bt)
        gvs = gather_scales(v_scale, bt)
        walk += _nbytes(gks) + _nbytes(gvs)
        per_block += gks.element_size() * BS * 2
    if cover_blocks is None:
        cover_blocks = [-(-(int(p) + q_len) // BS) for p in list(q_pos0)]
    useful_blocks = sum(min(int(c), Wp) for c in list(cover_blocks))
    gather = walk * nq
    useful = useful_blocks * Hkv * per_block * nq
    return {"gather_bytes": gather, "useful_bytes": useful,
            "waste_bytes": gather - useful,
            "grid_steps": B * Hkv * nq * nk, "padded_width": Wp}


def paged_prefill_ref(q, k_pool, v_pool, block_tables, q_pos0, *,
                      k_scale=None, v_scale=None,
                      intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, Sq, D) pre-scaled; pools (N, Hkv, BS, D); tables (B, W)
    logical order; q_pos0 (B,) absolute position of q[:, :, 0]."""
    B, Hq, Sq, D = q.shape
    Hkv = k_pool.shape[1]
    k = gather_kv_dequant(k_pool, k_scale, block_tables)   # (B,Hkv,W*BS,D)
    v = gather_kv_dequant(v_pool, v_scale, block_tables)
    K = k.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    s = qg @ k.float()[:, :, None].transpose(-1, -2)      # (B,Hkv,G,Sq,K)
    dev = q.device
    qi = q_pos0.to(torch.int32).to(dev)[:, None] + \
        torch.arange(Sq, device=dev)[None, :]
    kj = torch.arange(K, dtype=torch.int32, device=dev)
    valid = kj[None, None, :] <= qi[:, :, None]            # (B, Sq, K)
    s = torch.where(valid[:, None, None], s, torch.full_like(s, NEG_INF))
    # ceil is monotone: ceil(max(s)) == max(ceil(s)); the denominator
    # divides the (…, D) output, the kernel's normalize-at-the-end dataflow
    m = torch.amax(s, dim=-1, keepdim=True)
    m = torch.ceil(m) if intmax else m
    p = torch.exp2(s - m)
    d = torch.sum(p, dim=-1, keepdim=True)
    o = (p @ v.float()[:, :, None]) * _recip(d)
    return o.reshape(B, Hq, Sq, D).to(q.dtype)


def paged_prefill_split_ref(q, k_pool, v_pool, block_tables, q_pos0, *,
                            tail_blocks: int, k_scale=None, v_scale=None,
                            intmax: bool = True) -> torch.Tensor:
    """CPU serving fast path: the same attention as ``paged_prefill_ref``,
    with the leading ``W - tail_blocks`` table blocks treated as causally
    valid without a mask.

    CONTRACT (the caller must guarantee it; it is not checked): every
    column of the first ``W - tail_blocks`` blocks sits at a logical
    position ``<= min(q_pos0)``. With ``tail_blocks = 2*ceil(Sq/BS) + 1``
    this holds whenever ``W <= ceil((pos0+Sq)/BS) + ceil(Sq/BS) - 1`` —
    the table is the exact cover of ``pos0 + Sq`` positions, or that cover
    rounded up to a multiple of the chunk's block count (the engine's
    chunk-table bucketing, ``serve.paged_step.table_width_bucket``).
    """
    B, Hq, Sq, D = q.shape
    Hkv, BS = k_pool.shape[1], k_pool.shape[2]
    W = block_tables.shape[1]
    t = min(tail_blocks, W)
    dev = q.device
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    qi = q_pos0.to(torch.int32).to(dev)[:, None] + \
        torch.arange(Sq, device=dev)[None, :]

    def scores(table):
        k = gather_kv_dequant(k_pool, k_scale, table).float()
        return qg @ k[:, :, None].transpose(-1, -2)

    def values(table):
        return gather_kv_dequant(v_pool, v_scale, table).float()[:, :, None]

    s2 = scores(block_tables[:, W - t:])
    kj = (W - t) * BS + torch.arange(t * BS, dtype=torch.int32, device=dev)
    valid = kj[None, None, :] <= qi[:, :, None]            # (B, Sq, t*BS)
    s2 = torch.where(valid[:, None, None], s2, torch.full_like(s2, NEG_INF))
    m = torch.amax(s2, dim=-1, keepdim=True)
    if W > t:
        s1 = scores(block_tables[:, :W - t])
        m = torch.maximum(m, torch.amax(s1, dim=-1, keepdim=True))
    m = torch.ceil(m) if intmax else m
    p2 = torch.exp2(s2 - m)
    d = torch.sum(p2, dim=-1, keepdim=True)
    o = p2 @ values(block_tables[:, W - t:])
    if W > t:
        p1 = torch.exp2(s1 - m)
        d = d + torch.sum(p1, dim=-1, keepdim=True)
        o = o + p1 @ values(block_tables[:, :W - t])
    o = o * _recip(d)
    return o.reshape(B, Hq, Sq, D).to(q.dtype)
