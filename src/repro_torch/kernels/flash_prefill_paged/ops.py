"""Paged chunked-prefill attention: the CUDA kernel's wrapper and the
dispatcher.

``flash_prefill_paged`` launches the hand-written Hopper kernel
(``csrc/flash_prefill_paged.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_prefill_paged/flash_prefill_paged.py:136``. It is
bound by operations: every gathered KV tile serves a whole query tile (see
the source's note). Its launch count is ``flash_prefill_paged.launches``.

``flash_prefill_paged_op`` is the one dispatcher: a CUDA tensor goes to
the kernel, a CPU tensor to a plain PyTorch version — ``paged_prefill_ref``,
or ``paged_prefill_split_ref`` when the caller passes ``split_tail_blocks``
and so promises its table contract. No fallback between the two.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dtypes import kv_code, q_code
from repro_torch.kernels.flash_decode_paged.ops import check_operands
from repro_torch.kernels.flash_decode_paged.ref import pad_table, split_layout
from repro_torch.kernels.flash_prefill_paged.ref import (
    paged_prefill_ref, paged_prefill_split_ref)


ROWS_PER_BLOCK = 64     # query rows (G*BQ) one block holds
MAX_HEAD_DIM = 128


def query_tile(G: int, Sq: int) -> int:
    """Query positions per block (BQ): as many as fit the block's 64 rows
    of G heads each, clamped to the chunk. Layout only — every BQ computes
    the same attention."""
    bq = min(ROWS_PER_BLOCK // G, Sq)
    if bq < 1:
        raise ValueError(f"flash_prefill_paged: GQA group {G} exceeds "
                         f"{ROWS_PER_BLOCK} rows")
    return bq


def flash_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        q_pos0: torch.Tensor, *, k_scale=None, v_scale=None,
                        intmax: bool = True,
                        kv_tile_blocks: int = 1) -> torch.Tensor:
    """q (B, Hq, Sq, D) pre-scaled; pools (N, Hkv, BS, D) f32/bf16/int8;
    int8 scales (N, Hkv, BS) f32; tables (B, W) covering every position
    <= pos0 + Sq - 1; q_pos0 (B,) → (B, Hq, Sq, D) in q's dtype.
    ``kv_tile_blocks`` pads the table to a tile multiple, as the JAX
    kernel's wrapper does; the kernel's own KV tile is 64 rows."""
    check_operands("flash_prefill_paged", q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, q_pos0)
    B, Hq, Sq, D = q.shape
    _, Hkv, BS, Dk = k_pool.shape
    if Dk != D or Hq % Hkv or block_tables.shape[0] != B or \
            tuple(q_pos0.shape) != (B,):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_tables.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill_paged: head dim {D} > "
                         f"{MAX_HEAD_DIM}")
    W = block_tables.shape[1]
    _, _, _, Wp = split_layout(W, kv_tile_blocks, 1)
    bt = pad_table(block_tables, Wp)
    pos = q_pos0.to(torch.int32).contiguous()
    G = Hq // Hkv
    bq = query_tile(G, Sq)
    lib = build.load_library()
    if lib.smx_paged_prefill_smem(G, bq, D, Wp) > build.SMEM_LIMIT:
        raise ValueError(f"flash_prefill_paged: a {Wp}-block table does "
                         "not fit in shared memory")
    out = torch.empty_like(q)
    err = lib.smx_paged_prefill(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(bt),
        build.ptr(pos), build.ptr(out), B, Hq, Hkv, Sq, D, BS, Wp, bq,
        q_code(q.dtype), kv_code(k_pool.dtype), int(intmax),
        build.stream_ptr(q.device))
    build.check(err, "flash_prefill_paged")
    flash_prefill_paged.launches += 1
    return out


flash_prefill_paged.launches = 0


def flash_prefill_paged_op(q, k_pool, v_pool, block_tables, q_pos0, *,
                           k_scale=None, v_scale=None, intmax: bool = True,
                           kv_tile_blocks: int = 1,
                           split_tail_blocks: Optional[int] = None
                           ) -> torch.Tensor:
    if q.is_cuda:
        return flash_prefill_paged(q, k_pool, v_pool, block_tables, q_pos0,
                                   k_scale=k_scale, v_scale=v_scale,
                                   intmax=intmax,
                                   kv_tile_blocks=kv_tile_blocks)
    if split_tail_blocks is not None:
        return paged_prefill_split_ref(q, k_pool, v_pool, block_tables,
                                       q_pos0, tail_blocks=split_tail_blocks,
                                       k_scale=k_scale, v_scale=v_scale,
                                       intmax=intmax)
    return paged_prefill_ref(q, k_pool, v_pool, block_tables, q_pos0,
                             k_scale=k_scale, v_scale=v_scale, intmax=intmax)
