"""Paged chunked-prefill attention: the CUDA kernels' wrapper and the
dispatcher.

``flash_prefill_paged`` replaces the Pallas TPU kernel
``repro/kernels/flash_prefill_paged/flash_prefill_paged.py:136`` with one
of two hand-written Hopper kernels, by an explicit rule on the dtypes and
the geometry (``tc_route``):

* bf16 q with a bf16 pool, D a multiple of 16 up to 128, a block size BS
  that is a multiple of 8 and divides 64, 16-byte-aligned pools — the
  tensor-core kernel (``csrc/flash_prefill_paged_tc.cu``): 64-row KV tiles
  gathered through the block table by TMA (one box per pool block) into a
  ring of stages, ``wgmma`` with f32 accumulation, and the f32 ``p``
  carried into the tensor cores as three bf16 terms whose sum is exact, so
  it computes the reference's f32 function;
* f32 q or pools, int8 pools, every other D or BS — the CUDA-core kernel
  (``csrc/flash_prefill_paged.cu``), all math in fp32: the parity route.

Both are bound by operations: every gathered KV tile serves a whole query
tile (see the sources' notes). A failed build or launch raises, on either
route; nothing falls back. Launch counts: ``flash_prefill_paged.launches``
counts both routes, ``.launches_tc`` the tensor-core route alone.

``flash_prefill_paged_op`` is the one dispatcher: a CUDA tensor goes to
the kernels, a CPU tensor to a plain PyTorch version —
``paged_prefill_ref``, or ``paged_prefill_split_ref`` when the caller
passes ``split_tail_blocks`` and so promises its table contract. No
fallback between the two.
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
TC_TILE_ROWS = 64       # KV rows per tile of the tensor-core kernel


def query_tile(G: int, Sq: int) -> int:
    """Query positions per block (BQ): as many as fit the block's 64 rows
    of G heads each, clamped to the chunk. Layout only — every BQ computes
    the same attention."""
    bq = min(ROWS_PER_BLOCK // G, Sq)
    if bq < 1:
        raise ValueError(f"flash_prefill_paged: GQA group {G} exceeds "
                         f"{ROWS_PER_BLOCK} rows")
    return bq


def tc_route(q: torch.Tensor, k_pool: torch.Tensor,
             v_pool: Optional[torch.Tensor] = None) -> bool:
    """THE dispatch rule: bf16 q with a bf16 pool, a head dim D that is a
    multiple of 16 up to 128, a block size BS that is a multiple of 8 and
    divides 64, and pools at 16-byte-aligned addresses (TMA's requirement)
    take the tensor-core kernel; everything else the CUDA-core kernel."""
    D, BS = q.shape[-1], k_pool.shape[2]
    pools = (k_pool,) if v_pool is None else (k_pool, v_pool)
    return (q.dtype == torch.bfloat16 and k_pool.dtype == torch.bfloat16
            and D % 16 == 0 and D <= MAX_HEAD_DIM and BS % 8 == 0
            and TC_TILE_ROWS % BS == 0
            and all(t.data_ptr() % 16 == 0 for t in pools))


def _launch(q, k_pool, v_pool, block_tables, q_pos0, k_scale, v_scale,
            intmax, kv_tile_blocks, tc=None):
    """One launch of the route ``tc_route`` picks, or of the one ``tc``
    names (the tensor-core or the CUDA-core kernel); returns the output
    and whether the tensor-core kernel ran."""
    check_operands("flash_prefill_paged", q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, q_pos0)
    B, Hq, Sq, D = q.shape
    N, Hkv, BS, Dk = k_pool.shape
    if Dk != D or Hq % Hkv or block_tables.shape[0] != B or \
            tuple(q_pos0.shape) != (B,):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_tables.shape)}")
    if D > MAX_HEAD_DIM:
        raise ValueError(f"flash_prefill_paged: head dim {D} > "
                         f"{MAX_HEAD_DIM}")
    if tc is None:
        tc = tc_route(q, k_pool, v_pool)
    elif tc and not tc_route(q, k_pool, v_pool):
        raise ValueError("flash_prefill_paged: the tensor-core kernel does "
                         f"not take q {q.dtype} {tuple(q.shape)}, pool "
                         f"{k_pool.dtype} {tuple(k_pool.shape)}")
    W = block_tables.shape[1]
    _, _, _, Wp = split_layout(W, kv_tile_blocks, 1)
    bt = pad_table(block_tables, Wp)
    pos = q_pos0.to(torch.int32).contiguous()
    lib = build.load_library()
    stream = build.stream_ptr(q.device)
    if tc:
        if lib.smx_paged_prefill_tc_smem(D, Wp) > build.SMEM_LIMIT:
            raise ValueError(f"flash_prefill_paged: a {Wp}-block table "
                             "does not fit in shared memory")
        q = q if q.data_ptr() % 16 == 0 else q.clone()
        out = torch.empty_like(q)
        err = lib.smx_paged_prefill_tc(
            build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
            build.ptr(bt), build.ptr(pos), build.ptr(out), B, Hq, Hkv, Sq,
            D, BS, Wp, N, int(intmax), stream)
        build.check(err, "flash_prefill_paged (tensor cores)")
        return out, True
    G = Hq // Hkv
    bq = query_tile(G, Sq)
    if lib.smx_paged_prefill_smem(G, bq, D, Wp) > build.SMEM_LIMIT:
        raise ValueError(f"flash_prefill_paged: a {Wp}-block table does "
                         "not fit in shared memory")
    out = torch.empty_like(q)
    err = lib.smx_paged_prefill(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(bt),
        build.ptr(pos), build.ptr(out), B, Hq, Hkv, Sq, D, BS, Wp, bq,
        q_code(q.dtype), kv_code(k_pool.dtype), int(intmax), stream)
    build.check(err, "flash_prefill_paged")
    return out, False


def flash_prefill_paged(q: torch.Tensor, k_pool: torch.Tensor,
                        v_pool: torch.Tensor, block_tables: torch.Tensor,
                        q_pos0: torch.Tensor, *, k_scale=None, v_scale=None,
                        intmax: bool = True,
                        kv_tile_blocks: int = 1) -> torch.Tensor:
    """q (B, Hq, Sq, D) pre-scaled; pools (N, Hkv, BS, D) f32/bf16/int8;
    int8 scales (N, Hkv, BS) f32; tables (B, W) covering every position
    <= pos0 + Sq - 1; q_pos0 (B,) → (B, Hq, Sq, D) in q's dtype.
    ``kv_tile_blocks`` pads the table to a tile multiple, as the JAX
    kernel's wrapper does; the kernels' own KV tile is 64 rows."""
    out, tc = _launch(q, k_pool, v_pool, block_tables, q_pos0, k_scale,
                      v_scale, intmax, kv_tile_blocks)
    build.count(flash_prefill_paged, "launches",
                *(("launches_tc",) if tc else ()))
    return out


flash_prefill_paged.launches = 0
flash_prefill_paged.launches_tc = 0


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
