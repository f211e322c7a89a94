"""Paged decode attention: the CUDA kernel's wrapper and the dispatcher.

``flash_decode_paged`` launches the hand-written Hopper kernel
(``csrc/flash_decode_paged.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_decode_paged/flash_decode_paged.py:150``. It is
bound by bytes: a gather at low arithmetic intensity (see the source's
note). Its launch count is ``flash_decode_paged.launches``.

``flash_decode_paged_op`` is the one dispatcher every caller uses: a CUDA
tensor goes to the kernel, a CPU tensor to the plain PyTorch version
``paged_decode_ref``. There is no fallback between the two — a build or
launch failure raises. Tile and split are layout knobs: every setting
computes the same attention, so the plain version ignores them.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dtypes import kv_code, q_code
from repro_torch.kernels.flash_decode_paged.ref import (paged_decode_ref,
                                                        pad_table,
                                                        split_layout)


def check_operands(name, q, k_pool, v_pool, k_scale, v_scale, *index):
    """Validate what the paged kernels take (shared by both wrappers)."""
    if not q.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only")
    devs = {t.device for t in (q, k_pool, v_pool, k_scale, v_scale, *index)
            if t is not None}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices: {devs}")
    if k_pool.shape != v_pool.shape or k_pool.dtype != v_pool.dtype:
        raise ValueError(f"{name}: k_pool and v_pool must match in shape "
                         "and dtype")
    if (k_scale is None) != (k_pool.dtype != torch.int8) or \
            (k_scale is None) != (v_scale is None):
        raise ValueError(f"{name}: int8 pools need both scale pools, "
                         "other pools none")
    for t in (k_scale, v_scale):
        if t is not None and (t.dtype != torch.float32 or
                              t.shape != k_pool.shape[:3]):
            raise ValueError(f"{name}: scales must be float32 "
                             f"{tuple(k_pool.shape[:3])}")
    for t in (q, k_pool, v_pool, k_scale, v_scale):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous operands")


def flash_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                       v_pool: torch.Tensor, block_tables: torch.Tensor,
                       lengths: torch.Tensor, *, k_scale=None, v_scale=None,
                       intmax: bool = True, kv_tile_blocks: int = 1,
                       split_k: int = 1) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled; pools (N, Hkv, BS, D) f32/bf16/int8; int8
    scales (N, Hkv, BS) f32; tables (B, W); lengths (B,) → (B, Hq, D) in
    q's dtype."""
    check_operands("flash_decode_paged", q, k_pool, v_pool, k_scale,
                   v_scale, block_tables, lengths)
    B, Hq, D = q.shape
    _, Hkv, BS, Dk = k_pool.shape
    if Dk != D or Hq % Hkv or Hq // Hkv > 8 or \
            block_tables.shape[0] != B or tuple(lengths.shape) != (B,):
        raise ValueError(f"unsupported geometry q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, table "
                         f"{tuple(block_tables.shape)}, lengths "
                         f"{tuple(lengths.shape)} (GQA group must be <= 8)")
    W = block_tables.shape[1]
    T, S, spl, Wp = split_layout(W, kv_tile_blocks, split_k)
    bt = pad_table(block_tables, Wp)
    lens = lengths.to(torch.int32).contiguous()
    G = Hq // Hkv
    lib = build.load_library()
    if lib.smx_paged_decode_smem(G, D, T, BS, spl) > build.SMEM_LIMIT:
        raise ValueError(f"flash_decode_paged: kv_tile_blocks={T} x "
                         f"block_size={BS} rows (x {spl} tiles per lane) do "
                         "not fit in shared memory")
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B * Hkv, S, G, D), **f32)
    m = torch.empty((B * Hkv, S, G), **f32)
    d = torch.empty((B * Hkv, S, G), **f32)
    out = torch.empty_like(q)
    err = lib.smx_paged_decode(
        build.ptr(q), build.ptr(k_pool), build.ptr(v_pool),
        build.ptr(k_scale), build.ptr(v_scale), build.ptr(bt),
        build.ptr(lens), build.ptr(acc), build.ptr(m), build.ptr(d),
        build.ptr(out), B, Hq, Hkv, D, BS, Wp, T, S, spl, q_code(q.dtype),
        kv_code(k_pool.dtype), int(intmax), build.stream_ptr(q.device))
    build.check(err, "flash_decode_paged")
    flash_decode_paged.launches += 1
    return out


flash_decode_paged.launches = 0


def flash_decode_paged_op(q, k_pool, v_pool, block_tables, lengths, *,
                          k_scale=None, v_scale=None, intmax: bool = True,
                          kv_tile_blocks: int = 1,
                          split_k: int = 1) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode_paged(q, k_pool, v_pool, block_tables, lengths,
                                  k_scale=k_scale, v_scale=v_scale,
                                  intmax=intmax,
                                  kv_tile_blocks=kv_tile_blocks,
                                  split_k=split_k)
    return paged_decode_ref(q, k_pool, v_pool, block_tables, lengths,
                            k_scale=k_scale, v_scale=v_scale, intmax=intmax)
