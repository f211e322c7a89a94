"""Contiguous-cache decode attention (K5): the CUDA kernel's wrapper and
the dispatcher.

``flash_decode`` launches the hand-written Hopper kernel
(``csrc/flash_decode.cu``), which replaces the Pallas TPU kernel
``repro/kernels/flash_decode/flash_decode.py:71``. It is bound by bytes
(see the source's note) and reads the cache in place: no padded copy, no
row at or past a sequence's length. Its launch count is
``flash_decode.launches``.

``flash_decode_op`` is the one dispatcher every caller uses: a CUDA tensor
goes to the kernel, a CPU tensor to the plain PyTorch version
``decode_ref``. There is no fallback between the two — a build or launch
failure raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.dtypes import kv_code, q_code
from repro_torch.kernels.flash_decode.ref import decode_ref

WARP_ROWS = 32 * 4         # cache rows one pass of a block's four warps reads
TARGET_BLOCKS = 2 * 132    # two blocks on each of the H100's 132 SMs
MAX_GROUP, MAX_HEAD_DIM = 8, 256


def split_lanes(pairs: int, S: int):
    """THE split geometry of the kernel — ``(lane_rows, n_split)``: the
    cache's ``S`` rows are cut into ``n_split`` lanes of ``lane_rows`` rows
    (a multiple of one pass of the block's warps), one block each per
    (sequence, KV head) pair, enough lanes that the ``pairs`` blocks become
    about ``TARGET_BLOCKS``. It depends on the cache's shape only, never on
    the lengths (which live on the card)."""
    passes = -(-S // WARP_ROWS)
    n_split = max(1, min(-(-TARGET_BLOCKS // pairs), passes))
    lane_rows = -(-passes // n_split) * WARP_ROWS
    return lane_rows, -(-S // lane_rows)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 intmax: bool = True) -> torch.Tensor:
    """q (B, Hq, D) pre-scaled; k, v (B, Hkv, S, D) float32 or bfloat16;
    lengths (B,) → (B, Hq, D) in q's dtype."""
    if not q.is_cuda:
        raise ValueError("flash_decode runs on CUDA tensors only")
    devs = {t.device for t in (q, k, v, lengths)}
    if len(devs) != 1:
        raise ValueError(f"flash_decode: operands on several devices: {devs}")
    if k.shape != v.shape or k.dtype != v.dtype or \
            k.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError("flash_decode: k and v must match in shape and be "
                         "float32 or bfloat16")
    if q.dim() != 3 or k.dim() != 4:
        raise ValueError(f"flash_decode: q {tuple(q.shape)} must be (B, Hq, "
                         f"D) and the cache {tuple(k.shape)} (B, Hkv, S, D)")
    B, Hq, D = q.shape
    _, Hkv, S, Dk = k.shape
    if k.shape[0] != B or Dk != D or Hq % Hkv or \
            Hq // Hkv > MAX_GROUP or D > MAX_HEAD_DIM or \
            tuple(lengths.shape) != (B,):
        raise ValueError(f"flash_decode: unsupported geometry q "
                         f"{tuple(q.shape)}, cache {tuple(k.shape)}, lengths "
                         f"{tuple(lengths.shape)} (GQA group <= {MAX_GROUP}, "
                         f"head dim <= {MAX_HEAD_DIM})")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_decode needs contiguous operands")
    G = Hq // Hkv
    lane_rows, n = split_lanes(B * Hkv, S)
    lib = build.load_library()
    if lib.smx_decode_smem(G, D) > build.SMEM_LIMIT:
        raise ValueError(f"flash_decode: head dim {D} does not fit in "
                         "shared memory")
    lens = lengths.to(torch.int32).contiguous()
    f32 = dict(dtype=torch.float32, device=q.device)
    acc = torch.empty((B * Hkv, n, G, D), **f32)
    m = torch.empty((B * Hkv, n, G), **f32)
    d = torch.empty((B * Hkv, n, G), **f32)
    out = torch.empty_like(q)
    err = lib.smx_decode(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(lens),
        build.ptr(acc), build.ptr(m), build.ptr(d), build.ptr(out), B, Hq,
        Hkv, S, D, lane_rows, n, q_code(q.dtype), kv_code(k.dtype),
        int(intmax), build.stream_ptr(q.device))
    build.check(err, "flash_decode")
    flash_decode.launches += 1
    return out


flash_decode.launches = 0


def flash_decode_op(q, k, v, lengths, *, intmax: bool = True) -> torch.Tensor:
    if q.is_cuda:
        return flash_decode(q, k, v, lengths, intmax=intmax)
    return decode_ref(q, k, v, lengths, intmax=intmax)
