"""Dense flash attention: the CUDA kernels' wrappers, the query scaling and
the trainable op.

``flash_attention`` (K3) replaces the Pallas TPU kernel
``repro/kernels/flash_attention/flash_attention.py:99``;
``flash_attention_bwd`` (K4: a dK/dV kernel, then a dQ kernel) replaces
``repro/kernels/flash_attention/flash_backward.py:119``. Each launches one
of two hand-written Hopper routes, by an explicit rule on the dtype and the
head dim D (``tensor_core_route``):

* bf16 q, k, v with D a multiple of 16, up to 128 — the tensor-core
  kernels (``csrc/flash_attention_tc.cu``, ``csrc/flash_backward_tc.cu``):
  TMA-staged tiles, ``wgmma`` with f32 accumulation, and the f32 ``p`` and
  ``dS`` carried into the tensor cores as three bf16 terms whose sum is
  exact (``plain.split_bf16``), so they compute the reference's f32
  function;
* float32, or bf16 with any other D — the CUDA-core kernels
  (``csrc/flash_attention.cu``, ``csrc/flash_backward.cu``), all math in
  fp32: the parity route.

A failed build or launch raises, on either route; nothing falls back.
Launch counts: ``flash_attention.launches`` (one per forward) and
``flash_attention_bwd.launches`` (one per kernel, two per backward) count
both routes; ``.launches_tc`` counts the tensor-core route alone.

``flash_attention_op`` is the trainable op (a ``torch.autograd.Function``):
its forward saves ``(q, k, v, o, m, d)`` and its backward recomputes P from
the row statistics — memory-linear training. A CUDA tensor goes to the
kernels, a CPU tensor to the plain versions (``plain.py``); there is no
fallback between the two. DTensor operands run on their local shards
(``kernels/dtensor.py``), batch and heads kept sharded where q, k and v
agree, the sequences and ``head_dim`` whole. ``flash_attention_op_refbwd``
pairs the same forward with an autograd backward through
``attention_ref``: the cross-check.
"""
from __future__ import annotations

import torch

from repro_torch.core.numerics import LOG2_E
from repro_torch.kernels import build
from repro_torch.kernels.dtensor import HEADS, run_local
from repro_torch.kernels.observe import call_plain
from repro_torch.kernels.dtypes import q_code
from repro_torch.kernels.flash_attention.plain import (
    flash_attention_bwd_plain, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_prefill_paged.ops import query_tile

MAX_HEAD_DIM = 128


def scale_queries(q: torch.Tensor, d_head: int, base2: bool) -> torch.Tensor:
    """Fold 1/sqrt(d) — and log2(e) for the e-base ablation — into Q: the
    conversion multiply happens once on a [*, d_head] tensor, never on the
    [*, S, S] scores. The scalar is rounded to q's dtype first."""
    scale = d_head ** -0.5
    if not base2:
        scale = scale * LOG2_E
    return q * torch.tensor(scale, dtype=q.dtype).item()


def _check(name, causal, q, k, v, *more):
    """Geometry both the kernels and the plain versions take."""
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or \
            q.shape[0] != k.shape[0] or q.shape[3] != k.shape[3] or \
            q.shape[1] % k.shape[1]:
        raise ValueError(f"{name}: unsupported geometry q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if causal and k.shape[2] < q.shape[2]:
        raise ValueError(f"{name}: causal attention needs Sk >= Sq (the "
                         "queries sit at the end of the KV axis)")
    devs = {t.device for t in (q, k, v, *more)}
    if len(devs) != 1:
        raise ValueError(f"{name}: operands on several devices: {devs}")


def _check_cuda(name, q, k, v):
    if not q.is_cuda:
        raise ValueError(f"{name} runs on CUDA tensors only")
    if q.dtype != k.dtype or q.dtype != v.dtype:
        raise ValueError(f"{name}: q, k, v must share one dtype")
    q_code(q.dtype)
    if q.shape[3] > MAX_HEAD_DIM:
        raise ValueError(f"{name}: head dim {q.shape[3]} > {MAX_HEAD_DIM}")


def tensor_core_route(q: torch.Tensor) -> bool:
    """The dispatch rule: bf16 with a head dim that is a multiple of 16, up
    to 128, takes the tensor-core kernels; float32 and every other head dim
    take the CUDA-core kernels."""
    D = q.shape[-1]
    return q.dtype == torch.bfloat16 and D % 16 == 0 and D <= MAX_HEAD_DIM


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, at a 16-byte aligned address (TMA's requirement)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _forward_tensor_cores(q, k, v, causal, intmax):
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    d = torch.empty_like(m)
    err = build.load_library().smx_flash_fwd_tc(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(m), build.ptr(d), B, Hq, Hkv, Sq, Sk, D, int(causal),
        int(intmax), build.stream_ptr(q.device))
    build.check(err, "flash_attention (tensor cores)")
    return out, m, d


def _forward_cuda_cores(q, k, v, causal, intmax):
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    bq = query_tile(Hq // Hkv, Sq)
    lib = build.load_library()
    if lib.smx_flash_fwd_smem(Hq // Hkv, bq, D) > build.SMEM_LIMIT:
        raise ValueError("flash_attention: tile does not fit in shared "
                         "memory")
    out = torch.empty_like(q)
    m = torch.empty((B, Hq, Sq, 1), dtype=torch.float32, device=q.device)
    d = torch.empty_like(m)
    err = lib.smx_flash_fwd(
        build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(out),
        build.ptr(m), build.ptr(d), B, Hq, Hkv, Sq, Sk, D, bq,
        q_code(q.dtype), int(causal), int(intmax),
        build.stream_ptr(q.device))
    build.check(err, "flash_attention")
    return out, m, d


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, intmax: bool = True,
                    return_stats: bool = False):
    """K3 on the card. q (B, Hq, Sq, D) pre-scaled; k, v (B, Hkv, Sk, D),
    float32 or bfloat16 → o (B, Hq, Sq, D) in q's dtype [, m, d
    (B, Hq, Sq, 1) fp32]. Strided views are made contiguous first."""
    _check("flash_attention", causal, q, k, v)
    _check_cuda("flash_attention", q, k, v)
    if tensor_core_route(q):
        out, m, d = _forward_tensor_cores(q, k, v, causal, intmax)
        build.count(flash_attention, "launches", "launches_tc")
    else:
        out, m, d = _forward_cuda_cores(q, k, v, causal, intmax)
        build.count(flash_attention, "launches")
    return (out, m, d) if return_stats else out


flash_attention.launches = 0
flash_attention.launches_tc = 0


def _backward_tensor_cores(q, k, v, do, m, d, delta, causal):
    q, k, v, do = _aligned(q), _aligned(k), _aligned(v), _aligned(do)
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    dq = torch.empty_like(q)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = build.load_library()
    stream = build.stream_ptr(q.device)
    args = (build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do),
            build.ptr(m), build.ptr(d), build.ptr(delta))
    err = lib.smx_flash_bwd_dkv_tc(*args, build.ptr(dk), build.ptr(dv), B,
                                   Hq, Hkv, Sq, Sk, D, int(causal), stream)
    build.check(err, "flash_attention_bwd (dK/dV, tensor cores)")
    err = lib.smx_flash_bwd_dq_tc(*args, build.ptr(dq), B, Hq, Hkv, Sq, Sk,
                                  D, int(causal), stream)
    build.check(err, "flash_attention_bwd (dQ, tensor cores)")
    return dq, dk, dv


def _backward_cuda_cores(q, k, v, do, m, d, delta, causal):
    q, k, v, do = q.contiguous(), k.contiguous(), v.contiguous(), \
        do.contiguous()
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    G = Hq // Hkv
    bq = query_tile(G, Sq)
    lib = build.load_library()
    if max(lib.smx_flash_bwd_dkv_smem(D),
           lib.smx_flash_bwd_dq_smem(G, bq, D)) > build.SMEM_LIMIT:
        raise ValueError("flash_attention_bwd: tile does not fit in shared "
                         "memory")
    f32 = dict(dtype=torch.float32, device=q.device)
    dq = torch.empty((B, Hq, Sq, D), **f32)
    dk = torch.empty((B, Hkv, Sk, D), **f32)
    dv = torch.empty_like(dk)
    stream = build.stream_ptr(q.device)
    args = (build.ptr(q), build.ptr(k), build.ptr(v), build.ptr(do),
            build.ptr(m), build.ptr(d), build.ptr(delta))
    err = lib.smx_flash_bwd_dkv(*args, build.ptr(dk), build.ptr(dv), B, Hq,
                                Hkv, Sq, Sk, D, q_code(q.dtype), int(causal),
                                stream)
    build.check(err, "flash_attention_bwd (dK/dV)")
    err = lib.smx_flash_bwd_dq(*args, build.ptr(dq), B, Hq, Hkv, Sq, Sk, D,
                               bq, q_code(q.dtype), int(causal), stream)
    build.check(err, "flash_attention_bwd (dQ)")
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd(q, k, v, o, do, m, d, *, causal: bool = True):
    """K4 on the card: (dq, dk, dv) in the dtypes of (q, k, v) from the
    forward's o and row statistics m, d (B, Hq, Sq, 1) fp32; dk and dv are
    summed over each KV head's query heads. ``delta = Σ dO·O`` is a torch
    op, as in the reference (outside any kernel)."""
    _check("flash_attention_bwd", causal, q, k, v, o, do, m, d)
    _check_cuda("flash_attention_bwd", q, k, v)
    B, Hq, Sq, D = q.shape
    if o.shape != q.shape or do.shape != q.shape or \
            m.shape != (B, Hq, Sq, 1) or d.shape != m.shape:
        raise ValueError("flash_attention_bwd: o/do must match q and m/d "
                         "be (B, Hq, Sq, 1)")
    do = do.to(q.dtype)
    m = m.float().contiguous()
    d = d.float().contiguous()
    delta = torch.sum(do.float() * o.float(), dim=-1).contiguous()
    if tensor_core_route(q):
        grads = _backward_tensor_cores(q, k, v, do, m, d, delta, causal)
        build.count(flash_attention_bwd, "launches", "launches_tc", by=2)
    else:
        grads = _backward_cuda_cores(q, k, v, do, m, d, delta, causal)
        build.count(flash_attention_bwd, "launches", by=2)
    return grads


flash_attention_bwd.launches = 0
flash_attention_bwd.launches_tc = 0


def _stats_like(q, k, v):
    """Empty (o, m, d) of the forward's shapes and dtypes."""
    stat = q.new_empty(q.shape[:-1] + (1,), dtype=torch.float32)
    return q.new_empty(q.shape[:-1] + v.shape[-1:]), stat, stat.clone()


def _forward(q, k, v, causal, intmax, block_k):
    if q.is_cuda:
        return flash_attention(q, k, v, causal=causal, intmax=intmax,
                               return_stats=True)
    _check("flash_attention_plain", causal, q, k, v)
    return call_plain("flash_attention", lambda *t: flash_attention_plain(
        *t, causal=causal, intmax=intmax, block_k=block_k,
        return_stats=True), q, k, v, like=_stats_like)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, intmax, block_k):
        o, m, d = _forward(q, k, v, causal, intmax, block_k)
        ctx.save_for_backward(q, k, v, o, m, d)
        ctx.causal, ctx.block_k = causal, block_k
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, do):
        q, k, v, o, m, d = ctx.saved_tensors
        if q.is_cuda:
            dq, dk, dv = flash_attention_bwd(q, k, v, o, do, m, d,
                                             causal=ctx.causal)
        else:
            dq, dk, dv = call_plain(
                "flash_attention_bwd", lambda *t: flash_attention_bwd_plain(
                    *t, causal=ctx.causal, block_k=ctx.block_k),
                q, k, v, o, do, m, d,
                like=lambda *t: tuple(map(torch.empty_like, t[:3])))
        return dq, dk, dv, None, None, None


def flash_attention_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True, intmax: bool = True,
                       block_k: int = 128) -> torch.Tensor:
    """Trainable flash attention (the reference's ``custom_vjp``). The flags
    and the block size take no gradient; ``block_k`` is layout only — the
    kernels keep their own tiles and the plain versions walk ``block_k``
    KV rows at a time, which changes only the order of the sums.
    DTensors run on their local shards (batch and heads)."""
    return run_local(lambda *t: _FlashAttention.apply(
        *t, causal, intmax, block_k), (q, k, v), (HEADS,) * 3,
        keep=HEADS[:2])


class _FlashAttentionRefBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, intmax):
        o, _, _ = _forward(q, k, v, causal, intmax, 128)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.intmax = causal, intmax
        return o

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = attention_ref(q, k, v, causal=ctx.causal,
                                intmax=ctx.intmax)
            dq, dk, dv = torch.autograd.grad(out, (q, k, v), g)
        return dq, dk, dv, None, None


def flash_attention_op_refbwd(q, k, v, *, causal: bool = True,
                              intmax: bool = True) -> torch.Tensor:
    """Cross-check variant: the kernel forward, the reference's autograd
    backward."""
    return _FlashAttentionRefBwd.apply(q, k, v, causal, intmax)
