"""Attention with Softermax (the dense subset of the JAX package's
``repro.models.attention``).

``attention_apply`` (train and one-shot prefill; self attention, or cross
attention over ``x_kv`` for whisper's decoder) selects the implementation
by ``cfg.attention_impl``:

* ``chunked`` — the online Softermax state (running IntMax, running
  denominator, accumulator) carried over KV chunks in plain torch;
  differentiable through autograd. Under ``opt_ring_attention`` and
  sequence-parallel rules over a ``model`` axis of 2 or more ranks
  (``_ring_applicable``) the same recurrence runs around the ring of
  ``parallel/ring_attention.py``.
* ``flash``   — the dense flash-attention kernels (K3 forward, K4 backward)
  through the trainable op ``flash_attention_op``; on CPU tensors their
  plain versions.
* ``naive``   — the full fp32 score matrix through
  ``core.softermax.attention_softmax``: on the card the row kernel K6
  (``softermax``, ``base2``) or the fixed-point kernel K7
  (``softermax_fixed``), on the CPU the plain functions. The only mode
  supporting ``softermax_fixed``: that impl forces it (QAT finetuning, and
  every one-shot prefill of a fixed-point model).

``attention_decode`` is the one-token step of the static engine over a
contiguous ``(B, Hkv, S, Dh)`` cache (linear, sliding window, ring buffer,
int8 rows with per-row scales). It writes the new K/V row **in place** and
attends through the decode kernel K5 (``kernels/flash_decode``) on the
card, or through the plain ``_masked_decode`` where the JAX package does.

``quantize_kv`` / ``dequantize_kv`` are the int8 KV row format. Every float
softmax variant runs through ``exp2``: the e-base ablation folds log2(e)
into the q scale (``_mode``).
"""
from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core.numerics import LOG2_E, NEG_INF
from repro_torch.core.softermax import attention_softmax
from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.dtensor import (HEADS, merged, rows_matmul,
                                         run_local, split_evenly)
from repro_torch.kernels.flash_attention import flash_attention_op
from repro_torch.kernels.flash_decode import flash_decode_op
from repro_torch.models.layers import (apply_rope, rmsnorm, rope,
                                       rope_cos_sin, round_to)
from repro_torch.models.schema import ParamSpec
from repro_torch.parallel.sharding import shard_act


def attention_schema(cfg: ModelConfig):
    d, dh = cfg.d_model, cfg.head_dim_
    s = {
        "wq": ParamSpec((d, cfg.n_heads, dh), ("embed", "heads", "head_dim")),
        "wk": ParamSpec((d, cfg.n_kv_heads, dh),
                        ("embed", "kv_heads", "head_dim")),
        "wv": ParamSpec((d, cfg.n_kv_heads, dh),
                        ("embed", "kv_heads", "head_dim")),
        "wo": ParamSpec((cfg.n_heads, dh, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = {"scale": ParamSpec((dh,), ("head_dim",), init="ones")}
        s["k_norm"] = {"scale": ParamSpec((dh,), ("head_dim",), init="ones")}
    return s


def _ring_applicable(cfg: ModelConfig, q, k, window, x_kv) -> bool:
    """Ring attention engages for sequence-parallel self attention: seq
    sharded over "model" by the ambient rules, a model axis of 2 or more,
    equal q/kv lengths divisible by the ring size, no window."""
    if not cfg.opt_ring_attention or window or x_kv is not None:
        return False
    from repro_torch.launch.mesh import mesh_shape
    from repro_torch.parallel.sharding import current_mesh, current_rules
    mesh = current_mesh()
    if mesh is None:
        return False
    sizes = mesh_shape(mesh)
    if sizes.get("model", 1) < 2:
        return False
    if "model" not in current_rules().get("seq"):
        return False
    n = sizes["model"]
    return q.shape[2] == k.shape[2] and q.shape[2] % n == 0


def _mode(cfg: ModelConfig) -> Tuple[float, bool]:
    """(premultiplier, intmax) so that exp2 realizes the configured softmax."""
    impl = cfg.softmax_impl
    if impl == "softermax":
        return 1.0, True
    if impl == "base2":
        return 1.0, False
    if impl in ("softmax", "base2_folded"):
        return LOG2_E, False
    if impl == "softermax_fixed":
        return 1.0, True
    raise ValueError(impl)


def q_scale(q: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Pre-scale queries by ``premult / sqrt(dh)``, the scalar rounded to
    q's dtype first (as the JAX package's ``jnp.asarray(…, q.dtype)``)."""
    premult, _ = _mode(cfg)
    return q * round_to(premult * cfg.head_dim_ ** -0.5, q.dtype)


def proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('...d,dhk->...hk')``: x (..., d) @ w (d, H, k)."""
    d, H, k = w.shape
    y = rows_matmul(x, merged(w, (d, H * k), H))
    return split_evenly(y, -1, H).unflatten(-1, (H, k))


def _project_qkv(params, x, cfg: ModelConfig, positions, x_kv=None,
                 kv_positions=None):
    """Q/K/V projections + qk-norm + RoPE. x: (B, S, d) → (B, H, S, Dh).
    Cross attention (``x_kv`` (B, Sk, d)): k and v from ``x_kv``, RoPE
    only where ``kv_positions`` gives the keys' positions, as in the
    reference."""
    dt = cfg.compute_dtype_
    src = x if x_kv is None else x_kv
    q = proj_heads(x, params["wq"].to(dt)).transpose(1, 2)
    k = proj_heads(src, params["wk"].to(dt)).transpose(1, 2)
    v = proj_heads(src, params["wv"].to(dt)).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    k_pos = positions if x_kv is None else kv_positions
    if cfg.rope_theta > 0 and k_pos is not None:
        # (B, 1, S) broadcast over heads
        q = rope(q, positions[:, None, :], cfg.rope_theta)
        k = rope(k, k_pos[:, None, :], cfg.rope_theta)
    return q, k, v


def _out_proj(params, o, cfg: ModelConfig):
    """o: (B, H, S, Dh) -> (B, S, d)."""
    o = shard_act(o, ("batch", "act_heads", "seq", "head_dim"))
    wo = params["wo"].to(cfg.compute_dtype_)
    H, dh, d = wo.shape
    o = o.transpose(1, 2)
    return rows_matmul(merged(o, (*o.shape[:2], H * dh), H),
                       merged(wo, (H * dh, d), H))


def _chunk_step(qg, k_c, v_c, m, d, acc, valid, intmax: bool):
    """One KV chunk of the online Softermax: (m, d, acc) updated."""
    s = qg @ k_c.transpose(-1, -2)                       # (B,Hkv,G,Sq,chunk)
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    sl = torch.ceil(s) if intmax else s
    m_new = torch.maximum(m, torch.amax(sl, dim=-1, keepdim=True))
    alpha = torch.exp2(m - m_new)
    p = torch.exp2(s - m_new)
    acc = acc * alpha + p.to(v_c.dtype).float() @ v_c.float()
    d = d * alpha + torch.sum(p, dim=-1, keepdim=True)
    return m_new, d, acc


def chunked_attention(
    q: torch.Tensor,  # (B, Hq, Sq, D) — pre-scaled
    k: torch.Tensor,  # (B, Hkv, Sk, D)
    v: torch.Tensor,
    *,
    causal: bool,
    intmax: bool,
    window: int = 0,
    chunk: int = 512,
    q_offset: int = 0,
) -> torch.Tensor:
    """Online Softermax over KV chunks; scores and the A·V accumulate in
    fp32, ``p`` is cast to V's dtype before A·V (as in the JAX package).

    Where a gradient is wanted each chunk's step is checkpointed
    (non-reentrant, so also inside a remat layer's recompute): autograd
    keeps only the carried (m, d, acc) per chunk and recomputes one chunk's
    scores at a time in the backward. Otherwise it keeps four fp32
    score-sized tensors of every chunk (the scores, their IntMax ceil, p
    and p's f32 copy): ~34 GB for one of deepseek-v2's 128-head MLA layers
    at S 4096 in chunks of 512. The values are the same. DTensors run on
    their local shards, batch and heads (``kernels/dtensor.py``)."""
    return run_local(lambda *t: _chunked_local(
        *t, causal, intmax, window, chunk, q_offset), (q, k, v),
        (HEADS,) * 3, keep=HEADS[:2])


def _chunked_local(q, k, v, causal, intmax, window, chunk, q_offset):
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    Dv = v.shape[-1]
    group = Hq // Hkv
    chunk = min(chunk, Sk)
    pad = (-Sk) % chunk
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    n_chunks = (Sk + pad) // chunk
    qg = q.reshape(B, Hkv, group, Sq, D).float()
    dev = q.device
    q_pos = q_offset + torch.arange(Sq, device=dev)
    m = torch.full((B, Hkv, group, Sq, 1), NEG_INF, dtype=torch.float32,
                   device=dev)
    d = torch.zeros_like(m)
    acc = torch.zeros((B, Hkv, group, Sq, Dv), dtype=torch.float32,
                      device=dev)
    remat = torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v))
    for c in range(n_chunks):
        k_c = k[:, :, None, c * chunk:(c + 1) * chunk].float()
        v_c = v[:, :, None, c * chunk:(c + 1) * chunk]
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        valid = (k_pos < Sk)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        if remat:
            m, d, acc = checkpoint(_chunk_step, qg, k_c, v_c, m, d, acc,
                                   valid, intmax, use_reentrant=False)
        else:
            m, d, acc = _chunk_step(qg, k_c, v_c, m, d, acc, valid, intmax)
    pos = d > 0
    o = torch.where(pos, acc / torch.where(pos, d, torch.ones_like(d)),
                    torch.zeros_like(acc))
    return o.reshape(B, Hq, Sq, Dv).to(q.dtype)


def _naive_attention(q, k, v, cfg: ModelConfig, *, causal: bool,
                     window: int) -> torch.Tensor:
    """The full score matrix: q (B, Hq, Sq, D) pre-scaled, k, v (B, Hkv,
    Sk, D). Scores in fp32 (q and k upcast: the reference's
    ``preferred_element_type=f32``), masked with the finite NEG_INF, the
    softmax of ``cfg.softmax_impl`` over the keys, ``p`` cast to V's dtype
    before A·V (exact for the fixed-point Q(1,7) grid). DTensors run on
    their local shards, batch and heads."""
    return run_local(lambda *t: _naive_local(*t, cfg, causal, window),
                     (q, k, v), (HEADS,) * 3, keep=HEADS[:2])


def _naive_local(q, k, v, cfg: ModelConfig, causal: bool, window: int):
    B, Hq, Sq, D = q.shape
    _, Hkv, Sk, _ = k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, Sq, D).float()
    s = qg @ k[:, :, None].float().transpose(-1, -2)     # (B,Hkv,G,Sq,Sk)
    dev = q.device
    q_pos = torch.arange(Sq, device=dev)
    k_pos = torch.arange(Sk, device=dev)
    valid = None
    if causal:
        valid = q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        w = q_pos[:, None] - k_pos[None, :] < window
        valid = w if valid is None else valid & w
    if valid is not None:
        s = s.masked_fill(~valid, NEG_INF)
    p = attention_softmax(s, impl=cfg.softmax_impl, axis=-1)
    o = p.to(v.dtype) @ v[:, :, None]
    return o.reshape(B, Hq, Sq, v.shape[-1]).to(q.dtype)


def attention_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window: int = 0, x_kv=None, kv_positions=None,
                    return_kv: bool = False):
    """Self (or cross) attention for train and prefill. x (B, S, d) → y
    (B, S, d), and with ``return_kv`` also the cacheable (k, v) (B, Hkv,
    Sk, Dh).

    Cross attention (``x_kv`` (B, Sk, d), whisper's decoder): q from x, k
    and v from ``x_kv``; qk-norm as for self attention, RoPE only where
    ``kv_positions`` gives the keys' positions; never causal.

    As in the reference, the ``flash`` impl ignores ``window`` (the kernel
    has no window mask); ``chunked`` honours it."""
    _, intmax = _mode(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions, x_kv, kv_positions)
    if x_kv is not None:
        causal = False
    q = q_scale(q, cfg)
    q = shard_act(q, ("batch", "act_heads", "seq", "head_dim"))
    k = shard_act(k, ("batch", "act_heads", "seq", "head_dim"))
    v = shard_act(v, ("batch", "act_heads", "seq", "head_dim"))
    impl = cfg.attention_impl
    if cfg.softmax_impl == "softermax_fixed":
        impl = "naive"      # QAT mode materializes scores (finetuning only)
    if impl == "chunked" and _ring_applicable(cfg, q, k, window, x_kv):
        from repro_torch.parallel.ring_attention import (
            ring_attention, ring_attention_placed)
        from repro_torch.parallel.sharding import current_mesh
        ring = ring_attention_placed if is_dtensor(q) else ring_attention
        o = ring(q, k, v, current_mesh(), causal=causal, intmax=intmax)
    elif impl == "chunked":
        o = chunked_attention(q, k, v, causal=causal, intmax=intmax,
                              window=window, chunk=cfg.attention_chunk)
    elif impl == "flash":
        o = flash_attention_op(q, k, v, causal, intmax)
    elif impl == "naive":
        o = _naive_attention(q, k, v, cfg, causal=causal, window=window)
    else:
        raise ValueError(impl)
    y = _out_proj(params, o, cfg)
    if return_kv:
        return y, k, v
    return y


INT8_KV_MAX = 127.0


def quantize_kv(t: torch.Tensor):
    """Symmetric int8 per-row quantization over the last axis.
    t: (..., D) → (int8 values, f32 scales (...,)). ``torch.round`` rounds
    half to even, like ``jnp.round``."""
    tf = t.float()
    amax = torch.amax(torch.abs(tf), dim=-1)
    scale = torch.clamp(amax, min=1e-6) / INT8_KV_MAX
    q = torch.clamp(torch.round(tf / scale[..., None]),
                    -INT8_KV_MAX, INT8_KV_MAX).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                  dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def attention_decode(params, x1: torch.Tensor, cfg: ModelConfig, *,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_len: torch.Tensor, window: int = 0,
                     ring: bool = False, cache_k_scale=None,
                     cache_v_scale=None, rope_cs=None):
    """One decode token. x1 (B, d); cache_k/cache_v (B, Hkv, S, Dh), int8
    with f32 scales (B, Hkv, S) under ``opt_int8_kv``; cache_len (B,)
    tokens cached so far. Returns (y1 (B, d), cache_k, cache_v[, scales]).

    The new K/V row (quantized first for an int8 cache) is written **in
    place** at slot ``cache_len`` (``cache_len % S`` for a ``ring`` buffer,
    whose size is the window); the returned caches are the arguments. The
    reference rewrites the whole cache with a one-hot select, which drops
    a write at ``cache_len >= S``; here a linear cache needs
    ``cache_len < S``. ``opt_dus_cache`` writes every row at
    ``cache_len[0]`` (all sequences share the position), clamped into the
    cache as ``dynamic_update_slice`` clamps it. ``rope_cs`` is the RoPE
    rotation of the positions ``cache_len`` (``rope_cos_sin``), computed
    once per step by the caller; by default it is computed here.

    Attention, as the reference dispatches it: a ring buffer and a
    sliding window over a linear cache go to ``_masked_decode``; a linear
    bf16/f32 cache goes to the decode kernel (``flash_decode_op``) on the
    card, and on the CPU where ``cfg.interpret_kernels`` asks for it (its
    plain version ``decode_ref``); every other case, the int8 cache
    included (dequantized whole, as in the reference), to
    ``_masked_decode``."""
    dt = cfg.compute_dtype_
    _, intmax = _mode(cfg)
    q = proj_heads(x1, params["wq"].to(dt))              # (B, H, Dh)
    k = proj_heads(x1, params["wk"].to(dt))
    v = proj_heads(x1, params["wv"].to(dt))
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope_theta > 0:                               # next position
        cos, sin = rope_cs if rope_cs is not None else rope_cos_sin(
            cache_len[:, None, None], cfg.rope_theta, cfg.head_dim_ // 2)
        q = apply_rope(q[:, :, None, :], cos, sin)[:, :, 0]
        k = apply_rope(k[:, :, None, :], cos, sin)[:, :, 0]

    int8_kv = cache_k_scale is not None
    if int8_kv:
        k, k_sc = quantize_kv(k)             # (B, Hkv, Dh), (B, Hkv)
        v, v_sc = quantize_kv(v)
    q = q_scale(q, cfg)
    # heads on the cache's kv_heads shards (the one-token rows are small)
    q, k, v = (shard_act(t, ("batch", "act_heads", "head_dim"))
               for t in (q, k, v))
    new = (k, v, k_sc, v_sc) if int8_kv else (k, v)
    caches = (cache_k, cache_v) + ((cache_k_scale, cache_v_scale)
                                   if int8_kv else ())
    row = ("batch", "heads", None)
    o = run_local(lambda *t: _decode_local(*t, cfg=cfg, window=window,
                                           ring=ring, intmax=intmax),
                  (q, cache_len, *new, *caches),
                  (row, ("batch",)) + (row, row, row[:2], row[:2])[:len(new)]
                  + (HEADS, HEADS, row, row)[:len(caches)],
                  keep=row[:2])

    wo = params["wo"].to(dt)
    y1 = o.flatten(1) @ wo.reshape(-1, wo.shape[-1])
    if int8_kv:
        return y1, cache_k, cache_v, cache_k_scale, cache_v_scale
    return y1, cache_k, cache_v


def _decode_local(q, cache_len, *rest, cfg, window, ring, intmax):
    """``attention_decode``'s cache write and attention on (local)
    tensors: q (B, Hq, Dh) pre-scaled, the new K/V rows (and their int8
    scales), the caches (and theirs), written in place."""
    int8_kv = len(rest) == 8
    if int8_kv:
        k, v, k_sc, v_sc, cache_k, cache_v, cache_k_scale, cache_v_scale = \
            rest
    else:
        k, v, cache_k, cache_v = rest
    dt = cfg.compute_dtype_
    S = cache_k.shape[2]
    if cfg.opt_dus_cache:
        pos = cache_len[:1].long()
        pos = pos % S if ring else torch.clamp(pos, max=S - 1)
        cache_k.index_copy_(2, pos, k[:, :, None].to(cache_k.dtype))
        cache_v.index_copy_(2, pos, v[:, :, None].to(cache_v.dtype))
        if int8_kv:
            cache_k_scale.index_copy_(2, pos, k_sc[:, :, None])
            cache_v_scale.index_copy_(2, pos, v_sc[:, :, None])
    else:
        rows = torch.arange(q.shape[0], device=q.device)
        slot = cache_len.long() % S if ring else cache_len.long()
        cache_k[rows, :, slot] = k.to(cache_k.dtype)
        cache_v[rows, :, slot] = v.to(cache_v.dtype)
        if int8_kv:
            cache_k_scale[rows, :, slot] = k_sc
            cache_v_scale[rows, :, slot] = v_sc
    new_len = cache_len + 1

    if int8_kv:
        att_k = dequantize_kv(cache_k, cache_k_scale, dt)
        att_v = dequantize_kv(cache_v, cache_v_scale, dt)
    else:
        att_k, att_v = cache_k, cache_v

    kj = torch.arange(S, device=q.device)[None, :]     # cache slots
    if ring:
        # every written slot is live; the buffer size IS the window
        live = kj < torch.clamp(new_len, max=S)[:, None]
        return _masked_decode(q, att_k, att_v, live, intmax)
    if 0 < window < S:
        # sliding window over a linear cache
        start = torch.clamp(new_len - window, min=0)
        live = (kj >= start[:, None]) & (kj < new_len[:, None])
        return _masked_decode(q, att_k, att_v, live, intmax)
    if (q.is_cuda or cfg.interpret_kernels) and not int8_kv:
        return flash_decode_op(q, att_k, att_v, new_len, intmax=intmax)
    live = kj < new_len[:, None]
    return _masked_decode(q, att_k, att_v, live, intmax)


def masked_decode(q, cache_k, cache_v, live, intmax):
    """``_masked_decode``; placed operands on local shards (batch and
    heads)."""
    row = ("batch", "heads", None)
    return run_local(lambda *t: _masked_decode(*t, intmax),
                     (q, cache_k, cache_v, live),
                     (row, HEADS, HEADS, ("batch", None)), keep=row[:2])


def _masked_decode(q, cache_k, cache_v, live, intmax):
    """Plain decode attention: q (B, Hq, D) pre-scaled, cache (B, Hkv, S,
    D), live (B, S). Scores and the A·V sum in fp32; p is cast to the
    cache's dtype before A·V, and the output is in that dtype (as in the
    reference)."""
    B, Hq, D = q.shape
    _, Hkv, S, _ = cache_k.shape
    qg = q.reshape(B, Hkv, Hq // Hkv, D).float()
    s = qg @ cache_k.float().transpose(-1, -2)           # (B, Hkv, G, S)
    s = torch.where(live[:, None, None, :], s, torch.full_like(s, NEG_INF))
    m = torch.amax(torch.ceil(s) if intmax else s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    d = torch.sum(p, dim=-1, keepdim=True)
    pos = d > 0
    p = torch.where(pos, p / torch.where(pos, d, torch.ones_like(d)),
                    torch.zeros_like(p))
    o = p.to(cache_v.dtype).float() @ cache_v.float()
    return o.reshape(B, Hq, D).to(cache_v.dtype)
