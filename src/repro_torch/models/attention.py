"""Attention with Softermax (the dense subset of the JAX package's
``repro.models.attention``).

``attention_apply`` (train and one-shot prefill) selects the
implementation by ``cfg.attention_impl``:

* ``chunked`` — the online Softermax state (running IntMax, running
  denominator, accumulator) carried over KV chunks in plain torch;
  differentiable through autograd.
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

import functools
from typing import Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.numerics import LOG2_E, NEG_INF
from repro_torch.core.softermax import attention_softmax
from repro_torch.kernels.flash_attention import flash_attention_op
from repro_torch.kernels.flash_decode import flash_decode_op
from repro_torch.models.layers import apply_rope, rmsnorm, rope, rope_cos_sin
from repro_torch.models.schema import ParamSpec


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


@functools.lru_cache(maxsize=64)
def round_to(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` (on the host: a device scalar
    would cost a stream-synchronizing copy)."""
    return torch.tensor(x, dtype=dtype).item()


def proj_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum('...d,dhk->...hk')``: x (..., d) @ w (d, H, k)."""
    d, H, k = w.shape
    return (x @ w.reshape(d, H * k)).unflatten(-1, (H, k))


def _project_qkv(params, x, cfg: ModelConfig, positions):
    """Q/K/V projections + qk-norm + RoPE. x: (B, S, d) → (B, H, S, Dh)."""
    dt = cfg.compute_dtype_
    q = proj_heads(x, params["wq"].to(dt)).transpose(1, 2)
    k = proj_heads(x, params["wk"].to(dt)).transpose(1, 2)
    v = proj_heads(x, params["wv"].to(dt)).transpose(1, 2)
    if cfg.qk_norm:
        q = rmsnorm(params["q_norm"], q, cfg.norm_eps)
        k = rmsnorm(params["k_norm"], k, cfg.norm_eps)
    if cfg.rope_theta > 0:
        pos = positions[:, None, :]          # (B, 1, S) broadcast over heads
        q = rope(q, pos, cfg.rope_theta)
        k = rope(k, pos, cfg.rope_theta)
    return q, k, v


def _out_proj(params, o, cfg: ModelConfig):
    """o: (B, H, S, Dh) -> (B, S, d)."""
    wo = params["wo"].to(cfg.compute_dtype_)
    H, dh, d = wo.shape
    return o.transpose(1, 2).flatten(2) @ wo.reshape(H * dh, d)


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
    fp32, ``p`` is cast to V's dtype before A·V (as in the JAX package)."""
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
    for c in range(n_chunks):
        k_c = k[:, :, None, c * chunk:(c + 1) * chunk].float()
        v_c = v[:, :, None, c * chunk:(c + 1) * chunk]
        s = qg @ k_c.transpose(-1, -2)                   # (B,Hkv,G,Sq,chunk)
        k_pos = c * chunk + torch.arange(chunk, device=dev)
        valid = (k_pos < Sk)[None, :]
        if causal:
            valid = valid & (q_pos[:, None] >= k_pos[None, :])
        if window > 0:
            valid = valid & (q_pos[:, None] - k_pos[None, :] < window)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
        sl = torch.ceil(s) if intmax else s
        m_new = torch.maximum(m, torch.amax(sl, dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new)
        acc = acc * alpha + p.to(v_c.dtype).float() @ v_c.float()
        d = d * alpha + torch.sum(p, dim=-1, keepdim=True)
        m = m_new
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
    before A·V (exact for the fixed-point Q(1,7) grid)."""
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
                    window: int = 0, return_kv: bool = False):
    """Self attention for train and prefill. x (B, S, d) → y (B, S, d), and
    with ``return_kv`` also the cacheable (k, v) (B, Hkv, S, Dh).

    As in the reference, the ``flash`` impl ignores ``window`` (the kernel
    has no window mask); ``chunked`` honours it."""
    _, intmax = _mode(cfg)
    q, k, v = _project_qkv(params, x, cfg, positions)
    q = q_scale(q, cfg)
    impl = cfg.attention_impl
    if cfg.softmax_impl == "softermax_fixed":
        impl = "naive"      # QAT mode materializes scores (finetuning only)
    if impl == "chunked":
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
        rows = torch.arange(x1.shape[0], device=x1.device)
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

    q = q_scale(q, cfg)
    kj = torch.arange(S, device=x1.device)[None, :]   # cache slots
    if ring:
        # every written slot is live; the buffer size IS the window
        live = kj < torch.clamp(new_len, max=S)[:, None]
        o = _masked_decode(q, att_k, att_v, live, intmax)
    elif 0 < window < S:
        # sliding window over a linear cache
        start = torch.clamp(new_len - window, min=0)
        live = (kj >= start[:, None]) & (kj < new_len[:, None])
        o = _masked_decode(q, att_k, att_v, live, intmax)
    elif (q.is_cuda or cfg.interpret_kernels) and not int8_kv:
        o = flash_decode_op(q, att_k, att_v, new_len, intmax=intmax)
    else:
        live = kj < new_len[:, None]
        o = _masked_decode(q, att_k, att_v, live, intmax)

    wo = params["wo"].to(dt)
    y1 = o.flatten(1) @ wo.reshape(-1, wo.shape[-1])
    if int8_kv:
        return y1, cache_k, cache_v, cache_k_scale, cache_v_scale
    return y1, cache_k, cache_v


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
