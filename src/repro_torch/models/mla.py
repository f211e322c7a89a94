"""Multi-head Latent Attention (DeepSeek-V2) with Softermax: the JAX
package's ``repro.models.mla`` in PyTorch.

Train and prefill use the *expanded* form: the compressed KV latent
``c_kv`` (rank ``kv_lora``) is up-projected to per-head keys and values,
and attention runs through the chunked online Softermax
(``attention.chunked_attention``; qk dim = qk_nope + qk_rope, v dim =
v_head). Under ``opt_mla_absorbed`` the queries are pushed through the K
up-projection instead, attention runs against the latent as one shared KV
head (GQA group = n_heads), and the V up-projection follows the weighted
sum: the same function by associativity.

Decode is the absorbed form against the latent cache: ``cache_ckv``
(B, S, kv_lora) and the shared roped key ``cache_krope`` (B, S, qk_rope).
Scores live in latent space; the Softermax between the two products is
the reference's plain one (IntMax ``ceil``, ``exp2``, the finite
``NEG_INF`` mask, ``d == 0 → 0``). The new latent row is written into the
cache **in place** at ``cache_len`` (``attention.attention_decode``'s
convention: the reference's one-hot add, or ``opt_dus_cache``'s
``dynamic_update_slice`` clamped into the cache).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.numerics import NEG_INF
from repro_torch.kernels.dtensor import rows_matmul, run_local
from repro_torch.models.attention import (_mode, chunked_attention,
                                         proj_heads, round_to)
from repro_torch.models.layers import rmsnorm, rmsnorm_schema, rope
from repro_torch.models.schema import ParamSpec
from repro_torch.parallel.sharding import shard_act


def mla_schema(cfg: ModelConfig):
    a = cfg.mla
    d, H = cfg.d_model, cfg.n_heads
    qk = a.qk_nope + a.qk_rope
    s = {}
    if a.q_lora > 0:
        s["wq_a"] = ParamSpec((d, a.q_lora), ("embed", "q_lora"))
        s["q_norm"] = rmsnorm_schema(a.q_lora, "q_lora")
        s["wq_b"] = ParamSpec((a.q_lora, H, qk),
                              ("q_lora", "heads", "head_dim"))
    else:
        s["wq"] = ParamSpec((d, H, qk), ("embed", "heads", "head_dim"))
    s["wkv_a"] = ParamSpec((d, a.kv_lora + a.qk_rope), ("embed", "kv_lora"))
    s["kv_norm"] = rmsnorm_schema(a.kv_lora, "kv_lora")
    s["wk_b"] = ParamSpec((a.kv_lora, H, a.qk_nope),
                          ("kv_lora", "heads", "head_dim"))
    s["wv_b"] = ParamSpec((a.kv_lora, H, a.v_head),
                          ("kv_lora", "heads", "head_dim"))
    s["wo"] = ParamSpec((H, a.v_head, d), ("heads", "head_dim", "embed"))
    return s


def _queries(params, x, cfg: ModelConfig, positions):
    """(B, S, d) → q_nope (B, H, S, nope), q_rope (B, H, S, rope)."""
    a = cfg.mla
    dt = cfg.compute_dtype_
    if a.q_lora > 0:
        cq = rmsnorm(params["q_norm"], rows_matmul(x, params["wq_a"].to(dt)),
                     cfg.norm_eps)
        q = proj_heads(cq, params["wq_b"].to(dt)).transpose(1, 2)
    else:
        q = proj_heads(x, params["wq"].to(dt)).transpose(1, 2)
    q_nope, q_rope = q[..., :a.qk_nope], q[..., a.qk_nope:]
    q_rope = rope(q_rope, positions[:, None, :], cfg.rope_theta)
    return q_nope, q_rope


def _latent(params, x, cfg: ModelConfig, positions):
    """(B, S, d) → c_kv (B, S, kv_lora) normed, k_rope (B, S, rope) roped."""
    a = cfg.mla
    ckr = rows_matmul(x, params["wkv_a"].to(cfg.compute_dtype_))
    c_kv = rmsnorm(params["kv_norm"], ckr[..., :a.kv_lora], cfg.norm_eps)
    k_rope = rope(ckr[..., a.kv_lora:], positions, cfg.rope_theta)
    return c_kv, k_rope


def _absorb(q_nope, wk_b):
    """``einsum('bh…n,rhn->bh…r')``: each head's queries through its K
    up-projection, into latent space."""
    return torch.einsum("bhsn,rhn->bhsr", q_nope, wk_b)


def mla_apply(params, x: torch.Tensor, cfg: ModelConfig, *,
              positions: torch.Tensor, window: int = 0):
    """Train and prefill MLA, x (B, S, d) → y (B, S, d). Expanded form, or
    the absorbed form under ``opt_mla_absorbed`` (K/V never materialized
    per head). The prefill's cache entries come from
    ``mla_prefill_cache``."""
    a = cfg.mla
    dt = cfg.compute_dtype_
    B, S, _ = x.shape
    H = cfg.n_heads
    premult, intmax = _mode(cfg)

    q_nope, q_rope = _queries(params, x, cfg, positions)
    c_kv, k_rope = _latent(params, x, cfg, positions)
    scale = (a.qk_nope + a.qk_rope) ** -0.5 * premult

    if cfg.opt_mla_absorbed:
        q_abs = _absorb(q_nope, params["wk_b"].to(dt))   # (B,H,S,kv_lora)
        q_full = torch.cat([q_abs, q_rope], dim=-1)
        q_full = q_full * round_to(scale, q_full.dtype)
        k_full = torch.cat([c_kv, k_rope], dim=-1)[:, None]
        q_full = shard_act(q_full, ("batch", "act_heads", "seq", None))
        o_lat = chunked_attention(q_full, k_full, c_kv[:, None],
                                  causal=cfg.causal, intmax=intmax,
                                  window=window, chunk=cfg.attention_chunk)
        o = torch.einsum("bhsr,rhk->bhsk", o_lat, params["wv_b"].to(dt))
    else:
        k_nope = proj_heads(c_kv, params["wk_b"].to(dt)).transpose(1, 2)
        v = proj_heads(c_kv, params["wv_b"].to(dt)).transpose(1, 2)
        q = torch.cat([q_nope, q_rope], dim=-1)
        k = torch.cat([k_nope, k_rope[:, None].expand(B, H, S, a.qk_rope)],
                      dim=-1)
        q = q * round_to(scale, q.dtype)
        q = shard_act(q, ("batch", "act_heads", "seq", "head_dim"))
        k = shard_act(k, ("batch", "act_heads", "seq", "head_dim"))
        v = shard_act(v, ("batch", "act_heads", "seq", "head_dim"))
        o = chunked_attention(q, k, v, causal=cfg.causal, intmax=intmax,
                              window=window, chunk=cfg.attention_chunk)
    wo = params["wo"].to(dt)
    return rows_matmul(o.transpose(1, 2).flatten(2),
                       wo.reshape(-1, wo.shape[-1]))


def mla_prefill_cache(params, x, cfg: ModelConfig, positions):
    """Latent cache entries for the prefill tokens: c_kv (B, S, kv_lora)
    and k_rope (B, S, qk_rope), the values ``mla_apply`` attends to (the
    reference's ``mla_apply(..., return_cache=True)``)."""
    return _latent(params, x, cfg, positions)


def mla_decode(params, x1: torch.Tensor, cfg: ModelConfig, *,
               cache_ckv: torch.Tensor, cache_krope: torch.Tensor,
               cache_len: torch.Tensor):
    """Absorbed-form decode of one token, x1 (B, d), against the latent
    cache (B, S, kv_lora) / (B, S, qk_rope) holding ``cache_len`` (B,)
    rows. Writes the new rows in place and returns (y1 (B, d), cache_ckv,
    cache_krope). A linear write needs ``cache_len < S``; under
    ``opt_dus_cache`` every row is written at ``cache_len[0]``, clamped."""
    a = cfg.mla
    dt = cfg.compute_dtype_
    pos1 = cache_len[:, None]                       # (B, 1) its position
    q_nope, q_rope = _queries(params, x1[:, None, :], cfg, pos1)
    q_nope, q_rope = q_nope[:, :, 0], q_rope[:, :, 0]          # (B, H, ·)
    c1, kr1 = _latent(params, x1[:, None, :], cfg, pos1)       # (B, 1, ·)

    # absorb q through the K up-projection: scores live in latent space
    q_abs = _absorb(q_nope[:, :, None], params["wk_b"].to(dt))[:, :, 0]
    heads, rows = ("batch", "heads", None), ("batch", None, None)
    o_lat = run_local(
        lambda *t: _decode_latent(*t, cfg), (q_abs, q_rope, cache_len, c1,
                                             kr1, cache_ckv, cache_krope),
        (heads, heads, ("batch",)) + (rows,) * 4, keep=heads[:2])
    o = torch.einsum("bhr,rhk->bhk", o_lat, params["wv_b"].to(dt))
    wo = params["wo"].to(dt)
    y1 = o.flatten(1) @ wo.reshape(-1, wo.shape[-1])
    return y1, cache_ckv, cache_krope


def _decode_latent(q_abs, q_rope, cache_len, c1, kr1, cache_ckv,
                   cache_krope, cfg: ModelConfig):
    """``mla_decode``'s latent cache write (in place) and its attention
    over the latent rows, on (local) tensors: o_lat (B, H, kv_lora)."""
    a = cfg.mla
    dt = cfg.compute_dtype_
    S = cache_ckv.shape[1]
    if cfg.opt_dus_cache:
        pos = torch.clamp(cache_len[:1].long(), max=S - 1)
        cache_ckv.index_copy_(1, pos, c1.to(cache_ckv.dtype))
        cache_krope.index_copy_(1, pos, kr1.to(cache_krope.dtype))
    else:
        rows = torch.arange(q_abs.shape[0], device=q_abs.device)
        slot = cache_len.long()
        cache_ckv[rows, slot] = c1[:, 0].to(cache_ckv.dtype)
        cache_krope[rows, slot] = kr1[:, 0].to(cache_krope.dtype)
    new_len = cache_len + 1
    s = (q_abs @ cache_ckv.transpose(1, 2) +
         q_rope @ cache_krope.transpose(1, 2)).float()          # (B, H, S)
    premult, intmax = _mode(cfg)
    s = s * ((a.qk_nope + a.qk_rope) ** -0.5 * premult)
    live = torch.arange(S, device=q_abs.device)[None, None, :] < \
        new_len[:, None, None]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = torch.amax(torch.ceil(s) if intmax else s, dim=-1, keepdim=True)
    p = torch.exp2(s - m)
    den = torch.sum(p, dim=-1, keepdim=True)
    pos = den > 0
    p = torch.where(pos, p / torch.where(pos, den, torch.ones_like(den)),
                    torch.zeros_like(p))
    return p.to(dt) @ cache_ckv                                # (B, H, r)
