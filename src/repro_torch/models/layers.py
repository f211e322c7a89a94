"""Shared neural-net layers: norms, MLPs, embeddings, rotary embeddings,
the cross-entropy loss.

Functional, as in the JAX package: ``*_schema`` returns ParamSpecs, the
apply functions take the parameter tensors. Compute runs in
``cfg.compute_dtype`` with fp32 norms and logits.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import ParamSpec


def rmsnorm_schema(dim: int, logical: str = "embed"):
    return {"scale": ParamSpec((dim,), (logical,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, returned in the input dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def mlp_schema(d_model: int, d_ff: int, gated: bool = True):
    s = {
        "wi": ParamSpec((d_model, d_ff), ("embed", "mlp")),
        "wo": ParamSpec((d_ff, d_model), ("mlp", "embed")),
    }
    if gated:
        s["wg"] = ParamSpec((d_model, d_ff), ("embed", "mlp"))
    return s


def _activate(h: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "silu":
        return F.silu(h)
    if activation == "gelu":
        return F.gelu(h, approximate="tanh")     # jax.nn.gelu's default
    if activation == "relu2":                     # squared ReLU
        r = F.relu(h)
        return r * r
    raise ValueError(activation)


def mlp(params, x: torch.Tensor, activation: str = "silu") -> torch.Tensor:
    dt = x.dtype
    h = _activate(x @ params["wi"].to(dt), activation)
    if "wg" in params:
        h = h * (x @ params["wg"].to(dt))
    return h @ params["wo"].to(dt)


def embedding_schema(cfg: ModelConfig):
    s = {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="embed", std=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                 ("embed", "vocab"))
    return s


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return params["embedding"].to(cfg.compute_dtype_)[tokens]


def logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final projection: a compute-dtype product, cast to fp32."""
    if cfg.tie_embeddings:
        w = params["embedding"].to(cfg.compute_dtype_).t()
    else:
        w = params["unembed"].to(cfg.compute_dtype_)
    return (x @ w).float()


@functools.lru_cache(maxsize=16)
def _rope_freqs(theta: float, half: int, device: torch.device):
    """``exp(-log θ · i / half)`` in fp32, computed once per (θ, width,
    device) on the CPU — a per-call host-to-device copy would stall the
    stream."""
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(-log_theta * torch.arange(half, dtype=torch.float32)
                      / half)
    return freqs.to(device)


def rope_cos_sin(positions: torch.Tensor, theta: float, half: int):
    """The RoPE rotation (cos, sin) of ``positions`` (..., seq) →
    (..., seq, half), reusable by every layer at those positions."""
    angles = positions[..., None].float() * _rope_freqs(theta, half,
                                                        positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 10000.0) -> torch.Tensor:
    """Apply RoPE over the last axis. x: (..., seq, d); positions: (..., seq).

    The JAX package's own frequency formula, ``exp(-log θ · i / half)`` in
    fp32 (not torch's usual ``θ^(-2i/d)``), so the angles agree."""
    return apply_rope(x, *rope_cos_sin(positions, theta, x.shape[-1] // 2))


def cross_entropy_loss(lg: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0, vocab_size=None) -> torch.Tensor:
    """Token-mean cross entropy with optional z-loss; ignores labels < 0.
    Padded vocab entries (ids >= ``vocab_size``) are masked to -1e9 before
    the log-sum-exp."""
    if vocab_size is not None and vocab_size < lg.shape[-1]:
        mask = torch.arange(lg.shape[-1], device=lg.device) < vocab_size
        lg = torch.where(mask, lg, torch.full((), -1e9, dtype=lg.dtype,
                                              device=lg.device))
    valid = labels >= 0
    labels_c = torch.clamp(labels, min=0).long()
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels_c[..., None])[..., 0]
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    denom = torch.clamp(valid.sum(), min=1)
    return nll.sum() / denom
