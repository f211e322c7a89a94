"""Shared neural-net layers: RMS and Layer norms, MLPs, embeddings, rotary
and sinusoidal positions, the cross-entropy loss.

Functional, as in the JAX package: ``*_schema`` returns ParamSpecs, the
apply functions take the parameter tensors. Compute runs in
``cfg.compute_dtype`` with fp32 norms and logits.
"""
from __future__ import annotations

import functools

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ModelConfig
from repro_torch.models.schema import ParamSpec
from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.dtensor import (all_reduce_local, dims,
                                         rows_matmul, run_local,
                                         shard_offset, sharded_by)
from repro_torch.parallel.sharding import shard_act


def rmsnorm_schema(dim: int, logical: str = "embed"):
    return {"scale": ParamSpec((dim,), (logical,), init="ones")}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMS norm in fp32, returned in the input dtype."""
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * params["scale"].float()).to(dt)


def layernorm_schema(dim: int, logical: str = "embed"):
    return {
        "scale": ParamSpec((dim,), (logical,), init="ones"),
        "bias": ParamSpec((dim,), (logical,), init="zeros"),
    }


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in fp32, returned in the input dtype. ``scale`` and
    ``bias`` enter as they are stored: an fp32 ``y`` times a bf16 scale
    promotes to fp32 in both frameworks."""
    dt = x.dtype
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps)
    return (y * params["scale"] + params["bias"]).to(dt)


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
    h = _activate(rows_matmul(x, params["wi"].to(dt)), activation)
    if "wg" in params:
        h = h * rows_matmul(x, params["wg"].to(dt))
    # rank 3 = (batch, seq, ff): keep the seq shard under seq-parallel rules
    logical = (("batch", "seq", "act_mlp") if h.dim() == 3 else
               ("batch",) + (None,) * (h.dim() - 2) + ("act_mlp",))
    h = shard_act(h, logical)
    return rows_matmul(h, params["wo"].to(dt))


def embedding_schema(cfg: ModelConfig):
    s = {"embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                ("vocab", "embed"), init="embed", std=1.0)}
    if not cfg.tie_embeddings:
        s["unembed"] = ParamSpec((cfg.d_model, cfg.padded_vocab),
                                 ("embed", "vocab"))
    return s


def embed(params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The token rows of the table in the compute dtype. A placed table
    whose vocab is sharded is a vocab-parallel embedding
    (``_vocab_parallel_rows``); any other placed table gathers on the
    whole replicated arrays, as a custom call: DTensor's gather and its
    backward (``index_put``) do not shard reliably."""
    x = embed_rows(params["embedding"].to(cfg.compute_dtype_), tokens)
    return shard_act(x, ("batch", "seq", "act_embed"))


def embed_rows(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``, placed as ``embed`` says."""
    if is_dtensor(table) and sharded_by(table, 0):
        return _vocab_parallel_rows(table, tokens)
    tok = dims(tokens, 0)
    return run_local(lambda i, t: t[i], (tokens, table), (tok, (None, None)),
                     keep=tok, out_axes=(tok + (None,),))


def _token_placements(x, vd: int, vdims):
    """Per mesh dim: ``Shard(vd)`` on the vocab's dims ``vdims``, a shard of
    a token dim (< ``vd``) of ``x`` where it has one, else replicated."""
    return tuple(Shard(vd) if i in vdims else
                 p if p.is_shard() and p.dim < vd else Replicate()
                 for i, p in enumerate(x.placements))


def _wrap(local, mesh, placements, shape):
    return DTensor.from_local(local, mesh, placements, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def _as_dtensor(x, mesh):
    return x if is_dtensor(x) else DTensor.from_local(
        x, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _vocab_parallel_rows(table, tokens):
    """Each rank takes, for every token of its batch shard, the row its
    vocab shard holds (zero where another shard holds it), summed over the
    vocab's mesh dims. The table is gathered along ``embed`` alone (its
    FSDP shard); its gradient stays sharded along the vocab."""
    mesh = table.device_mesh
    vdims = sharded_by(table, 0)
    tokens = _as_dtensor(tokens, mesh)
    tok_pl = tuple(Replicate() if i in vdims else
                   p if p.is_shard() else Replicate()
                   for i, p in enumerate(tokens.placements))
    t_pl = tuple(Shard(0) if i in vdims else Replicate()
                 for i in range(mesh.ndim))
    # the local table's gradient sums over the token shards of other dims
    g_pl = tuple(Shard(0) if i in vdims else
                 Partial() if tok_pl[i].is_shard() else Replicate()
                 for i in range(mesh.ndim))
    t = table.redistribute(mesh, t_pl).to_local(grad_placements=g_pl)
    i = tokens.redistribute(mesh, tok_pl).to_local()
    n = t.shape[0]
    rel = i.long() - shard_offset(mesh, vdims, n)
    inside = (rel >= 0) & (rel < n)
    rows = torch.where(inside[..., None], t[rel.clamp(0, n - 1)], 0)
    rows = all_reduce_local(rows, [mesh.get_group(d) for d in vdims])
    return _wrap(rows, mesh, tok_pl, (*tokens.shape, t.shape[1]))


def logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final projection: a compute-dtype product, cast to fp32."""
    if cfg.tie_embeddings:
        w = params["embedding"].to(cfg.compute_dtype_).t()
    else:
        w = params["unembed"].to(cfg.compute_dtype_)
    lg = rows_matmul(x, w).float()
    return shard_act(lg, ("batch",) + ("seq",) * (lg.dim() - 2) + ("vocab",))


@functools.lru_cache(maxsize=64)
def round_to(x: float, dtype: torch.dtype) -> float:
    """A Python scalar rounded to ``dtype`` (on the host: a device scalar
    would cost a stream-synchronizing copy)."""
    return torch.tensor(x, dtype=dtype).item()


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


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    """The fixed sinusoidal table (n, d) fp32 of whisper's encoder: sin in
    the even columns, cos in the odd ones, at angle ``pos / 10000 **
    (dim / d)`` computed in fp32."""
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=device), dim / d)
    pe = torch.zeros((n, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def cross_entropy_loss(lg: torch.Tensor, labels: torch.Tensor,
                       z_loss: float = 0.0, vocab_size=None) -> torch.Tensor:
    """Token-mean cross entropy with optional z-loss; ignores labels < 0.
    Padded vocab entries (ids >= ``vocab_size``) are masked to -1e9 before
    the log-sum-exp. Placed logits whose vocab is sharded keep it sharded
    (``_vocab_parallel_nll``); other placed logits take each token's terms
    on local shards with every vocab row whole (a custom call). The mean
    is over the whole batch."""
    if is_dtensor(lg) and sharded_by(lg, lg.dim() - 1):
        nll, valid = _vocab_parallel_nll(lg, labels, z_loss, vocab_size)
    else:
        tok = dims(labels, 0)
        nll, valid = run_local(
            lambda a, b: _token_nll(a, b, z_loss, vocab_size), (lg, labels),
            (dims(lg), tok), keep=tok, out_axes=(tok, tok))
    denom = torch.clamp(valid.sum(), min=1)
    return nll.sum() / denom


def _vocab_parallel_nll(lg, labels, z_loss, vocab_size):
    """``_token_nll`` on vocab-sharded logits: each token's log-sum-exp
    from its shard's max (all-reduced, max) and sum of ``exp(x - max)``
    (all-reduced, sum) over the vocab's mesh dims, the label's logit from
    a masked gather on the shard that holds it (all-reduced, sum). The
    gradient stays on each rank's shard."""
    mesh, vd = lg.device_mesh, lg.dim() - 1
    vdims = sharded_by(lg, vd)
    pl = _token_placements(lg, vd, vdims)
    tok_pl = tuple(Replicate() if i in vdims else p
                   for i, p in enumerate(pl))
    x = lg.redistribute(mesh, pl).to_local(grad_placements=pl)
    lab = _as_dtensor(labels, mesh).redistribute(mesh, tok_pl).to_local()
    n = x.shape[-1]
    v0 = shard_offset(mesh, vdims, n)
    if vocab_size is not None and vocab_size < lg.shape[-1]:
        mask = torch.arange(v0, v0 + n, device=x.device) < vocab_size
        x = torch.where(mask, x, torch.full((), -1e9, dtype=x.dtype,
                                            device=x.device))
    groups = [mesh.get_group(d) for d in vdims]
    m = all_reduce_local(torch.amax(x, dim=-1).detach(), groups,
                         dist.ReduceOp.MAX)
    lse = m + torch.log(all_reduce_local(
        torch.sum(torch.exp(x - m[..., None]), dim=-1), groups))
    valid = lab >= 0
    rel = torch.clamp(lab, min=0).long() - v0
    inside = (rel >= 0) & (rel < n)
    ll = torch.gather(x, -1, rel.clamp(0, n - 1)[..., None])[..., 0]
    ll = all_reduce_local(torch.where(inside, ll, 0), groups)
    nll = lse - ll
    if z_loss:
        nll = nll + z_loss * lse ** 2
    nll = torch.where(valid, nll, torch.zeros_like(nll))
    return (_wrap(nll, mesh, tok_pl, labels.shape),
            _wrap(valid, mesh, tok_pl, labels.shape))


def _token_nll(lg, labels, z_loss, vocab_size):
    """(each token's cross entropy (+ z-loss), 0 where its label is < 0;
    where it is not)."""
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
    return torch.where(valid, nll, torch.zeros_like(nll)), valid
