"""Mixture-of-Experts FFN with sort-based capacity dispatch.

The JAX package's ``repro.models.moe`` global path, step for step (per
layer, tokens flattened to T = B·S):

1. Router logits ``xf @ router`` in the compute dtype, cast to fp32, and
   probabilities through ``attention_softmax(impl=cfg.moe.router_softmax)``:
   on a CUDA tensor the row kernel K6 (and its autograd backward), on a
   CPU tensor its plain version.
2. top-k experts per token with ``jax.lax.top_k``'s tie rule (equal
   probabilities go to the lower expert id): a stable descending sort,
   not ``torch.topk``, whose order among equal values is unspecified. The
   k weights are renormalized over the selection.
3. Capacity-bounded dispatch: C = roundup8(max(8, ceil(T·k/E)·capacity
   factor)) slots per expert; assignments are ranked within their expert
   in token order (a stable sort by expert id), and an assignment of rank
   ≥ C is dropped into a dummy slot. C is taken over the T tokens of one
   call, so a token's routing depends on the tokens before it in the
   same call, padding rows included.
4. The expert gated MLP over all E×C slots as three batched products.
5. Combine with the routing weights in the compute dtype; add the shared
   experts' MLP when ``n_shared > 0``.

Aux loss: the switch load-balance loss plus the router z-loss.

``opt_moe_shard_map`` (expert parallelism over a process group) waits for
the port of ``parallel/`` (ROADMAP Queue 1 item 6); without a process
group of more than one rank ``moe_apply`` takes the global path, as the
reference does without a mesh.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.softermax import attention_softmax
from repro_torch.models.layers import _activate, mlp, mlp_schema
from repro_torch.models.schema import ParamSpec


def moe_schema(cfg: ModelConfig):
    m = cfg.moe
    d = cfg.d_model
    s = {
        "router": ParamSpec((d, m.n_experts), ("embed", "experts"), std=0.02),
        "wi": ParamSpec((m.n_experts, d, m.d_expert),
                        ("experts", "embed", "expert_mlp")),
        "wg": ParamSpec((m.n_experts, d, m.d_expert),
                        ("experts", "embed", "expert_mlp")),
        "wo": ParamSpec((m.n_experts, m.d_expert, d),
                        ("experts", "expert_mlp", "embed")),
    }
    if m.n_shared > 0:
        s["shared"] = mlp_schema(d, m.n_shared * (m.d_shared or m.d_expert))
    return s


def capacity(T: int, cfg: ModelConfig) -> int:
    """Slots per expert for a call of T tokens, in the reference's integer
    arithmetic."""
    m = cfg.moe
    C = int(max(8, -(-T * m.top_k // m.n_experts) * m.capacity_factor))
    return -(-C // 8) * 8


def top_k_stable(probs: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, in
    descending order, equal values in ascending index order (the rule of
    ``jax.lax.top_k``)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class Routing(NamedTuple):
    """One call's routing: ``rl`` (T, E) fp32 logits, ``probs`` (T, E),
    ``weights`` / ``sel`` (T, k), and per assignment (T·k,) ``keep`` and
    ``slot`` (``E·C`` for a dropped one)."""
    rl: torch.Tensor
    probs: torch.Tensor
    weights: torch.Tensor
    sel: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor


def route(router: torch.Tensor, xf: torch.Tensor, cfg: ModelConfig,
          C: int) -> Routing:
    """Router, top-k and capacity ranks of the tokens xf (T, d)."""
    m = cfg.moe
    E, k = m.n_experts, m.top_k
    T = xf.shape[0]
    rl = (xf @ router.to(xf.dtype)).float()                    # (T, E)
    probs = attention_softmax(rl, impl=m.router_softmax, axis=-1)
    weights, sel = top_k_stable(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    flat_e = sel.reshape(-1)                                   # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=flat_e.dtype, device=xf.device))
    rank_sorted = torch.arange(T * k, device=xf.device) - starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank,
                       torch.full_like(rank, E * C))
    return Routing(rl, probs, weights, sel, keep, slot)


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss scalar fp32). Expert
    parallelism (``opt_moe_shard_map`` over a process group of more than
    one rank) is not ported; otherwise the global path."""
    if cfg.opt_moe_shard_map and torch.distributed.is_available() and \
            torch.distributed.is_initialized() and \
            torch.distributed.get_world_size() > 1:
        raise NotImplementedError(
            "opt_moe_shard_map over a process group needs the port of "
            "parallel/ (ROADMAP Queue 1 item 6)")
    return _moe_apply_global(params, x, cfg)


def _moe_apply_global(params, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    dt = x.dtype
    xf = x.reshape(-1, d)
    T = xf.shape[0]
    C = capacity(T, cfg)
    r = route(params["router"], xf, cfg, C)

    # load balance: E · Σ_e mean_prob_e · frac_dispatched_e; router z-loss
    me = torch.mean(r.probs, dim=0)
    frac = torch.mean(F.one_hot(r.sel, E).float().sum(1), dim=0) / k
    aux = E * torch.sum(me * frac) * m.aux_loss_weight
    aux = aux + 1e-4 * torch.mean(torch.logsumexp(r.rl, dim=-1) ** 2)

    # dispatch into (E·C + 1, d); the last row takes every dropped one
    tok = torch.arange(T * k, device=x.device) // k
    src = xf[tok] * r.keep[:, None].to(dt)
    buf = torch.zeros((E * C + 1, d), dtype=dt, device=x.device) \
        .index_add(0, r.slot, src)
    h = buf[:-1].reshape(E, C, d)

    a = _activate(torch.bmm(h, params["wi"].to(dt)), cfg.activation)
    a = a * torch.bmm(h, params["wg"].to(dt))
    y_buf = torch.bmm(a, params["wo"].to(dt))

    # combine
    safe_slot = torch.clamp(r.slot, max=E * C - 1)
    w = (r.keep[:, None] * r.weights.reshape(-1)[:, None]).to(dt)
    y_tok = y_buf.reshape(E * C, d)[safe_slot] * w
    y = y_tok.reshape(T, k, d).sum(1)
    if m.n_shared > 0:
        y = y + mlp(params["shared"], xf, cfg.activation)
    return y.reshape(B, S, d), aux
