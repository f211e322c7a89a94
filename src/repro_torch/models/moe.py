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

``opt_moe_shard_map`` (expert parallelism, ROADMAP Queue 1 item 6a):
``moe_apply_shard_map`` over the ambient mesh's ``model`` axis, under the
reference's conditions (``moe_apply``); otherwise the global path. Each
rank routes its own tokens (``_local_dispatch``: the same stable top-k and
capacity ranks at a local capacity), ships each expert block to the rank
that owns the expert by ``all_to_all`` over ``model``, runs its E/n
experts (their weights gathered over ``data``, FSDP) and ships the results
back. Capacity is enforced per (token shard × expert), the standard EP
approximation, so routing drops can differ from the global path's.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.softermax import attention_softmax
from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.dtensor import run_local
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.layers import _activate, mlp, mlp_schema
from repro_torch.models.schema import ParamSpec
from repro_torch.parallel.sharding import shard_act


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
    # integer ranks over every token (no DTensor strategy for
    # searchsorted): on the whole replicated array, as a custom call
    weights, sel, keep, slot = run_local(
        lambda p: _select(p, k, E, C), (probs,), ((None, None),),
        out_axes=((None, None),) * 2 + ((None,),) * 2)
    return Routing(rl, probs, weights, sel, keep, slot)


def _select(probs: torch.Tensor, k: int, E: int, C: int):
    """(weights, sel) of the stable top-k, renormalized over the k, and per
    assignment (keep, slot): its rank within its expert in token order
    (a stable sort by expert id), dropped at rank ≥ C into slot ``E·C``."""
    T = probs.shape[0]
    weights, sel = top_k_stable(probs, k)
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    flat_e = sel.reshape(-1)                                   # (T·k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    starts = torch.searchsorted(
        sorted_e, torch.arange(E, dtype=flat_e.dtype, device=probs.device))
    rank_sorted = torch.arange(T * k, device=probs.device) - \
        starts[sorted_e]
    rank = torch.empty_like(rank_sorted)
    rank[order] = rank_sorted
    keep = rank < C
    slot = torch.where(keep, flat_e * C + rank,
                       torch.full_like(rank, E * C))
    return weights, sel, keep, slot


def moe_apply(params, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (y (B, S, d), aux loss scalar fp32). The expert-
    parallel path under ``opt_moe_shard_map`` when the ambient mesh has a
    ``model`` axis of 2 or more that divides the sequence and the experts;
    otherwise, and on placed (DTensor) activations, which it does not take,
    the global path."""
    from repro_torch.parallel.sharding import current_mesh
    mesh = current_mesh()
    if cfg.opt_moe_shard_map and mesh is not None and not is_dtensor(x):
        n = mesh_shape(mesh).get("model", 1)
        if n > 1 and x.shape[1] % n == 0 and cfg.moe.n_experts % n == 0:
            return moe_apply_shard_map(params, x, cfg, mesh)
    return _moe_apply_global(params, x, cfg)


def _aux_loss(probs, rl, sel, E: int, k: int, weight: float):
    """Switch load balance, E · Σ_e mean_prob_e · frac_dispatched_e, plus
    the router z-loss."""
    me = torch.mean(probs, dim=0)
    frac = torch.mean(F.one_hot(sel, E).float().sum(1), dim=0) / k
    aux = E * torch.sum(me * frac) * weight
    return aux + 1e-4 * torch.mean(torch.logsumexp(rl, dim=-1) ** 2)


def _experts(h, wi, wg, wo, activation):
    """The gated expert MLP over (E, C, d) slots."""
    a = _activate(torch.bmm(h, wi), activation)
    return torch.bmm(a * torch.bmm(h, wg), wo)


def _moe_apply_global(params, x: torch.Tensor, cfg: ModelConfig
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    dt = x.dtype
    # placed: the tokens flatten with the sequence whole (DTensor cannot
    # flatten two sharded dims into a product's rows)
    xf = shard_act(x, ("batch", None, "act_embed")).reshape(-1, d)
    T = xf.shape[0]
    C = capacity(T, cfg)
    r = route(params["router"], xf, cfg, C)

    aux = _aux_loss(r.probs, r.rl, r.sel, E, k, m.aux_loss_weight)
    ws = tuple(params[w].to(dt) for w in ("wi", "wg", "wo"))
    y = _experts_of(xf, r, ws, cfg, C)
    if m.n_shared > 0:
        y = y + mlp(params["shared"], xf, cfg.activation)
    return y.reshape(B, S, d), aux


def _experts_of(xf, r: Routing, ws, cfg: ModelConfig, C: int):
    """Dispatch, expert products and combine; placed, each a custom call
    on local shards (``kernels/dtensor.py``): the dispatch and the
    combine index every token's slots, so they run on the whole
    replicated arrays; the products keep the experts sharded, each
    product's contraction whole."""
    E, k = cfg.moe.n_experts, cfg.moe.top_k
    one, two, three = (None,), (None, None), (None, None, None)
    h = run_local(lambda *t: _dispatch(*t, k, E, C), (xf, r.keep, r.slot),
                  (two, one, one), out_axes=(three,))
    h = shard_act(h, ("experts", None, "act_embed"))
    e = ("experts", None, None)
    y_buf = run_local(lambda *t: _experts(*t, cfg.activation), (h, *ws),
                      (e,) * 4, keep=e[:1])
    y_buf = shard_act(y_buf, ("experts", None, "act_embed"))
    return run_local(lambda *t: _combine(*t, E, C),
                     (y_buf, r.keep, r.slot, r.weights),
                     (three, one, one, two), out_axes=(two,))


def _dispatch(xf, keep, slot, k: int, E: int, C: int):
    """(E, C, d) expert slots of the tokens xf (T, d); every dropped
    assignment lands in a dummy last row, cut off."""
    T, d = xf.shape
    tok = torch.arange(T * k, device=xf.device) // k
    src = xf[tok] * keep[:, None].to(xf.dtype)
    buf = torch.zeros((E * C + 1, d), dtype=xf.dtype, device=xf.device) \
        .index_add(0, slot, src)
    return buf[:-1].reshape(E, C, d)


def _combine(y_buf, keep, slot, weights, E: int, C: int):
    """(T, d): each token's k slot outputs weighted, in the compute dtype."""
    d = y_buf.shape[-1]
    safe_slot = torch.clamp(slot, max=E * C - 1)
    w = (keep[:, None] * weights.reshape(-1)[:, None]).to(y_buf.dtype)
    y_tok = y_buf.reshape(E * C, d)[safe_slot] * w
    return y_tok.reshape(-1, weights.shape[1], d).sum(1)


def _local_dispatch(xf, probs, k: int, E: int, C: int, dt):
    """Sort-based capacity dispatch of one rank's tokens xf (T, d), probs
    (T, E): (buf (E, C, d), slot (T·k,), keep (T·k,), weights (T, k), sel
    (T, k)), as the reference's."""
    weights, sel, keep, slot = _select(probs, k, E, C)
    return _dispatch(xf.to(dt), keep, slot, k, E, C), slot, keep, \
        weights, sel


def moe_apply_shard_map(params, x: torch.Tensor, cfg: ModelConfig, mesh
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE over ``mesh`` (a ``DeviceMesh``): x (B, S, d),
    global on every rank, is split as the reference's ``x_spec`` (batch
    over the ``pod``/``data`` axes where it divides, sequence over
    ``model``); each rank dispatches its tokens locally at capacity
    C = roundup4(max(4, ceil(T_loc·k/E)·capacity_factor)), all-to-alls the
    blocks to the experts' owners (E/n_model experts a rank, their weights'
    d dimension sharded over ``data`` and all-gathered), and back. Returns
    the global (y, aux) on every rank; the aux loss is the mean over
    ``model``, then over the batch axes (over ``model`` alone where the
    batch is not split: the batch axes' ranks then hold the same value).
    Gradients follow ``parallel.collectives``' convention: a weight's
    gradient is summed over the ranks that used it on other tokens."""
    from repro_torch.parallel.collectives import (all_to_all, axis_group,
                                                  gather, pmean, shard,
                                                  sum_grad)
    m = cfg.moe
    B, S, d = x.shape
    E, k = m.n_experts, m.top_k
    sizes = mesh_shape(mesh)
    gm, im, n_model = axis_group(mesh, "model")
    batch_axes = [a for a in ("pod", "data") if a in sizes]
    n_data = math.prod(sizes[a] for a in batch_axes)
    split_batch = B % n_data == 0
    b_loc = B // n_data if split_batch else B
    T_loc = b_loc * (S // n_model)
    C = int(max(4, -(-T_loc * k // E) * m.capacity_factor))
    C = -(-C // 4) * 4
    E_loc = E // n_model
    dt = x.dtype
    # the axes over which ranks hold other tokens: model (the sequence) and,
    # where the batch splits, the batch axes
    token_axes = ["model"] + (batch_axes if split_batch else [])

    # x_spec: batch over the batch axes (major to minor), seq over model
    places = [(0, axis_group(mesh, a)) for a in batch_axes] \
        if split_batch else []
    places.append((1, (gm, im, n_model)))
    x_l = x
    for dim, (g, i, n) in places:
        x_l = shard(x_l, dim, g, i, n)

    # this rank's experts; their d dimension's data shard, gathered (FSDP)
    def expert_weights(w, d_dim):
        w = shard(w, 0, gm, im, n_model)
        if "data" in sizes:
            g, i, n = axis_group(mesh, "data")
            w = gather(shard(w, d_dim, g, i, n), d_dim, g, i, n,
                       reduce=split_batch)
        if split_batch and "pod" in sizes:
            g, _, n = axis_group(mesh, "pod")
            w = sum_grad(w, g, n)
        return w.to(dt)

    wi = expert_weights(params["wi"], 1)
    wg = expert_weights(params["wg"], 1)
    wo = expert_weights(params["wo"], 2)
    router = params["router"]
    token_groups = [axis_group(mesh, a) for a in token_axes]
    for g, _, n in token_groups:
        router = sum_grad(router, g, n)

    T = x_l.shape[0] * x_l.shape[1]
    xf = x_l.reshape(T, d)
    rl = (xf @ router.to(dt)).float()
    probs = attention_softmax(rl, impl=m.router_softmax, axis=-1)
    buf, slot, keep, weights, sel = _local_dispatch(xf, probs, k, E, C, dt)

    # aux from local statistics, averaged over model, then the batch axes
    aux = _aux_loss(probs, rl, sel, E, k, m.aux_loss_weight)
    for g, _, n in token_groups:
        aux = pmean(aux, g, n)

    # ship expert blocks to their owners: (n_model, E_loc·C, d)
    recv = all_to_all(buf.reshape(n_model, E_loc * C, d), gm, n_model)
    h = recv.reshape(n_model, E_loc, C, d).transpose(0, 1) \
        .reshape(E_loc, n_model * C, d)
    y_h = _experts(h, wi, wg, wo, cfg.activation)
    back = y_h.reshape(E_loc, n_model, C, d).transpose(0, 1) \
        .reshape(n_model, E_loc * C, d)
    y_buf = all_to_all(back, gm, n_model)
    y = _combine(y_buf, keep, slot, weights, E, C).reshape(x_l.shape)
    for dim, (g, i, n) in reversed(places):
        y = gather(y, dim, g, i, n)
    if m.n_shared > 0:
        y = y + mlp(params["shared"], x, cfg.activation)
    return y, aux
