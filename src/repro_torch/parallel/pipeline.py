"""GPipe-style pipeline parallelism over a mesh axis (the JAX package's
``repro.parallel.pipeline``).

The layer-stacked parameters ``(L, ...)`` split over the pipeline axis on
their leading dim: each of its n ranks owns L/n contiguous layers (its
*stage*). The global batch splits into M microbatches that flow through
the ranks over ``M + n - 1`` ticks: on tick t, rank r runs microbatch
t - r when it exists (rank 0 ingests it from the input, the others
receive it from rank r - 1), sends its output to rank r + 1, and the last
rank banks it. The bubble fraction is the standard (n-1)/(M+n-1); the
reference runs the bubble ticks on clipped garbage, which changes no
result, and here they are idle. The result is broadcast from the last
rank, as the reference's masked ``psum`` does.

The backward (``_Pipeline``, an autograd Function) runs the reverse
schedule: the last rank starts from the output's gradient, each rank
back-propagates its stage microbatch by microbatch in reverse order and
sends the input gradient to rank r - 1; rank 0's input gradients are
broadcast, each rank's layer gradients all-gathered, so every rank ends
with the full gradients (``parallel.collectives``' convention).
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from repro_torch.models.schema import tree_leaves
from repro_torch.parallel.collectives import (all_gather_cat, axis_group,
                                              group_peer)


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(treedef)


def _stage_slice(leaves, index, n):
    return [l[index * (l.shape[0] // n):(index + 1) * (l.shape[0] // n)]
            for l in leaves]


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_micro, treedef, stage_fn, group, index, n, *leaves):
        M = x_micro.shape[0]
        grad = any(ctx.needs_input_grad)
        stage = [l.detach().requires_grad_(ctx.needs_input_grad[6 + i])
                 for i, l in enumerate(_stage_slice(leaves, index, n))]
        params = _unflatten(treedef, stage)
        ins, outs = [], []
        buf = torch.empty_like(x_micro)
        sends = []
        for t in range(M + n - 1):
            i = t - index                      # the microbatch of this tick
            if not 0 <= i < M:
                continue
            if index == 0:
                cur = x_micro[i]
            else:
                cur = torch.empty_like(x_micro[i])
                dist.recv(cur, group_peer(group, index - 1), group)
            cur = cur.detach().requires_grad_(grad and (
                index > 0 or ctx.needs_input_grad[0]))
            with torch.set_grad_enabled(grad):
                out = stage_fn(params, cur)
            ins.append(cur)
            outs.append(out)
            if index < n - 1:
                sent = out.detach().contiguous()
                sends.append((sent, dist.isend(
                    sent, group_peer(group, index + 1), group)))
            else:
                buf[i] = out.detach()
        for _, s in sends:
            s.wait()
        dist.broadcast(buf, group_peer(group, n - 1), group)
        ctx.args = (group, index, n, stage)
        ctx.graph = (ins, outs)
        return buf

    @staticmethod
    def backward(ctx, g):
        group, index, n, stage = ctx.args
        ins, outs = ctx.graph
        M = g.shape[0]
        dx = torch.zeros_like(g)
        sends = []
        for i in reversed(range(M)):
            if index == n - 1:
                dy = g[i]
            else:
                dy = torch.empty_like(g[i])
                dist.recv(dy, group_peer(group, index + 1), group)
            need = [t for t in [ins[i]] + stage if t.requires_grad]
            grads = torch.autograd.grad(outs[i], need, dy,
                                        allow_unused=True)
            got = dict(zip(map(id, need), grads))
            for p in stage:
                if p.requires_grad and got[id(p)] is not None:
                    p.grad = got[id(p)] if p.grad is None else \
                        p.grad + got[id(p)]
            gx = got.get(id(ins[i]))
            if index > 0:
                gx = gx.contiguous()
                sends.append((gx, dist.isend(
                    gx, group_peer(group, index - 1), group)))
            elif gx is not None:
                dx[i] = gx
        for _, s in sends:
            s.wait()
        dist.broadcast(dx, group_peer(group, 0), group)
        dleaves = [None if not p.requires_grad else all_gather_cat(
            torch.zeros_like(p) if p.grad is None else p.grad, 0, group, n)
            for p in stage]
        ctx.graph = None
        return (dx, None, None, None, None, None, *dleaves)


def pipeline_apply(
    stacked_params,          # (L, ...) tree, L % n_stages == 0
    x: torch.Tensor,         # (B, S, d) global batch, on every rank
    mesh,
    stage_fn: Callable,      # (layer-stack slice, x) -> x
    *,
    axis_name: str = "pod",
    microbatches: int = 4,
) -> torch.Tensor:
    """Run the stacked layers as an n-stage GPipe pipeline over
    ``axis_name``; returns the (B, S, d) output on every rank."""
    group, index, n = axis_group(mesh, axis_name)
    B = x.shape[0]
    if B % microbatches:
        raise ValueError(f"batch {B} does not split into {microbatches} "
                         "microbatches")
    leaves = tree_leaves(stacked_params)
    L = leaves[0].shape[0]
    if L % n:
        raise ValueError(f"{L} layers do not split over {n} stages")
    x_micro = x.reshape((microbatches, B // microbatches) + x.shape[1:])
    out = _Pipeline.apply(x_micro, stacked_params, stage_fn, group, index,
                          n, *leaves)
    return out.reshape(x.shape)
