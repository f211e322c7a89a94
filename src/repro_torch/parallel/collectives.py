"""Collectives over ``torch.distributed`` process groups.

``compressed_psum`` (the JAX package's ``repro.parallel.collectives``)
quantizes a tensor to int8 with one scale shared by the group, sums the
codes as int32 (no overflow below 2^24 participants) and dequantizes: an
8x cut of the gradient all-reduce's payload. The local quantization error
is returned for error feedback (added to the next step's gradient before
quantization, which keeps compressed SGD convergent). The data-parallel
step ``train.step.make_ddp_train_step`` uses it under
``tc.grad_compression``.

The rest are the differentiable pieces the explicit-collective paths
(``ring_attention``, ``pipeline_apply``, ``moe_apply_shard_map``) build
on, where JAX's ``shard_map`` transposes its collectives for ``jax.grad``.
They keep one convention: a tensor that enters replicated on every rank
(the global q of the ring, the global stacked parameters) leaves with its
full gradient on every rank, and a replicated result (the gathered output)
takes an identical gradient on every rank, so every rank's loss is the
same function of the same global tensors.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.distributed as dist

from repro_torch.models.schema import tree_map


def axis_group(mesh, axis: str):
    """(process group, this rank's index along ``axis``, the axis' size)."""
    return (mesh.get_group(axis), mesh.get_local_rank(axis),
            mesh.mesh.shape[mesh.mesh_dim_names.index(axis)])


def group_peer(group, index: int) -> int:
    """The global rank of ``group``'s member ``index``."""
    return dist.get_process_group_ranks(group)[index]


_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


def compressed_psum(x: torch.Tensor, group=None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """int8 error-feedback all-reduce mean over ``group``. Returns
    (mean of the quantized tensors, local residual), in ``x``'s dtype.

    Bit for bit the reference as XLA compiles it: the division of the
    scale by the constant 127 becomes a product with its float32
    reciprocal, and ``xf - q * scale`` one fused multiply-add, which
    rounds once (emulated in float64, where q · scale, 8 bits by 24, and
    the difference, under scale / 2 beside xf, are exact)."""
    xf = x.float()
    amax = torch.amax(torch.abs(xf))
    # shared scale so dequantization is consistent across participants
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(amax, min=1e-12) * _INV127
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    residual = (xf.double() - q.double() * scale.double()).float()
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = float(dist.get_world_size(group))
    mean = (total.float() * scale) / n
    return mean.to(x.dtype), residual.to(x.dtype)


def compressed_psum_tree(grads, group=None, errors=None):
    """Tree-wise compressed all-reduce with error feedback: (means,
    residuals), each a tree like ``grads``."""
    if errors is None:
        errors = tree_map(torch.zeros_like, grads)
    fed = tree_map(lambda g, e: g + e, grads, errors)
    out = tree_map(lambda g: compressed_psum(g, group), fed)
    return (tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out))


def pmean_tree(tree, group=None):
    """Every leaf all-reduced to its mean over ``group`` (``lax.pmean``)."""
    n = float(dist.get_world_size(group))

    def mean(t):
        t = t.clone()
        dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        return t / n

    return tree_map(mean, tree)


def all_gather_cat(x: torch.Tensor, dim: int, group, size: int
                   ) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in member order."""
    if size == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, dim)


def _chunk(x: torch.Tensor, dim: int, index: int, size: int
           ) -> torch.Tensor:
    n = x.shape[dim] // size
    return x.narrow(dim, index * n, n)


class _Shard(torch.autograd.Function):
    """This member's slice of a replicated tensor along ``dim``; the
    gradient comes back whole on every member (an all-gather)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size):
        ctx.args = (dim, group, size)
        return _chunk(x, dim, index, size).contiguous()

    @staticmethod
    def backward(ctx, g):
        dim, group, size = ctx.args
        return all_gather_cat(g, dim, group, size), None, None, None, None


class _Gather(torch.autograd.Function):
    """The members' slices concatenated along ``dim``. With ``reduce``,
    the members' gradients of the whole are summed before each takes its
    slice (a reduce-scatter: each member's loss used the gathered tensor
    in its own way); without it each takes its slice of its own gradient
    (the gathered tensor is replicated and so is what follows)."""

    @staticmethod
    def forward(ctx, x, dim, group, index, size, reduce):
        ctx.args = (dim, group, index, size, reduce)
        return all_gather_cat(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        dim, group, index, size, reduce = ctx.args
        if reduce and size > 1:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return (_chunk(g, dim, index, size).contiguous(), None, None, None,
                None, None)


class _AllToAll(torch.autograd.Function):
    """Block i of dim 0 goes to member i; block j of the result came from
    member j. Its own inverse, so the backward is the same exchange."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.args = (group, size)
        return _all_to_all(x, group, size)

    @staticmethod
    def backward(ctx, g):
        group, size = ctx.args
        return _all_to_all(g, group, size), None, None


def _all_to_all(x, group, size):
    if size == 1:
        return x
    out = [torch.empty_like(t) for t in x.unbind(0)]
    dist.all_to_all(out, [t.contiguous() for t in x.unbind(0)], group=group)
    return torch.stack(out)


class _SumGrad(torch.autograd.Function):
    """Identity; the members' gradients are summed (a replicated tensor
    that each member used on its own share of the work)."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.args = (group, size)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        group, size = ctx.args
        if size > 1:
            g = g.contiguous().clone()
            dist.all_reduce(g, op=dist.ReduceOp.SUM, group=group)
        return g, None, None


class _Mean(torch.autograd.Function):
    """The members' mean (``lax.pmean``) of a value each computed from its
    own share; each member's gradient is its 1/n of the replicated one."""

    @staticmethod
    def forward(ctx, x, group, size):
        ctx.size = size
        x = x.clone()
        if size > 1:
            dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
        return x / size

    @staticmethod
    def backward(ctx, g):
        return g / ctx.size, None, None


def shard(x, dim, group, index, size):
    return _Shard.apply(x, dim, group, index, size) if size > 1 else x


def gather(x, dim, group, index, size, reduce=False):
    return _Gather.apply(x, dim, group, index, size, reduce) \
        if size > 1 else x


def all_to_all(x, group, size):
    return _AllToAll.apply(x, group, size) if size > 1 else x


def sum_grad(x, group, size):
    return _SumGrad.apply(x, group, size) if size > 1 else x


def pmean(x, group, size):
    return _Mean.apply(x, group, size) if size > 1 else x

