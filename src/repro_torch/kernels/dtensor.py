"""Kernels, and the model's other custom calls, on DTensors.

A kernel takes plain tensors (``build.ptr`` refuses a DTensor by name), so
a wrapper given DTensors runs its kernel — or, on the CPU, its plain
version, the same code path — on each rank's ``to_local()`` shard and
wraps the result with ``DTensor.from_local``. The model does the same
with what DTensor's sharding rules cannot take on every supported torch:
the attention cores, the scans' recurrences, the embedding gather, the
loss's per-token terms and the MoE router's ranks.

That is right only where no shard cuts a dimension the call reduces over
or indexes (the keys' sequence and ``head_dim`` of attention, a row of a
Softermax, a scan's time axis), and where the operands' shards line up (a
query head's KV head lies in the same shard). So each operand names its
dims (``axes``: a name per dim, None for one that must stay whole) and
the call names those that may stay sharded (``keep``). Per mesh dim, the
first operand's shard is kept where its dim's name is in ``keep`` and
every operand with that name splits it evenly; every operand then takes
``Shard`` on its own dim of that name, or ``Replicate`` where it has
none, and every other mesh dim is replicated, a pending partial sum
reduced — what GSPMD does around a custom call. Autograd runs through
``redistribute``, ``to_local`` and ``from_local``, so the backward takes
the same shards and the gradients return to the operands' placements;
an operand replicated across shards of another's dim gets the sum of
their gradients.

The other helpers serve placed operands where DTensor's own rules fall
short, each a no-op on plain tensors: views across uneven or strided
shards (``split_evenly``, ``merged``, ``rows_matmul``), the vocab-parallel
reductions (``all_reduce_local``, ``sharded_by``, ``shard_offset``) and
in-place cache writes (``store``).
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.observe import note_redistribution

Axes = Tuple[Optional[str], ...]


HEADS: Axes = ("batch", "heads", None, None)   # (B, H, S, D) attention


def dims(x, whole: int = 1) -> Axes:
    """Axes of a tensor whose last ``whole`` dims stay whole and whose
    other dims may each stay sharded."""
    return tuple(f"d{i}" for i in range(x.dim() - whole)) + (None,) * whole


def split_evenly(x, dim: int, parts: int):
    """A DTensor ``x`` whose ``dim`` is about to be split into ``parts``
    leading blocks (an ``unflatten``): each mesh dim that shards ``dim`` is
    kept while the shard count divides ``parts``, else replicated (DTensor
    refuses to unflatten an uneven shard; GSPMD pads it). A plain tensor is
    returned as it is."""
    if not is_dtensor(x):
        return x
    mesh, dim = x.device_mesh, dim % x.ndim
    pl, n = list(x.placements), 1
    for i, p in enumerate(pl):
        if p.is_shard(dim):
            if parts % (n * mesh.size(i)):
                pl[i] = Replicate()
            else:
                n *= mesh.size(i)
    return x if pl == list(x.placements) else x.redistribute(mesh, pl)


class _GradAs(torch.autograd.Function):
    """Identity whose gradient is redistributed to the input's placements
    (replicated where the input is a pending partial sum: each partial's
    gradient is the whole's)."""

    @staticmethod
    def forward(ctx, x):
        ctx.spec = (x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements))
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(*ctx.spec)


def merged(w, shape, parts: int):
    """``w.reshape(shape)``, merging a dim of ``parts`` blocks with the next.
    On a DTensor whose mesh has a dim that does not divide ``parts``, the
    merged tensor's gradient is returned in its forward placements: DTensor
    may shard it along the merged dim, which it then cannot split back."""
    out = w.reshape(shape)
    if is_dtensor(w) and any(parts % n for n in w.device_mesh.shape):
        out = _GradAs.apply(out)
    return out


class _AllReduce(torch.autograd.Function):
    """A local tensor reduced in place of a copy over ``groups``; its
    gradient passes as it is: each rank's downstream computation on the
    reduced value is the same, so each operand's gradient is the reduced
    value's (the gradient of a max is not taken: callers detach it)."""

    @staticmethod
    def forward(ctx, x, groups, op):
        y = x.clone()
        for g in groups:
            dist.all_reduce(y, op=op, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def all_reduce_local(x: torch.Tensor, groups, op=dist.ReduceOp.SUM):
    """``x`` reduced over each of ``groups`` (a no-op for none)."""
    return _AllReduce.apply(x, tuple(groups), op) if groups else x


def sharded_by(x, dim: int) -> Tuple[int, ...]:
    """The mesh dims (size > 1) that shard a DTensor's ``dim``, outermost
    first."""
    mesh = x.device_mesh
    return tuple(i for i, p in enumerate(x.placements)
                 if p.is_shard(dim) and mesh.size(i) > 1)


def shard_offset(mesh, mesh_dims: Sequence[int], length: int) -> int:
    """This rank's first index along a dim of local ``length`` sharded
    over ``mesh_dims`` (the first one outermost, as DTensor shards)."""
    coord, idx = mesh.get_coordinate(), 0
    for i in mesh_dims:
        idx = idx * mesh.size(i) + coord[i]
    return idx * length


def store(dst, src, n: Optional[int] = None, dim: int = 2) -> None:
    """``dst[..., :n, ...] = src`` along ``dim`` (all of ``dst`` without
    ``n``), in place. A placed ``dst`` is written whole on its local
    shard, ``src`` first redistributed to its placements (a cache write as
    a custom call)."""
    if not is_dtensor(dst):
        if n is None:
            dst.copy_(src)
        else:
            dst.narrow(dim, 0, n).copy_(src)
        return
    if tuple(src.shape) != tuple(dst.shape):
        raise ValueError(f"a placed store writes the whole of "
                         f"{tuple(dst.shape)}, not {tuple(src.shape)}")
    mesh = dst.device_mesh
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False)
    dst.to_local().copy_(src.redistribute(mesh, dst.placements).to_local())


def rows_matmul(x, w):
    """``x @ w`` for a 2-D weight ``w``. A DTensor ``x`` of rank > 2 that
    is sharded along a middle dim (the sequence under the
    sequence-parallel rules), or along a dim of size 1, multiplies its
    local rows by the whole weight, as a custom call: DTensor cannot shard
    a product whose rows flatten two sharded dims, and some versions
    refuse to flatten away a sharded dim of size 1. Otherwise the
    product's gradient comes back in its forward placements, for the same
    reason (DTensor may shard a middle dim of the gradient)."""
    if not is_dtensor(x) or x.dim() <= 2:
        return x @ w
    if not any(p.is_shard() and p.dim < x.dim() - 1 and
               (p.dim > 0 or x.shape[0] == 1) for p in x.placements):
        return _GradAs.apply(x @ w)
    ax = dims(x)
    return run_local(lambda a, b: a @ b, (x, w), (ax, (None, None)),
                     keep=ax)


def _plan(ts: Sequence[DTensor], axes: Sequence[Axes],
         keep: Sequence[str]) -> Tuple[Optional[str], ...]:
    """Per mesh dim, the name whose shard every operand keeps there (None:
    replicated)."""
    mesh = ts[0].device_mesh
    out = [axes[0][p.dim] if p.is_shard() and axes[0][p.dim] in keep
           else None for p in ts[0].placements]
    for name in set(out) - {None}:
        n = math.prod(mesh.size(i) for i, a in enumerate(out) if a == name)
        if any(t.shape[ax.index(name)] % n for t, ax in zip(ts, axes)
               if name in ax):
            out = [None if a == name else a for a in out]
    return tuple(out)


def _placements(names: Sequence[Optional[str]], ax: Axes,
               grad: bool = False) -> tuple:
    """An operand's placements under ``names``; ``grad``: its gradient's,
    a partial sum over every mesh dim that shards a name it has not (each
    shard's call read all of it)."""
    return tuple(Shard(ax.index(a)) if a is not None and a in ax
                 else Partial() if a is not None and grad
                 else Replicate() for a in names)


def run_local(fn: Callable, ts: Sequence, axes: Sequence[Axes],
              keep: Sequence[str] = (),
              out_axes: Optional[Sequence[Axes]] = None):
    """``fn`` on the operands' local shards (plain operands among DTensors
    count as replicated); on plain operands alone, ``fn(*ts)`` itself.
    ``out_axes`` names each output's dims (default: the first operand's);
    an output has every name kept, and a kept dim's global size is its
    local size times the shard count."""
    first = next((t for t in ts if is_dtensor(t)), None)
    if first is None:
        return fn(*ts)
    mesh = first.device_mesh
    ts = [t if isinstance(t, DTensor) else DTensor.from_local(
        t, mesh, [Replicate()] * mesh.ndim, run_check=False) for t in ts]
    names = _plan(ts, axes, keep)
    moved = [t.redistribute(mesh, _placements(names, ax))
             for t, ax in zip(ts, axes)]
    for before, after in zip(ts, moved):
        if after.placements != before.placements:
            note_redistribution(fn.__qualname__, before, after)
    ts = moved
    out = fn(*(t.to_local(grad_placements=_placements(names, ax, grad=True))
               for t, ax in zip(ts, axes)))
    outs = out if isinstance(out, tuple) else (out,)
    out_axes = out_axes or (axes[0],) * len(outs)

    def wrap(o, ax):
        pl = _placements(names, ax)
        assert all(a is None or a in ax for a in names), (names, ax)
        shape = list(o.shape)
        for i, p in enumerate(pl):
            if p.is_shard():
                shape[p.dim] *= mesh.size(i)
        return DTensor.from_local(o, mesh, pl, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=torch.empty(shape,
                                                     device="meta").stride())

    wrapped = tuple(wrap(o, ax) for o, ax in zip(outs, out_axes))
    return wrapped if isinstance(out, tuple) else wrapped[0]
