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
"""
from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.kernels.build import is_dtensor

Axes = Tuple[Optional[str], ...]


HEADS: Axes = ("batch", "heads", None, None)   # (B, H, S, D) attention


def dims(x, whole: int = 1) -> Axes:
    """Axes of a tensor whose last ``whole`` dims stay whole and whose
    other dims may each stay sharded."""
    return tuple(f"d{i}" for i in range(x.dim() - whole)) + (None,) * whole


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
    ts = [t.redistribute(mesh, _placements(names, ax))
          for t, ax in zip(ts, axes)]
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
