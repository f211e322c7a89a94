"""Logical-axis sharding rules engine (the JAX package's
``repro.parallel.sharding``) and the implicit placement on DTensor.

Every parameter and major activation carries *logical* axis names
("batch", "heads", "mlp", ...). A ``ShardingRules`` table maps logical axes
to mesh axes; ``logical_to_physical`` builds a partition spec, degrading
gracefully when a dimension is not divisible by the assigned mesh axes (8
KV heads on a 16-way model axis replicate) or when a mesh axis is already
used by an earlier dimension.

A spec is a tuple shaped like JAX's ``PartitionSpec``: per dimension
``None``, a mesh axis name, or a tuple of names. A mesh is a
``DeviceMesh`` or a plain ``{axis: size}`` mapping
(``launch.mesh.mesh_shape``).

``sharding_context`` sets the ambient mesh and rules, as the launchers do;
without it model code runs on one rank unchanged.

Placement is what GSPMD derives from these specs under ``pjit``, here on
``torch.distributed.tensor``: ``NamedSharding(mesh, spec).placements`` is
the per-mesh-dim ``Shard``/``Replicate`` list, ``param_sharding`` gives a
parameter's ``NamedSharding``, ``place`` distributes a parameter tree by
its logical specs (``launch/train.py``), and ``shard_act`` redistributes a
DTensor activation to its spec. A placement never changes a value, and a
plain tensor is never touched: ``shard_act`` returns it (the same object),
so the serving path, which keeps plain parameters as the reference's
does, runs op for op as without a mesh.

Mixed inputs. A placed step meets plain tensors: its integer batch, and
the constants the model builds (positions, masks, RoPE tables, the
padded-vocab mask, scalars). The rule: the trainer distributes the batch
by the rules' ``("batch", "seq")`` spec (``batch_sharding``), so the data
axis really splits it, and runs the forward and backward under
``placed_scope``, DTensor's ``implicit_replication``: every other plain
tensor that meets a DTensor there is taken as replicated. What DTensor's
rules cannot shard on every supported torch runs as GSPMD runs a custom
call (``kernels/dtensor.py``'s ``run_local``): on local shards, after a
redistribution that leaves whole every dimension it reduces or indexes.
"""
from __future__ import annotations

import dataclasses
import math
from contextlib import contextmanager
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.schema import tree_map

MeshAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[MeshAxes, ...]


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """logical axis name -> mesh axis (or tuple of axes, or None=replicate)."""

    rules: Dict[str, MeshAxes]

    def get(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        axes = self.rules.get(logical, None)
        if axes is None:
            return ()
        if isinstance(axes, str):
            return (axes,)
        return tuple(axes)


# Default rules for the production meshes. "pod" appears only in multi-pod
# meshes; logical_to_physical drops mesh axes absent from the mesh.
DEFAULT_RULES = ShardingRules({
    # activations
    "batch": ("pod", "data"),
    "seq": None,                  # sequence-parallel mode overrides to "data"
    "kv_seq": "model",            # decode-cache seq (opt_cache_seq_shard)
    "act_embed": None,
    "act_heads": "model",
    "act_mlp": "model",
    "act_experts": "model",
    # params — TP over "model", FSDP over "data"
    "vocab": "model",
    "embed": "data",              # FSDP shard of the d_model param dim
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "mlp": "model",
    "experts": "model",           # expert parallelism
    "expert_mlp": None,
    "q_lora": None,
    "kv_lora": None,
    "state": None,
    "conv": None,
    "layers": None,               # layer stacks are never sharded
})

# Sequence-parallel override for batch=1 long-context cells: the data axis
# shards the KV-cache/sequence dimension instead of batch.
LONG_CONTEXT_RULES = ShardingRules({
    **DEFAULT_RULES.rules,
    "batch": None,
    "seq": ("pod", "data"),
    "kv_seq": ("pod", "data", "model"),  # batch=1: shard cache everywhere
})

# Decode-time rules (opt_serve_resident): parameters are not FSDP-sharded
# over "data" (each decode step would re-gather every weight); they stay
# TP-sharded over "model" and replicated across "data".
SERVE_RULES = ShardingRules({
    **DEFAULT_RULES.rules,
    "embed": None,
})

# opt_seq_parallel: activations carry sequence shards over the model axis
# instead of head/mlp shards; ring attention engages under these rules.
SEQ_PARALLEL_RULES = ShardingRules({
    **DEFAULT_RULES.rules,
    "seq": "model",
    "act_heads": None,   # heads stay whole; seq carries the model axis
    "act_mlp": None,
})


def logical_to_physical(
    logical: Sequence[Optional[str]],
    shape: Sequence[int],
    rules: ShardingRules,
    mesh,
) -> Spec:
    """The partition spec of ``shape`` from its logical axis names.

    Divisibility-aware: a mesh axis is applied to a dimension only when the
    dim size is divisible by it (progressively: of a tuple assignment like
    ("pod", "data"), the axes that keep dividing are kept). Each mesh axis
    is used at most once across the spec."""
    if len(logical) != len(shape):
        raise ValueError(f"logical axes {logical} do not match shape "
                         f"{tuple(shape)}")
    sizes = mesh_shape(mesh)
    used: set = set()
    spec = []
    for name, dim in zip(logical, shape):
        axes = [a for a in rules.get(name) if a in sizes and a not in used]
        kept = []
        prod = 1
        for a in axes:
            if dim % (prod * sizes[a]) == 0:
                kept.append(a)
                prod *= sizes[a]
        used.update(kept)
        spec.append(tuple(kept) if len(kept) > 1 else
                    (kept[0] if kept else None))
    return tuple(spec)


# ---------------------------------------------------------------------------
# Ambient sharding context: set by the launchers, absent in plain unit tests
# so model code runs unmodified on one rank.
# ---------------------------------------------------------------------------


class _Context:
    mesh = None
    rules: ShardingRules = DEFAULT_RULES


_ctx = _Context()


@contextmanager
def sharding_context(mesh, rules: ShardingRules = DEFAULT_RULES):
    old_mesh, old_rules = _ctx.mesh, _ctx.rules
    _ctx.mesh, _ctx.rules = mesh, rules
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = old_mesh, old_rules


def current_mesh():
    return _ctx.mesh


def current_rules() -> ShardingRules:
    return _ctx.rules


def _axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``).

    ``placements`` is the per-mesh-dim list ``distribute_tensor`` and
    ``redistribute`` take: ``Shard(d)`` on every mesh dim that tensor dim
    ``d``'s entry names, ``Replicate()`` on the others. A tuple entry such
    as ``("pod", "data")`` shards one dim over several mesh dims, the
    first one outermost, which is DTensor's order only where the tuple
    follows the mesh's order; every tuple of the four rule tables does, and
    any other is refused."""

    mesh: Any
    spec: Spec

    @property
    def placements(self) -> Tuple[Any, ...]:
        names = list(mesh_shape(self.mesh))
        out: list = [Replicate()] * len(names)
        for dim, entry in enumerate(self.spec):
            axes = _axes(entry)
            idx = [names.index(a) for a in axes]
            if idx != sorted(idx):
                raise ValueError(
                    f"spec entry {entry} of dim {dim} is not in the mesh's "
                    f"axis order {tuple(names)}")
            for i in idx:
                out[i] = Shard(dim)
        return tuple(out)


def shard_act(x, logical: Sequence[Optional[str]]):
    """A DTensor activation redistributed to ``logical_to_physical``'s spec
    under the ambient mesh and rules (the reference's sharding
    constraint); a plain tensor, or any input without a mesh, is returned
    as it is."""
    mesh = _ctx.mesh
    if mesh is None or not isinstance(x, DTensor):
        return x
    spec = logical_to_physical(logical, x.shape, _ctx.rules, mesh)
    return x.redistribute(x.device_mesh, NamedSharding(mesh, spec).placements)


def param_sharding(logical: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Optional[NamedSharding]:
    """The ``NamedSharding`` of a parameter under the ambient mesh and
    rules (None without a mesh)."""
    mesh = _ctx.mesh
    if mesh is None:
        return None
    return NamedSharding(mesh, logical_to_physical(logical, shape,
                                                   _ctx.rules, mesh))


def sharding_of(x) -> Optional[NamedSharding]:
    """The ``NamedSharding`` a DTensor is placed by (None for a plain
    tensor)."""
    if not isinstance(x, DTensor):
        return None
    mesh = x.device_mesh
    spec: list = [()] * x.ndim
    for name, p in zip(mesh.mesh_dim_names, x.placements):
        if p.is_shard():
            spec[p.dim] = spec[p.dim] + (name,)
        elif not p.is_replicate():
            raise ValueError(f"{p} on mesh dim '{name}' is no placement "
                             "of a spec")
    return NamedSharding(mesh, tuple(
        None if not a else a[0] if len(a) == 1 else a for a in spec))


def batch_sharding(shape: Sequence[int]) -> Optional[NamedSharding]:
    """A batch array's sharding: ``("batch", "seq")`` on its first two
    dims, the rest whole (None without a mesh)."""
    logical = ("batch", "seq", *(None,) * (len(shape) - 2))[:len(shape)]
    return param_sharding(logical, shape)


def distribute(x: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``x`` (the whole array, the same on every rank) placed by
    ``sharding``, whose sharded dims must split evenly (those of
    ``logical_to_physical`` always do: it keeps only mesh axes that
    divide a dim)."""
    sizes = mesh_shape(sharding.mesh)
    for dim, entry in enumerate(sharding.spec):
        if x.shape[dim] % math.prod(sizes[a] for a in _axes(entry)):
            raise ValueError(f"spec {sharding.spec} splits shape "
                             f"{tuple(x.shape)} unevenly")
    return distribute_tensor(x, sharding.mesh, sharding.placements)


def placed_zeros(shape: Sequence[int], dtype: torch.dtype,
                 logical: Sequence[Optional[str]], device=None) -> DTensor:
    """Zeros of ``shape`` placed by their logical axes under the ambient
    mesh and rules, made from each rank's local shard (the whole array
    never exists)."""
    sharding = param_sharding(logical, shape)
    mesh, local = sharding.mesh, list(shape)
    for i, p in enumerate(sharding.placements):
        if p.is_shard():
            local[p.dim] //= mesh.size(i)
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh,
        sharding.placements, run_check=False, shape=torch.Size(shape),
        stride=torch.empty(shape, device="meta").stride())


def place(tree, specs):
    """A parameter tree distributed by its same-structured tree of logical
    specs under the ambient mesh and rules (the tree unchanged without a
    mesh)."""
    if _ctx.mesh is None:
        return tree
    return tree_map(lambda a, logical: distribute(
        a, param_sharding(logical, a.shape)), tree, specs)


def placed_scope():
    """The scope a placed step runs in: plain tensors meeting DTensors are
    taken as replicated (``implicit_replication``)."""
    return implicit_replication()
