"""Logical-axis sharding rules engine (the JAX package's
``repro.parallel.sharding``).

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
without it model code runs on one rank unchanged. The explicit
collectives of ``parallel/`` (``ring_attention``, ``pipeline_apply``,
``models.moe.moe_apply_shard_map``, ``train.step.make_ddp_train_step``)
read the ambient mesh or take one. The *implicit* placement that GSPMD
derives from these specs under ``pjit`` is not here: ``shard_act`` and
``param_sharding`` compute no placement on tensors yet (ROADMAP.md Queue 1
item 6b puts them on DTensors).
"""
from __future__ import annotations

import dataclasses
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple, Union

from repro_torch.launch.mesh import mesh_shape

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


def shard_act(x, logical: Sequence[Optional[str]]):
    """The activation unchanged: in the reference a sharding constraint,
    which never changes values. Placing it (``redistribute`` of a DTensor
    to ``logical_to_physical``'s spec) is ROADMAP.md Queue 1 item 6b."""
    return x


def param_sharding(logical: Sequence[Optional[str]],
                   shape: Sequence[int]) -> Optional[Spec]:
    """The partition spec of a parameter under the ambient mesh and rules
    (None without a mesh). The reference returns a ``NamedSharding``;
    placing parameters by it (``distribute_tensor``) is ROADMAP.md Queue 1
    item 6b."""
    mesh = _ctx.mesh
    if mesh is None:
        return None
    return logical_to_physical(logical, shape, _ctx.rules, mesh)
