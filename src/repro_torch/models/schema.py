"""Schema-driven parameters: one definition → initialized tensors.

Each module defines a nested dict of ``ParamSpec`` (shape, logical axes,
initializer); ``init_params`` materializes it, ``abstract_params`` gives
its meta tensors (shapes and dtypes, no memory), and ``logical_specs``
gives the same-structured tree of logical-axis tuples that the sharding
rules engine (``parallel/sharding.py``) maps to mesh axes. Layer stacks
keep the JAX package's leading ``(n_layers, …)`` axis (``stack_schema``),
so a parameter tree has the same structure and shapes in both packages;
the port's eager layer loop indexes that axis (``layer_params``).

The per-leaf distributions are the JAX package's; the numbers are not —
they are drawn from an explicit ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    logical: Tuple[Optional[str], ...]
    init: str = "normal"      # normal | zeros | ones | embed
    std: Optional[float] = None  # default: 1/sqrt(fan_in = shape[-2])

    def __post_init__(self):
        assert len(self.shape) == len(self.logical), (self.shape, self.logical)


Schema = Dict[str, Any]  # nested dict with ParamSpec leaves


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to every non-dict leaf of a nested dict, with the
    matching leaves of the same-structured trees ``rest`` as further
    arguments (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves of a nested dict (keys in sorted order, as JAX flattens
    dicts) or list, depth first."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def stack_schema(schema: Schema, n_layers: int) -> Schema:
    """Prepend an (n_layers,) layer dimension to every leaf."""
    return tree_map(lambda ps: ParamSpec((n_layers,) + ps.shape,
                                         ("layers",) + ps.logical,
                                         ps.init, ps.std), schema)


def logical_specs(schema: Schema):
    """The schema's tree with each ``ParamSpec`` replaced by its logical
    axes."""
    return tree_map(lambda ps: ps.logical, schema)


# layer stacks: the LM's in forward order, then whisper's encoder and decoder
STACKS = ("head_blocks", "blocks", "enc_blocks", "dec_blocks")


def n_stacked(blocks) -> int:
    """Layers in a stack: a per-layer list or a stacked tree."""
    if isinstance(blocks, list):
        return len(blocks)
    return tree_leaves(blocks)[0].shape[0]


def layer_params(blocks, layer: int):
    """One layer's parameters: views into the stacked tree, or the entry of
    a per-layer list made once by ``unstack_layers`` (no copies either way)."""
    if isinstance(blocks, list):
        return blocks[layer]
    return tree_map(lambda a: a[layer], blocks)


def unstack_layers(params):
    """``params`` with each layer stack (``STACKS``) as a list of per-layer
    views, each stack by its own length, so an eager layer loop does not
    re-slice every leaf on every step."""
    return {**params, **{
        name: [layer_params(params[name], i)
               for i in range(n_stacked(params[name]))]
        for name in STACKS if name in params}}


def abstract_params(schema: Schema, dtype: torch.dtype = torch.float32):
    """The schema's tree of tensors on the meta device: each leaf's shape in
    ``dtype``, no memory allocated (the reference's ShapeDtypeStructs)."""
    return tree_map(lambda ps: torch.empty(ps.shape, dtype=dtype,
                                           device="meta"), schema)


def num_params(schema: Schema) -> int:
    """The number of scalars the schema's leaves hold."""
    return sum(math.prod(ps.shape) for ps in tree_leaves(schema))


def _init_leaf(ps: ParamSpec, generator: torch.Generator,
               dtype: torch.dtype) -> torch.Tensor:
    dev = generator.device
    if ps.init == "zeros":
        return torch.zeros(ps.shape, dtype=dtype, device=dev)
    if ps.init == "ones":
        return torch.ones(ps.shape, dtype=dtype, device=dev)
    if ps.init == "embed":
        std = ps.std if ps.std is not None else 1.0
    elif ps.init == "normal":
        if ps.std is not None:
            std = ps.std
        else:
            # fan-in = second-to-last dim (or last for 1-D)
            fan_in = ps.shape[-2] if len(ps.shape) >= 2 else ps.shape[-1]
            std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {ps.init}")
    x = torch.randn(ps.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return (x * std).to(dtype)


def init_params(schema: Schema, generator: torch.Generator,
                dtype: torch.dtype = torch.float32):
    """Initialize a parameter tree from a schema on ``generator.device``,
    drawing the leaves depth first in sorted-key order."""
    if isinstance(schema, dict):
        return {k: init_params(schema[k], generator, dtype)
                for k in sorted(schema)}
    return _init_leaf(schema, generator, dtype)

