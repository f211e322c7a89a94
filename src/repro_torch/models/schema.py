"""Schema-driven parameters: one definition → initialized tensors.

Each module defines a nested dict of ``ParamSpec`` (shape, logical axes,
initializer); ``init_params`` materializes it. Layer stacks keep the JAX
package's leading ``(n_layers, …)`` axis (``stack_schema``), so a parameter
tree has the same structure and shapes in both packages; the port's
eager layer loop indexes that axis (``layer_params``).

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


def tree_map(fn, tree):
    """Apply ``fn`` to every non-dict leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


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


def layer_params(blocks, layer: int):
    """One layer's parameters: views into the stacked tree, or the entry of
    a per-layer list made once by ``unstack_layers`` (no copies either way)."""
    if isinstance(blocks, list):
        return blocks[layer]
    return tree_map(lambda a: a[layer], blocks)


def unstack_layers(params, n_layers: int):
    """``params`` with its layer stack as a list of per-layer views, so an
    eager layer loop does not re-slice every leaf on every step."""
    return {**params, "blocks": [layer_params(params["blocks"], i)
                                 for i in range(n_layers)]}


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

