"""Tree utilities over the port's nested-dict parameter trees (the JAX
package's ``repro.utils.tree``); leaves are tensors, walked by
``models.schema.tree_leaves`` / ``tree_map``."""
from __future__ import annotations

import math

import torch

from repro_torch.models.schema import tree_leaves, tree_map


def tree_num_params(tree) -> int:
    """Total number of scalar parameters in a tree."""
    return int(sum(math.prod(l.shape) if hasattr(l, "shape") else 1
                   for l in tree_leaves(tree)))


def tree_size_bytes(tree) -> int:
    """Total bytes of the tree's tensors."""
    return int(sum(l.numel() * l.element_size() for l in tree_leaves(tree)
                   if isinstance(l, torch.Tensor)))


def tree_cast(tree, dtype: torch.dtype):
    """Cast every floating-point leaf to ``dtype``; other leaves as they
    are."""
    return tree_map(lambda x: x.to(dtype) if isinstance(x, torch.Tensor)
                    and x.is_floating_point() else x, tree)


def tree_zeros_like(tree):
    return tree_map(torch.zeros_like, tree)


def tree_allfinite(tree) -> torch.Tensor:
    """Scalar bool tensor: every floating-point leaf is finite."""
    leaves = [torch.isfinite(l).all() for l in tree_leaves(tree)
              if isinstance(l, torch.Tensor) and l.is_floating_point()]
    if not leaves:
        return torch.tensor(True)
    return torch.stack(leaves).all()
