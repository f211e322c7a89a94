"""Parameters from numpy: the JAX package's parameter tree, already turned
into numpy arrays by the caller (``jax.tree.map(np.asarray, params)``),
becomes the port's parameter tree. The two trees have the same structure
and shapes (layer stacks keep their leading ``(n_layers, …)`` axis), so the
bridge only moves data; bf16 crosses through its uint16 bit pattern."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.registry import model_fns
from repro_torch.models.schema import tree_map


def tensor_from_numpy(a: np.ndarray, device) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(np.ascontiguousarray(a).view(np.uint16)
                                .astype(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, cfg: ModelConfig, device="cpu"):
    """Convert a numpy parameter tree, checking it against the family's
    schema (``model_fns(cfg).schema``: ``lm_schema``, or ``whisper_schema``
    at the registry's decoder positions)."""
    schema = model_fns(cfg).schema

    def check(ps, a):
        if tuple(a.shape) != tuple(ps.shape):
            raise ValueError(f"shape {a.shape} != schema {ps.shape}")

    def walk(s, t):
        if isinstance(s, dict):
            if set(s) != set(t):
                raise ValueError(f"keys {sorted(t)} != schema {sorted(s)}")
            for k in s:
                walk(s[k], t[k])
        else:
            check(s, t)

    walk(schema, tree)
    return tree_map(lambda a: tensor_from_numpy(a, device), tree)
