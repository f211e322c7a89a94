"""Decoder-only LM parameters (dense family).

``lm_schema`` has the JAX package's tree structure and shapes, with the
layer stack on a leading ``(n_layers, …)`` axis; the serving steps in
``serve/paged_step.py`` loop over that axis eagerly.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_schema
from repro_torch.models.layers import (embedding_schema, mlp_schema,
                                       rmsnorm_schema)
from repro_torch.models.schema import stack_schema, tree_map


def block_schema(cfg: ModelConfig):
    if cfg.family != "dense" or cfg.mla is not None or cfg.ssm is not None:
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense GQA family is ported")
    return {
        "ln1": rmsnorm_schema(cfg.d_model),
        "mixer": attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model),
        "ffn": mlp_schema(cfg.d_model, cfg.d_ff,
                          gated=cfg.activation != "relu2"),
    }


def lm_schema(cfg: ModelConfig) -> Dict[str, Any]:
    return {
        "embed": embedding_schema(cfg),
        "final_norm": rmsnorm_schema(cfg.d_model),
        "blocks": stack_schema(block_schema(cfg), cfg.n_layers),
    }


def cast_matrix_params(params, dtype: torch.dtype):
    """Cast every ≥2-D floating tensor to ``dtype``; 1-D params (norm
    scales) stay as they are — the JAX package's ``maybe_cast_params``
    rule. Casting once at load gives the numbers the per-use casts give."""
    return tree_map(
        lambda a: a.to(dtype) if a.ndim >= 2 and a.is_floating_point()
        else a, params)
