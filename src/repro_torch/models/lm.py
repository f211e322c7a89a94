"""Decoder-only LM (dense family): parameters, forward and loss.

``lm_schema`` has the JAX package's tree structure and shapes, with the
layer stack on a leading ``(n_layers, …)`` axis; the serving steps in
``serve/paged_step.py`` loop over that axis eagerly.

``lm_forward`` / ``lm_loss`` are the training entry points. Their layer
stack may be the stacked tree or a per-layer list (``layer_params``): the
trainer passes per-layer autograd leaves, so no layer's gradient is
materialized at the size of the whole stack. ``cfg.remat == "full"``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant): its
activations are recomputed in the backward, as under ``jax.checkpoint``.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attention_apply, attention_schema
from repro_torch.models.layers import (cross_entropy_loss, embed,
                                       embedding_schema, logits, mlp,
                                       mlp_schema, rmsnorm, rmsnorm_schema)
from repro_torch.models.schema import layer_params, stack_schema, tree_map


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


def maybe_cast_params(params, cfg: ModelConfig):
    """``opt_bf16_params``: matrix params cast to the compute dtype once,
    before the layer loop (the optimizer keeps the f32 master copy). The
    rule follows the JAX leaf's rank: every leaf of a per-layer list stands
    for a stacked ``(n_layers, …)`` leaf of rank ≥ 2, so block norm scales
    are cast too, exactly as in the reference."""
    if not cfg.opt_bf16_params:
        return params
    dt = cfg.compute_dtype_
    blocks = params["blocks"]
    if not isinstance(blocks, list):
        return cast_matrix_params(params, dt)
    out = cast_matrix_params({k: v for k, v in params.items()
                              if k != "blocks"}, dt)
    out["blocks"] = [tree_map(
        lambda a: a.to(dt) if a.is_floating_point() else a, bp)
        for bp in blocks]
    return out


def _block_apply(bp, x, cfg: ModelConfig, positions):
    """One dense layer: pre-norm attention and MLP with residuals."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + attention_apply(bp["mixer"], h, cfg, positions=positions,
                            causal=cfg.causal, window=cfg.window)
    h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    return x + mlp(bp["ffn"], h2, cfg.activation)


def _scan_blocks(blocks, x, cfg: ModelConfig, positions):
    """The layer loop; each layer checkpointed under ``remat="full"``."""
    for layer in range(cfg.n_layers):
        bp = layer_params(blocks, layer)
        if cfg.remat == "full":
            x = checkpoint(_block_apply, bp, x, cfg, positions,
                           use_reentrant=False)
        else:
            x = _block_apply(bp, x, cfg, positions)
    return x


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V_padded) fp32, aux loss scalar; 0
    for the dense family)."""
    B, S = tokens.shape
    params = maybe_cast_params(params, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = embed(params["embed"], tokens, cfg)
    x = _scan_blocks(params["blocks"], x, cfg, positions)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    return logits(params["embed"], x, cfg), aux


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            z_loss: float = 1e-4):
    """Next-token cross entropy + z-loss (+ aux). Returns (loss, {"ce",
    "aux"})."""
    lg, aux = lm_forward(params, batch["tokens"], cfg)
    ce = cross_entropy_loss(lg, batch["labels"], z_loss=z_loss,
                            vocab_size=cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}
