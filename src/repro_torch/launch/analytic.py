"""First-principles FLOP counts per (arch × shape) cell.

The counterpart of the JAX package's ``launch/analytic.py``, formula for
formula and in the same order of operations, so every count is the
reference's to the last bit. The reference keeps them because a compiler's
cost analysis miscounts nested loops; the port keeps them as the compute
term of the roofline (``launch/roofline.py``) and as the numerator of a
step's share of the card's peak.

Conventions: 1 MAC = 2 FLOPs; backward = 2× forward (train = 3× fwd);
causal attention halves the score/AV work; remat recompute is NOT counted
(the roofline counts useful work).
"""
from __future__ import annotations

import math

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _attn_flops_per_layer(cfg: ModelConfig, B: int, Sq: int, Sk: int,
                          causal: bool) -> float:
    """Score (QK^T) + weighted sum (AV) FLOPs for one layer, forward."""
    if cfg.family == "rwkv":
        return 0.0
    if cfg.mla is not None:
        a = cfg.mla
        if cfg.opt_mla_absorbed and Sq > 1:
            # latent-space attention: scores over kv_lora+rope, AV over
            # kv_lora (cheaper wire/memory, more score FLOPs)
            dqk, dv = a.kv_lora + a.qk_rope, a.kv_lora
        else:
            dqk, dv = a.qk_nope + a.qk_rope, a.v_head
        pairs = B * cfg.n_heads * Sq * Sk * (0.5 if causal and Sq == Sk else 1)
        return 2 * pairs * (dqk + dv)
    H, dh = cfg.n_heads, cfg.head_dim_
    eff_k = min(Sk, cfg.window) if cfg.window else Sk
    if causal and Sq == Sk:
        pairs = B * H * Sq * eff_k * (0.5 if not cfg.window else 1.0)
        if cfg.window and Sq > cfg.window:
            pairs = B * H * Sq * cfg.window  # banded
        elif cfg.window:
            pairs = B * H * Sq * eff_k * 0.5
    else:
        pairs = B * H * Sq * eff_k
    return 2 * pairs * 2 * dh


def _recurrence_flops_per_layer(cfg: ModelConfig, B: int, S: int) -> float:
    """State-update FLOPs (RWKV wkv / Mamba SSM scan), forward."""
    if cfg.family == "rwkv":
        n = cfg.ssm.head_size
        H = cfg.d_model // n
        return 5.0 * B * S * H * n * n
    if cfg.family == "hybrid":
        di = cfg.ssm.d_inner or 2 * cfg.d_model
        return 6.0 * B * S * di * cfg.ssm.state
    return 0.0


def _leaves_with_path(tree, prefix=()):
    """(path, leaf) of every leaf of a nested dict, keys as strings."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def matmul_param_count(cfg: ModelConfig) -> int:
    """Parameters that multiply every token (active experts for MoE;
    embedding lookup excluded; logits matmul included once)."""
    from repro_torch.models.registry import model_fns

    total = 0
    for path, ps in _leaves_with_path(model_fns(cfg).schema):
        name = "/".join(path)
        if len(ps.shape) < 2:
            continue
        if "embedding" in name or "dec_pos" in name:
            continue
        total += math.prod(ps.shape)
    # logits projection: tied embeddings reuse the table as a matmul
    if cfg.tie_embeddings:
        total += cfg.padded_vocab * cfg.d_model
    if cfg.moe.n_experts:
        m = cfg.moe
        L = cfg.n_layers - m.first_dense
        per_expert = 3 * cfg.d_model * m.d_expert
        total -= L * m.n_experts * per_expert
        total += L * m.top_k * per_expert
    return total


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Total useful FLOPs (global, per step) for this cell."""
    B, S = shape.global_batch, shape.seq_len
    n_mm = matmul_param_count(cfg)
    mult = 3.0 if shape.kind == "train" else 1.0

    if shape.kind == "decode":
        tokens = B
        mm = 2.0 * n_mm * tokens
        if cfg.family == "encdec":
            attn = cfg.n_layers * (
                _attn_flops_per_layer(cfg, B, 1, S, False) +
                _attn_flops_per_layer(cfg, B, 1, cfg.enc_positions, False))
        else:
            attn = cfg.n_layers * _attn_flops_per_layer(cfg, B, 1, S, False)
        rec = cfg.n_layers * _recurrence_flops_per_layer(cfg, B, 1)
        return mm + attn + rec

    tokens = B * S
    mm = 2.0 * n_mm * tokens
    if cfg.family == "encdec":
        F = cfg.enc_positions
        attn = (cfg.n_enc_layers * _attn_flops_per_layer(cfg, B, F, F, False)
                + cfg.n_layers * (_attn_flops_per_layer(cfg, B, S, S, True)
                                  + _attn_flops_per_layer(cfg, B, S, F,
                                                          False)))
        # the encoder's matmuls run F tokens, the decoder's S; the count
        # charges all of them at S tokens, as the reference's does (it
        # computes ``mm`` a second time here, to the same value)
    else:
        attn = cfg.n_layers * _attn_flops_per_layer(cfg, B, S, S, cfg.causal)
    rec = cfg.n_layers * _recurrence_flops_per_layer(cfg, B, S)
    return (mm + attn + rec) * mult
