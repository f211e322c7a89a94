"""Decoder-only LM (the dense and MoE GQA families): parameters, forward
and loss, and the static engine's prefill and decode step over a
contiguous cache.

``lm_schema`` has the JAX package's tree structure and shapes, with the
layer stack on a leading ``(n_layers, …)`` axis; the serving steps in
``serve/paged_step.py`` loop over that axis eagerly.

The MoE family's FFN is ``models/moe.py::moe_apply`` (its aux loss is
summed over the layers); ``cfg.moe.first_dense`` leading layers keep a
dense FFN in their own stack ``head_blocks``, as in the reference.

``lm_forward`` / ``lm_loss`` are the training entry points. Their layer
stack may be the stacked tree or a per-layer list (``layer_params``): the
trainer passes per-layer autograd leaves, so no layer's gradient is
materialized at the size of the whole stack. ``cfg.remat == "full"``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant): its
activations are recomputed in the backward, as under ``jax.checkpoint``.

``cache_spec`` / ``init_cache`` / ``lm_prefill`` / ``lm_decode_step`` are
the static engine's model steps (``serve/engine.py::ServeEngine``). The
cache is a dict of ``(n_layers, B, Hkv, max_len, Dh)`` stacks plus
``len`` (B,); the steps loop over the layers eagerly and write the cache
**in place** (JAX returns new arrays): ``lm_prefill`` allocates it once
and writes the prompt rows, ``lm_decode_step`` writes one row per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import moe as moe_mod
from repro_torch.models.attention import (attention_apply, attention_decode,
                                         attention_schema, quantize_kv)
from repro_torch.models.layers import (cross_entropy_loss, embed,
                                       embedding_schema, logits, mlp,
                                       mlp_schema, rmsnorm, rmsnorm_schema,
                                       rope_cos_sin)
from repro_torch.models.schema import (layer_params, stack_schema,
                                       tree_leaves, tree_map)

STACKS = ("head_blocks", "blocks")      # layer stacks, in forward order


def _ffn_schema(cfg: ModelConfig, dense: bool = False):
    if cfg.family == "moe" and not dense:
        return moe_mod.moe_schema(cfg)
    d_ff = cfg.moe.d_ff_dense if (dense and cfg.moe.d_ff_dense) else cfg.d_ff
    return mlp_schema(cfg.d_model, d_ff, gated=cfg.activation != "relu2")


def block_schema(cfg: ModelConfig, dense_ffn: bool = False):
    if cfg.family not in ("dense", "moe") or cfg.mla is not None or \
            cfg.ssm is not None:
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense and MoE GQA families "
            "are ported (ROADMAP Queue 1 item 5)")
    return {
        "ln1": rmsnorm_schema(cfg.d_model),
        "mixer": attention_schema(cfg),
        "ln2": rmsnorm_schema(cfg.d_model),
        "ffn": _ffn_schema(cfg, dense=dense_ffn),
    }


def _n_head_blocks(cfg: ModelConfig) -> int:
    return cfg.moe.first_dense if cfg.family == "moe" else 0


def lm_schema(cfg: ModelConfig) -> Dict[str, Any]:
    n_head = _n_head_blocks(cfg)
    s = {
        "embed": embedding_schema(cfg),
        "final_norm": rmsnorm_schema(cfg.d_model),
        "blocks": stack_schema(block_schema(cfg), cfg.n_layers - n_head),
    }
    if n_head:
        s["head_blocks"] = stack_schema(block_schema(cfg, dense_ffn=True),
                                        n_head)
    return s


def _n_stacked(blocks) -> int:
    """Layers in a stack: a per-layer list or a stacked tree."""
    if isinstance(blocks, list):
        return len(blocks)
    return tree_leaves(blocks)[0].shape[0]


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
    if not isinstance(params["blocks"], list):
        return cast_matrix_params(params, dt)
    out = cast_matrix_params({k: v for k, v in params.items()
                              if k not in STACKS}, dt)
    for name in STACKS:
        if name in params:
            out[name] = [tree_map(
                lambda a: a.to(dt) if a.is_floating_point() else a, bp)
                for bp in params[name]]
    return out


def ffn_apply(bp, h2, cfg: ModelConfig, dense_ffn: bool = False):
    """A layer's FFN on its normed input: (B, S, d), or one token per row
    (B, d), which the MoE layer sees as (B, 1, d) as the reference passes
    it. Returns (output, the MoE aux loss, or None for a dense FFN)."""
    if cfg.family != "moe" or dense_ffn:
        return mlp(bp["ffn"], h2, cfg.activation), None
    if h2.dim() == 2:
        y, aux = moe_mod.moe_apply(bp["ffn"], h2[:, None, :], cfg)
        return y[:, 0], aux
    return moe_mod.moe_apply(bp["ffn"], h2, cfg)


def _block_apply(bp, x, cfg: ModelConfig, positions, dense_ffn=False):
    """One layer: pre-norm attention and FFN with residuals. Returns (x,
    the MoE aux loss or None)."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    x = x + attention_apply(bp["mixer"], h, cfg, positions=positions,
                            causal=cfg.causal, window=cfg.window)
    f, aux = ffn_apply(bp, rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg,
                       dense_ffn)
    return x + f, aux


def _scan_blocks(blocks, x, cfg: ModelConfig, positions, dense_ffn=False):
    """The layer loop over one stack, each layer checkpointed under
    ``remat="full"``. Returns (x, the stack's summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(_n_stacked(blocks)):
        bp = layer_params(blocks, layer)
        if cfg.remat == "full":
            x, a = checkpoint(_block_apply, bp, x, cfg, positions,
                              dense_ffn, use_reentrant=False)
        else:
            x, a = _block_apply(bp, x, cfg, positions, dense_ffn)
        if a is not None:
            aux = aux + a
    return x, aux


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V_padded) fp32, aux loss scalar: the
    MoE layers' summed aux, 0 for the dense family)."""
    B, S = tokens.shape
    params = maybe_cast_params(params, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = embed(params["embed"], tokens, cfg)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    if "head_blocks" in params:
        x, a = _scan_blocks(params["head_blocks"], x, cfg, positions,
                            dense_ffn=True)
        aux = aux + a
    x, a = _scan_blocks(params["blocks"], x, cfg, positions)
    aux = aux + a
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(params["embed"], x, cfg), aux


def lm_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            z_loss: float = 1e-4):
    """Next-token cross entropy + z-loss (+ aux). Returns (loss, {"ce",
    "aux"})."""
    lg, aux = lm_forward(params, batch["tokens"], cfg)
    ce = cross_entropy_loss(lg, batch["labels"], z_loss=z_loss,
                            vocab_size=cfg.vocab_size)
    return ce + aux, {"ce": ce, "aux": aux}


# ---------------------------------------------------------------------------
# Decode cache
# ---------------------------------------------------------------------------


def _check_dense_cache(cfg: ModelConfig) -> None:
    """The contiguous cache of the static engine is ported for the dense
    and MoE GQA families; the others come with their model modules
    (ROADMAP Queue 1 item 5). Leading dense blocks (``first_dense``) are
    refused too: the reference's cache for them carries MLA latents
    only."""
    if cfg.family not in ("dense", "moe") or cfg.mla is not None or \
            cfg.ssm is not None:
        raise NotImplementedError(
            f"family {cfg.family!r}: only the dense and MoE GQA families' "
            "decode cache is ported (ROADMAP Queue 1 item 5)")
    if _n_head_blocks(cfg):
        raise NotImplementedError(
            "first_dense head blocks: their decode cache comes with MLA "
            "(ROADMAP Queue 1 item 5)")


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shapes and dtypes of the decode cache, ``{name: (shape, dtype)}``
    with the layer dim first: ``k``/``v`` in the compute dtype, or int8
    with f32 ``k_scale``/``v_scale`` per row under ``opt_int8_kv``; ``len``
    (batch,) int32."""
    _check_dense_cache(cfg)
    sh = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    kv_dt = torch.int8 if cfg.opt_int8_kv else cfg.compute_dtype_
    out = {"k": (sh, kv_dt), "v": (sh, kv_dt)}
    if cfg.opt_int8_kv:
        out["k_scale"] = (sh[:4], torch.float32)
        out["v_scale"] = (sh[:4], torch.float32)
    out["len"] = ((batch,), torch.int32)
    return out


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return {name: torch.zeros(sh, dtype=dt, device=device)
            for name, (sh, dt) in cache_spec(cfg, batch, max_len).items()}


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def _mixer_decode(bp, x1, cfg: ModelConfig, layer_cache, cache_len,
                  rope_cs):
    """One layer's attention on one token; writes ``layer_cache`` (views
    into the stacked cache) in place."""
    y1 = attention_decode(
        bp["mixer"], x1, cfg, cache_k=layer_cache["k"],
        cache_v=layer_cache["v"], cache_len=cache_len, window=cfg.window,
        cache_k_scale=layer_cache.get("k_scale"),
        cache_v_scale=layer_cache.get("v_scale"), rope_cs=rope_cs)[0]
    return y1


def _block_decode(bp, x1, cfg: ModelConfig, layer_cache, cache_len,
                  rope_cs):
    h = rmsnorm(bp["ln1"], x1, cfg.norm_eps)
    x1 = x1 + _mixer_decode(bp, h, cfg, layer_cache, cache_len, rope_cs)
    h2 = rmsnorm(bp["ln2"], x1, cfg.norm_eps)
    return x1 + ffn_apply(bp, h2, cfg)[0]


def lm_decode_step(params, tokens1: torch.Tensor, cache, cfg: ModelConfig):
    """One decode step: (logits (B, V) fp32 for the next token, the cache
    with ``len + 1``). Each layer's new K/V row is written into ``cache``
    in place; the returned dict holds the same tensors and a new ``len``."""
    _check_dense_cache(cfg)
    params = maybe_cast_params(params, cfg)
    cache_len = cache["len"]
    # opt_onehot_embed: the reference multiplies a one-hot matrix by the
    # table, so that a vocab-sharded table is read in place; one-hot @ table
    # returns the table rows exactly, so the gather gives the same numbers
    x1 = params["embed"]["embedding"].to(cfg.compute_dtype_)[tokens1]
    rope_cs = rope_cos_sin(cache_len[:, None, None], cfg.rope_theta,
                           cfg.head_dim_ // 2) if cfg.rope_theta > 0 \
        else None
    names = [n for n in cache if n != "len"]
    for layer in range(cfg.n_layers):
        lc = {n: cache[n][layer] for n in names}
        x1 = _block_decode(layer_params(params["blocks"], layer), x1, cfg,
                           lc, cache_len, rope_cs)
    x1 = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    return logits(params["embed"], x1, cfg), {**cache, "len": cache_len + 1}


# ---------------------------------------------------------------------------
# Prefill (forward + cache construction); assumes full-length prompts
# ---------------------------------------------------------------------------


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
               max_len: int):
    """tokens (B, S) full prompts → (last-token logits (B, V), the cache
    ready for decode). The cache is allocated once at ``max_len`` and each
    layer's prompt K/V rows are written into it (the first ``max_len`` of
    them, as the reference's ``pad_to`` keeps); under ``opt_int8_kv`` the
    rows are quantized and the unwritten rows keep the scale of a zero
    row, as the reference quantizes the zero-padded cache."""
    _check_dense_cache(cfg)
    B, S = tokens.shape
    params = maybe_cast_params(params, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed(params["embed"], tokens, cfg)
    cache = init_cache(cfg, B, max_len, device=tokens.device)
    n = min(S, max_len)
    if cfg.opt_int8_kv:
        _, pad_scale = quantize_kv(torch.zeros((1, 1)))
        cache["k_scale"].fill_(pad_scale.item())
        cache["v_scale"].fill_(pad_scale.item())
    for layer in range(cfg.n_layers):
        bp = layer_params(params["blocks"], layer)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        y, k, v = attention_apply(bp["mixer"], h, cfg, positions=positions,
                                  causal=cfg.causal, window=cfg.window,
                                  return_kv=True)
        for name, t in (("k", k[:, :, :n]), ("v", v[:, :, :n])):
            if cfg.opt_int8_kv:
                t, sc = quantize_kv(t)
                cache[name + "_scale"][layer, :, :, :n] = sc
            cache[name][layer, :, :, :n] = t
        x = x + y
        x = x + ffn_apply(bp, rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg)[0]
    cache["len"].fill_(S)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(params["embed"], x[:, -1], cfg), cache

