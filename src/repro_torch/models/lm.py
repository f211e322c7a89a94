"""Decoder-only LM, generic over the decoder-only families: parameters,
forward and loss, and the static engine's prefill and decode step.

One definition serves the dense and MoE GQA families, MoE with MLA
(deepseek-v2), RWKV6 and the hybrid attention+Mamba family (hymba); the
per-layer mixer and FFN are chosen by ``cfg`` as in the JAX package
(``models/mla.py``, ``models/rwkv6.py``, ``models/hymba.py``). The
encoder-decoder family (whisper) has its own model, ``models/whisper.py``;
the functions here refuse it.

``lm_schema`` has the JAX package's tree structure and shapes, with each
layer stack on a leading ``(n_layers, …)`` axis; the MoE family's
``cfg.moe.first_dense`` leading layers keep a dense FFN in their own stack
``head_blocks``, walked before ``blocks``. The serving steps in
``serve/paged_step.py`` loop over the stacks eagerly.

``lm_forward`` / ``lm_loss`` are the training entry points. Their layer
stacks may be stacked trees or per-layer lists (``layer_params``): the
trainer passes per-layer autograd leaves, so no layer's gradient is
materialized at the size of the whole stack. ``cfg.remat == "full"``
checkpoints each layer (``torch.utils.checkpoint``, non-reentrant): its
activations are recomputed in the backward, as under ``jax.checkpoint``.

``cache_spec`` / ``init_cache`` / ``lm_prefill`` / ``lm_decode_step`` are
the static engine's model steps (``serve/engine.py::ServeEngine``). The
cache is a dict of stacks with the layer dim first, plus ``len`` (B,):

* attention: ``k``/``v`` (L, B, Hkv, max_len, Dh), int8 with f32
  ``k_scale``/``v_scale`` under ``opt_int8_kv``;
* MLA: ``ckv`` (L, B, max_len, kv_lora), ``krope`` (L, B, max_len,
  qk_rope), and ``head_ckv``/``head_krope`` for the head blocks;
* rwkv: ``shift_t``, ``shift_c`` (L, B, d), ``wkv`` (L, B, H, n, n) fp32;
* hybrid: ``k``/``v`` over a ring of W = min(window, max_len) slots, ``ssm``
  (L, B, di, st) fp32, ``conv`` (L, B, cw-1, di).

Only the GQA attention entries are ever int8. The steps loop over the
layers eagerly and write the cache **in place** (JAX returns new arrays):
``lm_prefill`` allocates it once and writes the prompt's entries (the
first ``max_len`` rows of a linear cache, as the reference's padding keeps
them), ``lm_decode_step`` one token's per layer.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import hymba as hymba_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import rwkv6 as rwkv_mod
from repro_torch.models.attention import (attention_apply, attention_decode,
                                         attention_schema, quantize_kv)
from repro_torch.models.layers import (cross_entropy_loss, embed,
                                       embed_rows,
                                       embedding_schema, logits, mlp,
                                       mlp_schema, rmsnorm, rmsnorm_schema,
                                       rope_cos_sin)
from repro_torch.models.schema import (STACKS, layer_params, n_stacked,
                                       stack_schema, tree_map)
from repro_torch.kernels.build import is_dtensor
from repro_torch.kernels.dtensor import store
from repro_torch.parallel.sharding import placed_zeros, shard_act

# Leaves the reference reads in fp32 whatever the compute dtype
# (``.astype(jnp.float32)`` at use): rwkv's bonus ``u`` and head-norm scale,
# Mamba's log decay rates.
F32_LEAVES = ("u", "out_norm", "a_log")


def _check_family(cfg: ModelConfig) -> None:
    if cfg.family == "encdec":
        raise NotImplementedError(
            "family 'encdec' (whisper) is not a decoder-only LM: its model "
            "is models/whisper.py, through registry.model_fns")


def _mixer_schema(cfg: ModelConfig):
    if cfg.family == "rwkv":
        return rwkv_mod.rwkv_time_schema(cfg)
    if cfg.family == "hybrid":
        return hymba_mod.hymba_mixer_schema(cfg)
    if cfg.mla is not None:
        return mla_mod.mla_schema(cfg)
    return attention_schema(cfg)


def _ffn_schema(cfg: ModelConfig, dense: bool = False):
    if cfg.family == "rwkv":
        return rwkv_mod.rwkv_channel_schema(cfg)
    if cfg.family == "moe" and not dense:
        return moe_mod.moe_schema(cfg)
    d_ff = cfg.moe.d_ff_dense if (dense and cfg.moe.d_ff_dense) else cfg.d_ff
    return mlp_schema(cfg.d_model, d_ff, gated=cfg.activation != "relu2")


def block_schema(cfg: ModelConfig, dense_ffn: bool = False):
    _check_family(cfg)
    return {
        "ln1": rmsnorm_schema(cfg.d_model),
        "mixer": _mixer_schema(cfg),
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


def _stacks(params):
    """(stack name, its layers' parameters) in forward order."""
    return [(name, params[name]) for name in STACKS if name in params]


def cast_matrix_params(params, dtype: torch.dtype):
    """Cast every ≥2-D floating tensor to ``dtype`` but the leaves named in
    ``F32_LEAVES``; 1-D params (norm scales) stay as they are — the JAX
    package's ``maybe_cast_params`` rule. Casting once at load gives the
    numbers the per-use casts give, for every leaf the reference casts at
    use, and those it reads in fp32 stay fp32."""
    if isinstance(params, dict):
        return {k: v if k in F32_LEAVES else cast_matrix_params(v, dtype)
                for k, v in params.items()}
    if params.ndim >= 2 and params.is_floating_point():
        return params.to(dtype)
    return params


def maybe_cast_params(params, cfg: ModelConfig):
    """``opt_bf16_params``: matrix params cast to the compute dtype once,
    before the layer loop (the optimizer keeps the f32 master copy). The
    rule follows the JAX leaf's rank, ``F32_LEAVES`` included: every leaf
    of a per-layer list stands for a stacked ``(n_layers, …)`` leaf of rank
    ≥ 2, so block norm scales are cast too, exactly as in the reference."""
    if not cfg.opt_bf16_params:
        return params
    dt = cfg.compute_dtype_
    if not isinstance(params["blocks"], list):
        return tree_map(lambda a: a.to(dt) if a.ndim >= 2 and
                        a.is_floating_point() else a, params)
    out = cast_matrix_params({k: v for k, v in params.items()
                              if k not in STACKS}, dt)
    for name, blocks in _stacks(params):
        out[name] = [tree_map(
            lambda a: a.to(dt) if a.is_floating_point() else a, bp)
            for bp in blocks]
    return out


def ffn_apply(bp, h2, cfg: ModelConfig, dense_ffn: bool = False):
    """A layer's FFN on its normed input: (B, S, d), or one token per row
    (B, d), which the MoE layer sees as (B, 1, d) as the reference passes
    it. Returns (output, the MoE aux loss, or None for a dense FFN). Not
    for rwkv, whose channel mix carries a shift state."""
    if cfg.family != "moe" or dense_ffn:
        return mlp(bp["ffn"], h2, cfg.activation), None
    if h2.dim() == 2:
        y, aux = moe_mod.moe_apply(bp["ffn"], h2[:, None, :], cfg)
        return y[:, 0], aux
    return moe_mod.moe_apply(bp["ffn"], h2, cfg)


def _block_apply(bp, x, cfg: ModelConfig, positions, dense_ffn=False):
    """One layer: pre-norm mixer and FFN with residuals. Returns (x, the
    MoE aux loss or None)."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if cfg.family == "rwkv":
        x = x + rwkv_mod.rwkv_time_apply(bp["mixer"], h, cfg)
        h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
        return x + rwkv_mod.rwkv_channel_apply(bp["ffn"], h2, cfg), None
    if cfg.family == "hybrid":
        x = x + hymba_mod.hymba_mixer_apply(bp["mixer"], h, cfg,
                                            positions=positions)
    elif cfg.mla is not None:
        x = x + mla_mod.mla_apply(bp["mixer"], h, cfg, positions=positions,
                                  window=cfg.window)
    else:
        x = x + attention_apply(bp["mixer"], h, cfg, positions=positions,
                                causal=cfg.causal, window=cfg.window)
    f, aux = ffn_apply(bp, rmsnorm(bp["ln2"], x, cfg.norm_eps), cfg,
                       dense_ffn)
    return x + f, aux


def _scan_blocks(blocks, x, cfg: ModelConfig, positions, dense_ffn=False):
    """The layer loop over one stack, each layer checkpointed under
    ``remat="full"``. Returns (x, the stack's summed aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for layer in range(n_stacked(blocks)):
        bp = layer_params(blocks, layer)
        if cfg.remat == "full":
            x, a = checkpoint(_block_apply, bp, x, cfg, positions,
                              dense_ffn, use_reentrant=False)
        else:
            x, a = _block_apply(bp, x, cfg, positions, dense_ffn)
        x = shard_act(x, ("batch", "seq", "act_embed"))
        if a is not None:
            aux = aux + a
    return x, aux


def lm_forward(params, tokens: torch.Tensor, cfg: ModelConfig, *,
               positions=None, prefix_embeds=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens (B, S) → (logits (B, S, V_padded) fp32, aux loss scalar: the
    MoE layers' summed aux, 0 for the other families). ``prefix_embeds``
    (B, P, d), the vision-language stub (pixtral's patch embeddings), take
    the place of the first P embedded rows, cast to the compute dtype."""
    B, S = tokens.shape
    params = maybe_cast_params(params, cfg)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
    x = embed(params["embed"], tokens, cfg)
    if prefix_embeds is not None:
        P = prefix_embeds.shape[1]
        x = torch.cat([prefix_embeds.to(x.dtype), x[:, P:]], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=tokens.device)
    for name, blocks in _stacks(params):
        x, a = _scan_blocks(blocks, x, cfg, positions,
                            dense_ffn=name == "head_blocks")
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


def _check_static_cache(cfg: ModelConfig) -> None:
    """The static engine's cache covers every decoder-only family. Leading
    dense blocks (``first_dense``) are refused outside MLA: the reference's
    cache carries MLA latents for them only (``head_ckv``/``head_krope``),
    so its static decode of a GQA config with head blocks cannot run
    either."""
    _check_family(cfg)
    if _n_head_blocks(cfg) and cfg.mla is None:
        raise NotImplementedError(
            "first_dense head blocks of a GQA config: the reference's "
            "static cache gives them no attention entries")


def cache_spec(cfg: ModelConfig, batch: int, max_len: int):
    """Shapes and dtypes of the decode cache, ``{name: (shape, dtype)}``
    with the layer dim first (the module docstring lists the entries);
    ``len`` (batch,) int32."""
    _check_static_cache(cfg)
    Lh = _n_head_blocks(cfg)
    L = cfg.n_layers - Lh
    dt = cfg.compute_dtype_
    d = cfg.d_model
    out: Dict[str, Any] = {}
    if cfg.family == "rwkv":
        n = cfg.ssm.head_size
        out["shift_t"] = ((L, batch, d), dt)
        out["shift_c"] = ((L, batch, d), dt)
        out["wkv"] = ((L, batch, d // n, n, n), torch.float32)
    elif cfg.family == "hybrid":
        ssm = cfg.ssm
        di = ssm.d_inner or 2 * d
        W = min(cfg.window or max_len, max_len)
        sh = (L, batch, cfg.n_kv_heads, W, cfg.head_dim_)
        out["k"] = (sh, dt)
        out["v"] = (sh, dt)
        out["ssm"] = ((L, batch, di, ssm.state), torch.float32)
        out["conv"] = ((L, batch, ssm.conv_width - 1, di), dt)
    elif cfg.mla is not None:
        a = cfg.mla
        out["ckv"] = ((L, batch, max_len, a.kv_lora), dt)
        out["krope"] = ((L, batch, max_len, a.qk_rope), dt)
        if Lh:
            out["head_ckv"] = ((Lh, batch, max_len, a.kv_lora), dt)
            out["head_krope"] = ((Lh, batch, max_len, a.qk_rope), dt)
    else:
        sh = (L, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
        kv_dt = torch.int8 if cfg.opt_int8_kv else dt
        out["k"] = (sh, kv_dt)
        out["v"] = (sh, kv_dt)
        if cfg.opt_int8_kv:
            out["k_scale"] = (sh[:4], torch.float32)
            out["v_scale"] = (sh[:4], torch.float32)
    out["len"] = ((batch,), torch.int32)
    return out


def cache_logical(cfg: ModelConfig):
    """``{name: logical axes}`` of ``cache_spec``'s entries (the third
    element of the reference's ``cache_spec`` tuples). Under
    ``opt_cache_seq_shard`` the cache's sequence dim is ``kv_seq`` (the
    rules map it to ``model``), otherwise ``seq``."""
    seq = "kv_seq" if cfg.opt_cache_seq_shard else "seq"
    kv = ("layers", "batch", "kv_heads", seq, "head_dim")
    axes = {"k": kv, "v": kv, "k_scale": kv[:4], "v_scale": kv[:4],
            "ckv": ("layers", "batch", seq, "kv_lora"),
            "krope": ("layers", "batch", seq, None),
            "head_ckv": ("layers", "batch", seq, "kv_lora"),
            "head_krope": ("layers", "batch", seq, None),
            "shift_t": ("layers", "batch", "act_embed"),
            "shift_c": ("layers", "batch", "act_embed"),
            "wkv": ("layers", "batch", "heads", "head_dim", None),
            "ssm": ("layers", "batch", "act_mlp", "state"),
            "conv": ("layers", "batch", None, "act_mlp"),
            "len": ("batch",)}
    return {name: axes[name] for name in cache_spec(cfg, 1, 1)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None,
               placed: bool = False):
    """The zero cache; ``placed``: each entry a DTensor placed by its
    logical axes under the ambient mesh and rules."""
    spec = cache_spec(cfg, batch, max_len)
    if placed:
        logical = cache_logical(cfg)
        return {name: placed_zeros(sh, dt, logical[name], device)
                for name, (sh, dt) in spec.items()}
    return {name: torch.zeros(sh, dtype=dt, device=device)
            for name, (sh, dt) in spec.items()}


# the scale of an int8 row of zeros, which unwritten cache rows keep
_PAD_SCALE = quantize_kv(torch.zeros((1, 1)))[1].item()


_HEAD_KEYS = {"head_ckv": "ckv", "head_krope": "krope"}


def _split_cache(cache):
    """(the body stack's entries, the head stack's under their body
    names)."""
    body = {k: v for k, v in cache.items()
            if k != "len" and not k.startswith("head_")}
    head = {tgt: cache[src] for src, tgt in _HEAD_KEYS.items()
            if src in cache}
    return body, head


def _layer_caches(params, cache):
    """Per stack in forward order: (name, its layers' parameters, a
    function of the layer index giving that layer's cache entries as views
    into the stacked cache)."""
    body, head = _split_cache(cache)
    out = []
    for name, blocks in _stacks(params):
        stack = head if name == "head_blocks" else body
        out.append((name, blocks,
                    lambda i, s=stack: {k: c[i] for k, c in s.items()}))
    return out


# ---------------------------------------------------------------------------
# Decode step
# ---------------------------------------------------------------------------


def _mixer_decode(bp, x1, cfg: ModelConfig, lc, cache_len, rope_cs):
    """One layer's mixer on one token; writes its entries of the layer
    cache ``lc`` (views into the stacked cache) in place."""
    if cfg.family == "rwkv":
        y1, shift, wkv = rwkv_mod.rwkv_time_decode(
            bp["mixer"], x1, cfg, shift_state=lc["shift_t"],
            wkv_state=lc["wkv"])
        store(lc["shift_t"], shift)
        store(lc["wkv"], wkv)
        return y1
    if cfg.family == "hybrid":
        y1, _, _, h, conv = hymba_mod.hymba_mixer_decode(
            bp["mixer"], x1, cfg, cache_k=lc["k"], cache_v=lc["v"],
            cache_len=cache_len, ssm_state=lc["ssm"], conv_state=lc["conv"],
            rope_cs=rope_cs)
        store(lc["ssm"], h)
        store(lc["conv"], conv)
        return y1
    if cfg.mla is not None:
        return mla_mod.mla_decode(
            bp["mixer"], x1, cfg, cache_ckv=lc["ckv"],
            cache_krope=lc["krope"], cache_len=cache_len)[0]
    return attention_decode(
        bp["mixer"], x1, cfg, cache_k=lc["k"], cache_v=lc["v"],
        cache_len=cache_len, window=cfg.window,
        cache_k_scale=lc.get("k_scale"), cache_v_scale=lc.get("v_scale"),
        rope_cs=rope_cs)[0]


def _ffn_decode(bp, h2, cfg: ModelConfig, lc, dense_ffn):
    if cfg.family == "rwkv":
        y1, shift = rwkv_mod.rwkv_channel_decode(
            bp["ffn"], h2, cfg, shift_state=lc["shift_c"])
        store(lc["shift_c"], shift)
        return y1
    return ffn_apply(bp, h2, cfg, dense_ffn)[0]


def _block_decode(bp, x1, cfg: ModelConfig, lc, cache_len, rope_cs,
                  dense_ffn):
    h = rmsnorm(bp["ln1"], x1, cfg.norm_eps)
    x1 = x1 + _mixer_decode(bp, h, cfg, lc, cache_len, rope_cs)
    h2 = rmsnorm(bp["ln2"], x1, cfg.norm_eps)
    return x1 + _ffn_decode(bp, h2, cfg, lc, dense_ffn)


def lm_decode_step(params, tokens1: torch.Tensor, cache, cfg: ModelConfig):
    """One decode step: (logits (B, V) fp32 for the next token, the cache
    with ``len + 1``). Each layer's entries are written into ``cache`` in
    place; the returned dict holds the same tensors and a new ``len``."""
    _check_static_cache(cfg)
    params = maybe_cast_params(params, cfg)
    cache_len = cache["len"]
    # opt_onehot_embed: the reference multiplies a one-hot matrix by the
    # table, so that a vocab-sharded table is read in place; one-hot @ table
    # returns the table rows exactly, so the gather gives the same numbers
    x1 = embed_rows(params["embed"]["embedding"].to(cfg.compute_dtype_),
                    tokens1)
    x1 = shard_act(x1, ("batch", "act_embed"))
    # the GQA RoPE rotation at the step's positions, shared by the layers
    # (MLA ropes its own qk_rope dims; rwkv has none)
    rope_cs = rope_cos_sin(cache_len[:, None, None], cfg.rope_theta,
                           cfg.head_dim_ // 2) \
        if cfg.rope_theta > 0 and cfg.mla is None else None
    for name, blocks, layer_cache in _layer_caches(params, cache):
        for layer in range(n_stacked(blocks)):
            x1 = _block_decode(layer_params(blocks, layer), x1, cfg,
                               layer_cache(layer), cache_len, rope_cs,
                               dense_ffn=name == "head_blocks")
    x1 = rmsnorm(params["final_norm"], x1, cfg.norm_eps)
    return logits(params["embed"], x1, cfg), {**cache, "len": cache_len + 1}


# ---------------------------------------------------------------------------
# Prefill (forward + cache construction); assumes full-length prompts
# ---------------------------------------------------------------------------


def _ring_place(k_seq: torch.Tensor, W: int) -> torch.Tensor:
    """The last ≤ W positions of (B, H, S, D) placed into a ring buffer
    (B, H, W, D): position p sits in slot p % W; slots no position reached
    are 0."""
    S = k_seq.shape[2]
    slots = torch.arange(W, device=k_seq.device)
    p = S - 1 - torch.remainder(S - 1 - slots, W)     # source pos per slot
    gathered = k_seq.index_select(2, torch.clamp(p, 0, S - 1))
    return torch.where((p >= 0)[None, None, :, None], gathered,
                       torch.zeros((), dtype=k_seq.dtype,
                                   device=k_seq.device))


def _head(t: torch.Tensor, n: int, dim: int) -> torch.Tensor:
    """The first ``n`` rows of ``t`` along ``dim`` (``t`` itself when that
    is all of it: a placed tensor is not sliced)."""
    return t if n == t.shape[dim] else t.narrow(dim, 0, n)


def _layer_prefill(bp, x, cfg: ModelConfig, positions, lc, dense_ffn):
    """One layer over the prompts, writing the layer's cache entries ``lc``
    in place. Returns x."""
    h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
    if cfg.family == "rwkv":
        y, shift, wkv = rwkv_mod.rwkv_time_apply(bp["mixer"], h, cfg,
                                                 return_state=True)
        store(lc["shift_t"], shift)
        store(lc["wkv"], wkv)
    elif cfg.family == "hybrid":
        mp = bp["mixer"]
        a, k, v = attention_apply(mp["attn"], h, cfg, positions=positions,
                                  causal=True, window=cfg.window,
                                  return_kv=True)
        m, ssm_h, conv = hymba_mod.mamba_apply(mp["mamba"], h, cfg,
                                               return_state=True)
        y = hymba_mod.combine(mp, a, m, cfg)
        W = lc["k"].shape[2]
        store(lc["k"], _ring_place(k, W))
        store(lc["v"], _ring_place(v, W))
        store(lc["ssm"], ssm_h)
        store(lc["conv"], conv)
    elif cfg.mla is not None:
        n = min(x.shape[1], lc["ckv"].shape[1])
        y = mla_mod.mla_apply(bp["mixer"], h, cfg, positions=positions,
                              window=cfg.window)
        ckv, krope = mla_mod.mla_prefill_cache(bp["mixer"], h, cfg,
                                               positions)
        store(lc["ckv"], _head(ckv, n, 1), n, dim=1)
        store(lc["krope"], _head(krope, n, 1), n, dim=1)
    else:
        n = min(x.shape[1], lc["k"].shape[2])
        y, k, v = attention_apply(bp["mixer"], h, cfg, positions=positions,
                                  causal=cfg.causal, window=cfg.window,
                                  return_kv=True)
        for name, t in (("k", _head(k, n, 2)), ("v", _head(v, n, 2))):
            if cfg.opt_int8_kv:
                t, sc = quantize_kv(t)
                store(lc[name + "_scale"], sc, n)
            store(lc[name], t, n)
    x = x + y
    h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
    if cfg.family == "rwkv":
        f, shift_c = rwkv_mod.rwkv_channel_apply(bp["ffn"], h2, cfg,
                                                 return_state=True)
        store(lc["shift_c"], shift_c)
    else:
        f = ffn_apply(bp, h2, cfg, dense_ffn)[0]
    return x + f


def lm_prefill(params, tokens: torch.Tensor, cfg: ModelConfig,
               max_len: int):
    """tokens (B, S) full prompts → (last-token logits (B, V), the cache
    ready for decode). The cache is allocated once at ``max_len`` and each
    layer's entries are written into it: the first ``max_len`` prompt rows
    of a linear cache (K/V, MLA latents), the last ``W`` positions of a
    ring, the final recurrent states. Under ``opt_int8_kv`` the K/V rows
    are quantized and the unwritten rows keep the scale of a zero row, as
    the reference quantizes the zero-padded cache."""
    _check_static_cache(cfg)
    B, S = tokens.shape
    params = maybe_cast_params(params, cfg)
    positions = torch.arange(S, dtype=torch.int32,
                             device=tokens.device).expand(B, S)
    x = embed(params["embed"], tokens, cfg)
    cache = init_cache(cfg, B, max_len, device=tokens.device,
                       placed=is_dtensor(tokens))
    if "k_scale" in cache:
        cache["k_scale"].fill_(_PAD_SCALE)
        cache["v_scale"].fill_(_PAD_SCALE)
    for name, blocks, layer_cache in _layer_caches(params, cache):
        for layer in range(n_stacked(blocks)):
            x = _layer_prefill(layer_params(blocks, layer), x, cfg,
                               positions, layer_cache(layer),
                               dense_ffn=name == "head_blocks")
    cache["len"].fill_(S)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return logits(params["embed"], x[:, -1], cfg), cache
