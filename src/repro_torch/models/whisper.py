"""Whisper-style encoder-decoder backbone (audio frontend stubbed), the JAX
package's ``repro.models.whisper`` in PyTorch.

The conv/mel frontend is a stub: the encoder takes precomputed frame
embeddings (B, n_frames, d_model). The backbone: sinusoidal encoder
positions, learned decoder positions (``embed.dec_pos``), pre-LN LayerNorm
blocks, GELU MLPs, bidirectional encoder self attention, causal decoder
self attention and cross attention over the encoder output, logits tied to
the embedding. All three softmax sites run through Softermax: under
``attention_impl="flash"`` the encoder's, the decoder's and the cross
attention's through the dense flash kernels (K3 forward, K4 backward).

Serving: ``whisper_prefill`` encodes the frames and projects each decoder
layer's cross K/V once (its static cross cache); the self cache starts
empty. ``whisper_decode_step`` runs one token: the self cache through
``attention_decode`` (the decode kernel K5 on the card, its row written in
place as in ``models/lm.py``), the cross attention through the plain
``_masked_decode`` against the static cross K/V, as the reference computes
it in ``jnp`` outside any Pallas kernel. The engines take prompts alone and
refuse this family; a caller composes ``prefill`` and ``decode_step``
(``registry.model_fns``).

Layer stacks ``enc_blocks`` and ``dec_blocks`` keep the leading
``(n_layers, …)`` axis, or are per-layer lists (``layer_params``); under
``remat="full"`` each layer is checkpointed (``torch.utils.checkpoint``,
non-reentrant), as ``jax.checkpoint`` wraps the reference's scan body.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (_mode, masked_decode,
                                          attention_apply, attention_decode,
                                          attention_schema, proj_heads)
from repro_torch.models.layers import (cross_entropy_loss, embed_rows,
                                       layernorm,
                                       layernorm_schema, logits, mlp,
                                       mlp_schema, round_to,
                                       sinusoidal_positions)
from repro_torch.models.schema import (ParamSpec, layer_params, n_stacked,
                                       stack_schema)
from repro_torch.parallel.sharding import shard_act


def _enc_block_schema(cfg: ModelConfig):
    return {
        "ln1": layernorm_schema(cfg.d_model),
        "attn": attention_schema(cfg),
        "ln2": layernorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg.d_model, cfg.d_ff, gated=False),
    }


def _dec_block_schema(cfg: ModelConfig):
    return {
        "ln1": layernorm_schema(cfg.d_model),
        "self_attn": attention_schema(cfg),
        "ln_x": layernorm_schema(cfg.d_model),
        "cross_attn": attention_schema(cfg),
        "ln2": layernorm_schema(cfg.d_model),
        "mlp": mlp_schema(cfg.d_model, cfg.d_ff, gated=False),
    }


def whisper_schema(cfg: ModelConfig, max_dec_positions: int = 4096):
    return {
        "embed": {
            "embedding": ParamSpec((cfg.padded_vocab, cfg.d_model),
                                   ("vocab", "embed"), init="embed", std=1.0),
            "dec_pos": ParamSpec((max_dec_positions, cfg.d_model),
                                 (None, "embed"), std=0.02),
        },
        "enc_blocks": stack_schema(_enc_block_schema(cfg), cfg.n_enc_layers),
        "enc_norm": layernorm_schema(cfg.d_model),
        "dec_blocks": stack_schema(_dec_block_schema(cfg), cfg.n_layers),
        "dec_norm": layernorm_schema(cfg.d_model),
    }


def _layers(blocks, body, x, cfg: ModelConfig, *args):
    """``x = body(layer params, x, *args)`` over a stack, each layer
    checkpointed under ``remat="full"``."""
    for layer in range(n_stacked(blocks)):
        bp = layer_params(blocks, layer)
        if cfg.remat == "full":
            x = checkpoint(body, bp, x, *args, use_reentrant=False)
        else:
            x = body(bp, x, *args)
    return x


def _positions(B: int, n: int, device) -> torch.Tensor:
    return torch.arange(n, dtype=torch.int32, device=device).expand(B, n)


def whisper_encode(params, frames: torch.Tensor,
                   cfg: ModelConfig) -> torch.Tensor:
    """frames (B, F, d) stub embeddings → encoder output (B, F, d) in the
    compute dtype."""
    B, F, d = frames.shape
    x = frames.to(cfg.compute_dtype_)
    x = x + sinusoidal_positions(F, d, x.device).to(x.dtype)[None]
    x = shard_act(x, ("batch", "seq", "act_embed"))
    positions = _positions(B, F, x.device)
    ecfg = cfg.replace(rope_theta=0.0)   # positions are additive, not rotary

    def body(bp, x):
        h = layernorm(bp["ln1"], x, cfg.norm_eps)
        x = x + attention_apply(bp["attn"], h, ecfg, positions=positions,
                                causal=False)
        h2 = layernorm(bp["ln2"], x, cfg.norm_eps)
        return x + mlp(bp["mlp"], h2, "gelu")

    x = _layers(params["enc_blocks"], body, x, cfg)
    return layernorm(params["enc_norm"], x, cfg.norm_eps)


def whisper_forward(params, frames: torch.Tensor, tokens: torch.Tensor,
                    cfg: ModelConfig) -> torch.Tensor:
    """Teacher-forced decoder logits (B, S, V_padded) fp32."""
    B, S = tokens.shape
    enc = whisper_encode(params, frames, cfg)
    F = enc.shape[1]
    # rows gathered, then cast: the numbers of the reference's cast-then-
    # gather without a cast of the whole table
    x = embed_rows(params["embed"]["embedding"], tokens).to(
        cfg.compute_dtype_)
    x = x + params["embed"]["dec_pos"][:S].to(x.dtype)[None]
    positions = _positions(B, S, x.device)
    enc_positions = _positions(B, F, x.device)
    dcfg = cfg.replace(rope_theta=0.0)

    def body(bp, x, enc):
        h = layernorm(bp["ln1"], x, cfg.norm_eps)
        x = x + attention_apply(bp["self_attn"], h, dcfg,
                                positions=positions, causal=True)
        hx = layernorm(bp["ln_x"], x, cfg.norm_eps)
        x = x + attention_apply(bp["cross_attn"], hx, dcfg,
                                positions=positions, causal=False, x_kv=enc,
                                kv_positions=enc_positions)
        h2 = layernorm(bp["ln2"], x, cfg.norm_eps)
        return x + mlp(bp["mlp"], h2, "gelu")

    x = _layers(params["dec_blocks"], body, x, cfg, enc)
    x = layernorm(params["dec_norm"], x, cfg.norm_eps)
    return logits(params["embed"], x, cfg.replace(tie_embeddings=True))


def whisper_loss(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                 z_loss: float = 1e-4):
    """Cross entropy + z-loss of the teacher-forced logits. Returns (loss,
    {"ce", "aux"}), aux 0 (the family has no MoE)."""
    lg = whisper_forward(params, batch["frames"], batch["tokens"], cfg)
    ce = cross_entropy_loss(lg, batch["labels"], z_loss=z_loss,
                            vocab_size=cfg.vocab_size)
    return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32,
                                             device=ce.device)}


# ---------------------------------------------------------------------------
# Serving: cross K/V projected once; growing self cache
# ---------------------------------------------------------------------------


def whisper_cache_spec(cfg: ModelConfig, batch: int, max_len: int,
                       n_frames: int):
    """``{name: (shape, dtype)}``: the self cache ``k``/``v`` (L, B, Hkv,
    max_len, Dh), the cross cache ``xk``/``xv`` (L, B, Hkv, n_frames, Dh),
    both in the compute dtype, and ``len`` (B,) int32."""
    dt = cfg.compute_dtype_
    kv = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    xkv = (cfg.n_layers, batch, cfg.n_kv_heads, n_frames, cfg.head_dim_)
    return {"k": (kv, dt), "v": (kv, dt), "xk": (xkv, dt), "xv": (xkv, dt),
            "len": ((batch,), torch.int32)}


def whisper_cache_logical():
    """``{name: logical axes}`` of ``whisper_cache_spec``'s entries."""
    ax = ("layers", "batch", "kv_heads", "seq", "head_dim")
    return {"k": ax, "v": ax, "xk": ax, "xv": ax, "len": ("batch",)}


def whisper_prefill(params, frames: torch.Tensor, cfg: ModelConfig,
                    batch: int, max_len: int):
    """Encode, then each decoder layer's cross K/V (B, Hkv, F, Dh) from the
    encoder output; the self cache zeros, ``len`` 0. Returns the cache (no
    logits, as in the reference)."""
    enc = whisper_encode(params, frames, cfg)
    dt = cfg.compute_dtype_
    blocks = params["dec_blocks"]
    xk, xv = [], []
    for layer in range(n_stacked(blocks)):
        ap = layer_params(blocks, layer)["cross_attn"]
        xk.append(proj_heads(enc, ap["wk"].to(dt)).transpose(1, 2))
        xv.append(proj_heads(enc, ap["wv"].to(dt)).transpose(1, 2))
    sh = (cfg.n_layers, batch, cfg.n_kv_heads, max_len, cfg.head_dim_)
    dev = frames.device
    return {"k": torch.zeros(sh, dtype=dt, device=dev),
            "v": torch.zeros(sh, dtype=dt, device=dev),
            "xk": torch.stack(xk), "xv": torch.stack(xv),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


def whisper_decode_step(params, tokens1: torch.Tensor, cache,
                        cfg: ModelConfig):
    """One decoder token per row. Returns (logits (B, V_padded) fp32, the
    cache with ``len + 1``): each layer's self K/V row is written into
    ``cache`` in place at the row's ``len`` (which must stay below the
    cache's ``max_len``), and the returned dict holds the same tensors."""
    dt = cfg.compute_dtype_
    cache_len = cache["len"]
    x1 = params["embed"]["embedding"][tokens1].to(dt)
    x1 = x1 + params["embed"]["dec_pos"][cache_len.long()].to(dt)
    dcfg = cfg.replace(rope_theta=0.0)
    blocks = params["dec_blocks"]
    for layer in range(n_stacked(blocks)):
        bp = layer_params(blocks, layer)
        h = layernorm(bp["ln1"], x1, cfg.norm_eps)
        y, _, _ = attention_decode(bp["self_attn"], h, dcfg,
                                   cache_k=cache["k"][layer],
                                   cache_v=cache["v"][layer],
                                   cache_len=cache_len)
        x1 = x1 + y
        hx = layernorm(bp["ln_x"], x1, cfg.norm_eps)
        x1 = x1 + _cross_decode(bp["cross_attn"], hx, cache["xk"][layer],
                                cache["xv"][layer], dcfg)
        h2 = layernorm(bp["ln2"], x1, cfg.norm_eps)
        x1 = x1 + mlp(bp["mlp"], h2, "gelu")
    x1 = layernorm(params["dec_norm"], x1, cfg.norm_eps)
    lg = logits(params["embed"], x1, cfg.replace(tie_embeddings=True))
    return lg, {**cache, "len": cache_len + 1}


def _cross_decode(ap, x1, xk, xv, cfg: ModelConfig):
    """One token's cross attention against the static encoder K/V: the
    plain ``_masked_decode`` over every frame. q is scaled by 1/sqrt(dh)
    and then by the softmax premultiplier, two roundings as in the
    reference."""
    dt = cfg.compute_dtype_
    premult, intmax = _mode(cfg)
    q = proj_heads(x1, ap["wq"].to(dt))                  # (B, H, Dh)
    q = q * round_to(cfg.head_dim_ ** -0.5, q.dtype)
    q = q * round_to(premult, q.dtype)
    live = torch.ones((x1.shape[0], xk.shape[2]), dtype=torch.bool,
                      device=x1.device)
    o = masked_decode(q, xk, xv, live, intmax)
    wo = ap["wo"].to(dt)
    return o.flatten(1) @ wo.reshape(-1, wo.shape[-1])
