"""Architecture registry: ``--arch <id>`` → config; reduced CPU configs;
parameter init and the uniform model interface (``model_fns``) over the
two model assemblies: the decoder-only LM (dense, MoE, MLA, rwkv and hybrid
families) and the encoder-decoder whisper; which (arch, shape) cells run
(``cell_supported``) and their inputs as meta tensors (``input_specs``)."""
from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace
from typing import Dict, Optional

import torch

from repro_torch.configs.base import (MLAConfig, ModelConfig, ShapeConfig,
                                      SSMConfig)
from repro_torch.models import lm as lm_mod
from repro_torch.models import whisper as whisper_mod
from repro_torch.models.lm import lm_schema
from repro_torch.models.schema import (abstract_params, init_params,
                                       logical_specs)

ARCH_IDS = (
    "moonshot-v1-16b-a3b",
    "deepseek-v2-236b",
    "qwen3-4b",
    "granite-3-8b",
    "nemotron-4-15b",
    "llama3.2-3b",
    "hymba-1.5b",
    "whisper-base",
    "rwkv6-7b",
    "pixtral-12b",
    "bert-base",
    "bert-large",
)

_MODULES = {arch: arch.replace("-", "_").replace(".", "_")
            for arch in ARCH_IDS}

# The 10 assigned archs (bert_* are paper-eval only).
GRID_ARCHS = ARCH_IDS[:10]

# long_500k runs only for sub-quadratic context archs.
SUBQUADRATIC = {"hymba-1.5b", "rwkv6-7b"}


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def cell_supported(arch: str, shape: ShapeConfig) -> Optional[str]:
    """None if the (arch, shape) cell runs; else the reference's skip
    reason, word for word."""
    if shape.name == "long_500k" and arch not in SUBQUADRATIC:
        return ("full-attention arch: 524k-token dense decode is the "
                "regime DESIGN.md documents as skipped (sub-quadratic only)")
    return None


def reduce_config(cfg: ModelConfig) -> ModelConfig:
    """Tiny sibling of the same family for CPU tests."""
    kw = dict(
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        vocab_pad_to=64,
        attention_chunk=32,
        compute_dtype="float32",
        remat="none",
    )
    if cfg.family == "encdec":
        kw.update(n_enc_layers=2, enc_positions=16)
    if cfg.window:
        kw.update(window=16)
    if cfg.moe.n_experts:
        kw["moe"] = dataclasses.replace(
            cfg.moe, n_experts=8, top_k=2, d_expert=32,
            d_shared=32 if cfg.moe.n_shared else 0,
            d_ff_dense=64 if cfg.moe.first_dense else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora=32 if cfg.mla.q_lora else 0, kv_lora=24,
                              qk_nope=16, qk_rope=8, v_head=16)
        kw["head_dim"] = 0
    if cfg.family == "hybrid":
        kw["ssm"] = SSMConfig(state=8, d_inner=128, conv_width=4)
    if cfg.family == "rwkv":
        kw["ssm"] = SSMConfig(head_size=16, decay_lora=8, mix_lora=8)
        kw.update(n_heads=4, n_kv_heads=4)
    return cfg.replace(**kw)


def init_lm_params(cfg: ModelConfig, generator: torch.Generator):
    """Random LM parameters in ``cfg.param_dtype`` on ``generator.device``."""
    return init_params(lm_schema(cfg), generator, cfg.param_dtype_)


# decoder positions of whisper's schema: the reference's registry sizes
# the table for its longest decode and training cells
MAX_DEC_POSITIONS = 33024


def check_decoder_only(cfg: ModelConfig, what: str) -> None:
    """Refuse the encoder-decoder family where only prompts come in (the
    engines, the launchers): its prefill reads audio frames."""
    if cfg.family == "encdec":
        raise ValueError(
            f"{what}: the encoder-decoder family ({cfg.name}) takes audio "
            "frames, not prompts alone; serve it by composing "
            "model_fns(cfg).prefill (frames in) and "
            "model_fns(cfg).decode_step, train it through "
            "model_fns(cfg).loss on batches with 'frames'")


def model_fns(cfg: ModelConfig) -> SimpleNamespace:
    """The uniform interface, as in the JAX registry: ``schema``, ``specs``
    (its tree of logical-axis tuples), ``init(generator)`` (parameters on
    ``generator.device``), ``abstract()`` (the same tree as meta tensors,
    no memory), ``forward(params, batch)`` (logits), ``loss(params, batch)`` (cross
    entropy with its own z-loss weight, as the reference's registry keeps
    it, plus the MoE layers' aux loss; metrics ``{"ce", "aux"}``), and the
    serving steps ``prefill(params, batch, max_len)``,
    ``decode_step(params, tokens1, cache)``, ``cache_spec(batch,
    max_len)`` and ``cache_logical()`` (the cache entries' logical axes,
    which the reference's ``cache_spec`` carries as a third element).

    The encoder-decoder family (whisper) reads ``batch["frames"]`` (B,
    ``cfg.enc_positions``, d) besides the tokens; its ``prefill`` returns
    ``(None, cache)``: the encoder output's cross K/V and an empty self
    cache, no logits. The decoder-only families' ``prefill`` returns the
    last prompt token's logits and the cache (the static engine's steps)."""
    if cfg.family == "encdec":
        schema = whisper_mod.whisper_schema(
            cfg, max_dec_positions=MAX_DEC_POSITIONS)
        return SimpleNamespace(
            schema=schema,
            specs=logical_specs(schema),
            init=lambda generator: init_params(schema, generator,
                                               cfg.param_dtype_),
            abstract=lambda: abstract_params(schema, cfg.param_dtype_),
            forward=lambda p, batch: whisper_mod.whisper_forward(
                p, batch["frames"], batch["tokens"], cfg),
            loss=lambda p, batch: whisper_mod.whisper_loss(p, batch, cfg),
            prefill=lambda p, batch, max_len: (
                None, whisper_mod.whisper_prefill(
                    p, batch["frames"], cfg, batch["frames"].shape[0],
                    max_len)),
            decode_step=lambda p, tok1, cache:
                whisper_mod.whisper_decode_step(p, tok1, cache, cfg),
            cache_spec=lambda batch, max_len: whisper_mod.whisper_cache_spec(
                cfg, batch, max_len, cfg.enc_positions),
            cache_logical=whisper_mod.whisper_cache_logical,
        )
    schema = lm_schema(cfg)
    return SimpleNamespace(
        schema=schema,
        specs=logical_specs(schema),
        init=lambda generator: init_params(schema, generator,
                                           cfg.param_dtype_),
        abstract=lambda: abstract_params(schema, cfg.param_dtype_),
        forward=lambda p, batch: lm_mod.lm_forward(p, batch["tokens"],
                                                   cfg)[0],
        loss=lambda p, batch: lm_mod.lm_loss(p, batch, cfg),
        prefill=lambda p, batch, max_len: lm_mod.lm_prefill(
            p, batch["tokens"], cfg, max_len),
        decode_step=lambda p, tok1, cache: lm_mod.lm_decode_step(
            p, tok1, cache, cfg),
        cache_spec=lambda batch, max_len: lm_mod.cache_spec(
            cfg, batch, max_len),
        cache_logical=lambda: lm_mod.cache_logical(cfg),
    )


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, object]:
    """The inputs of the step of this (arch, shape) cell as meta tensors
    (shapes and dtypes, no memory), keyed as the reference's.

    train/prefill: int32 token batches (whisper adds its float32 frame
    embeddings). decode: one token a sequence and the cache at
    ``shape.seq_len`` (``cache_spec``)."""
    B, S = shape.global_batch, shape.seq_len

    def meta(shape_, dtype=torch.int32):
        return torch.empty(shape_, dtype=dtype, device="meta")

    frames = {}
    if cfg.family == "encdec":
        frames["frames"] = meta((B, cfg.enc_positions, cfg.d_model),
                                torch.float32)
    if shape.kind == "train":
        return {**frames, "tokens": meta((B, S)), "labels": meta((B, S))}
    if shape.kind == "prefill":
        return {**frames, "tokens": meta((B, S))}
    cache = {k: meta(sh, dt)
             for k, (sh, dt) in model_fns(cfg).cache_spec(B, S).items()}
    return {"tokens1": meta((B,)), "cache": cache}
