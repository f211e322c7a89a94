"""Architecture registry: ``--arch <id>`` → config; reduced CPU configs;
parameter init and the uniform model interface (``model_fns``) for the
dense LM."""
from __future__ import annotations

import dataclasses
import importlib
from types import SimpleNamespace

import torch

from repro_torch.configs.base import MLAConfig, ModelConfig, SSMConfig
from repro_torch.models import lm as lm_mod
from repro_torch.models.lm import lm_schema
from repro_torch.models.schema import init_params

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


def get_config(arch: str) -> ModelConfig:
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


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


def model_fns(cfg: ModelConfig) -> SimpleNamespace:
    """The dense family's uniform interface, as in the JAX registry:
    ``schema``, ``init(generator)`` (parameters on ``generator.device``),
    ``loss(params, batch)`` (``lm_loss``'s own z-loss weight, as the
    reference's registry keeps it), and the static engine's
    ``prefill(params, batch, max_len)``, ``decode_step(params, tokens1,
    cache)`` and ``cache_spec(batch, max_len)``."""
    schema = lm_schema(cfg)
    return SimpleNamespace(
        schema=schema,
        init=lambda generator: init_params(schema, generator,
                                           cfg.param_dtype_),
        loss=lambda p, batch: lm_mod.lm_loss(p, batch, cfg),
        prefill=lambda p, batch, max_len: lm_mod.lm_prefill(
            p, batch["tokens"], cfg, max_len),
        decode_step=lambda p, tok1, cache: lm_mod.lm_decode_step(
            p, tok1, cache, cfg),
        cache_spec=lambda batch, max_len: lm_mod.cache_spec(
            cfg, batch, max_len),
    )
