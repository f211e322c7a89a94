"""Model, shape and run configuration dataclasses.

Field for field the same as the JAX package's ``repro.configs.base`` so a
config means the same model in both packages; only the dtype accessors
differ: ``compute_dtype_`` and ``param_dtype_`` return ``torch.dtype``s.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0
    top_k: int = 2
    d_expert: int = 0
    n_shared: int = 0
    d_shared: int = 0            # hidden dim of the shared-expert MLP
    capacity_factor: float = 1.25
    router_softmax: str = "softermax"   # beyond-paper: router uses base-2 too
    aux_loss_weight: float = 0.01
    first_dense: int = 0                # leading layers with dense FFN (DS-V2)
    d_ff_dense: int = 0                 # their hidden dim


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora: int = 0              # 0 = no q compression
    kv_lora: int = 512
    qk_nope: int = 128
    qk_rope: int = 64
    v_head: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    state: int = 16
    d_inner: int = 0             # 0 = 2*d_model
    conv_width: int = 4
    # rwkv
    head_size: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | rwkv | hybrid | encdec
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 = d_model // n_heads
    vocab_pad_to: int = 256      # Megatron-style vocab padding
    activation: str = "silu"     # silu | gelu | relu2
    qk_norm: bool = False
    tie_embeddings: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    # attention
    window: int = 0              # 0 = full attention; >0 = sliding window
    softmax_impl: str = "softermax"   # softmax | base2 | base2_folded |
                                      # softermax | softermax_fixed
    attention_impl: str = "chunked"   # chunked | flash | naive
    attention_chunk: int = 512
    causal: bool = True          # False for encoders (BERT)
    # submodules
    moe: MoEConfig = MoEConfig()
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    # enc-dec
    n_enc_layers: int = 0        # >0 => encoder-decoder (whisper)
    enc_positions: int = 1500    # encoder frame positions (whisper stub)
    # dtypes
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # remat: "none" | "full" (checkpoint layer body)
    remat: str = "full"
    # flags for tests / interpret-mode kernels
    interpret_kernels: bool = False
    # beyond-paper optimizations of the JAX package, kept so configs agree
    # field for field; of these the port reads ``opt_int8_kv`` (an int8 KV
    # pool by default) and ``opt_bf16_params`` (matrix parameters cast to
    # the compute dtype once per forward); the others shape sharding,
    # which the port does not have yet
    opt_bf16_params: bool = False
    opt_cache_seq_shard: bool = False
    opt_dus_cache: bool = False
    opt_moe_shard_map: bool = False
    opt_seq_parallel: bool = False
    opt_mla_absorbed: bool = False
    opt_int8_kv: bool = False
    opt_onehot_embed: bool = False
    opt_serve_resident: bool = False
    opt_ring_attention: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab_size + p - 1) // p) * p

    @property
    def compute_dtype_(self) -> torch.dtype:
        return getattr(torch, self.compute_dtype)

    @property
    def param_dtype_(self) -> torch.dtype:
        return getattr(torch, self.param_dtype)

    def with_opts(self, on: bool = True) -> "ModelConfig":
        return self.replace(opt_bf16_params=on, opt_cache_seq_shard=on,
                            opt_dus_cache=on, opt_moe_shard_map=on,
                            opt_seq_parallel=on, opt_mla_absorbed=on,
                            opt_onehot_embed=on, opt_serve_resident=on,
                            opt_ring_attention=on,
                            opt_int8_kv=(on and self.family in
                                         ("dense", "moe") and
                                         self.mla is None))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell."""

    name: str
    kind: str                # train | prefill | decode
    seq_len: int
    global_batch: int


# The training shape cell of the LM family (sequence length 4096).
TRAIN_4K = ShapeConfig("train_4k", "train", 4096, 256)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    z_loss: float = 1e-4
    microbatches: int = 1        # gradient accumulation
    grad_compression: bool = False  # int8 error-feedback allreduce (the
                                    # data-parallel step; not ported yet)
    checkpoint_every: int = 100
    keep_checkpoints: int = 3
    seed: int = 0
