"""moonshot-v1-16b-a3b — Moonlight-style MoE, 64 experts top-6.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="moonshot-v1-16b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1408,                 # per-expert hidden
    vocab_size=163840,
    activation="silu",
    rope_theta=50000.0,
    moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408,
                  capacity_factor=1.25),
)
