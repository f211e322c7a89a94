"""qwen3-4b — dense, GQA kv=8, qk_norm. [hf:Qwen/Qwen3-4B]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b",
    family="dense",
    n_layers=36,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=9728,
    vocab_size=151936,
    activation="silu",
    qk_norm=True,
    rope_theta=1000000.0,
)
