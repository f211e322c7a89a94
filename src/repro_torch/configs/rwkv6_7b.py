"""rwkv6-7b — Finch: attention-free, data-dependent decay. [arXiv:2404.05892]
Softermax-inapplicable (no softmax in the architecture) — see DESIGN.md."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="rwkv",
    n_layers=32,
    d_model=4096,
    n_heads=64,                # d_model / head_size
    n_kv_heads=64,
    head_dim=64,
    d_ff=14336,
    vocab_size=65536,
    activation="relu2",        # channel-mix uses squared relu
    rope_theta=0.0,
    ssm=SSMConfig(head_size=64, decay_lora=64, mix_lora=32),
)
