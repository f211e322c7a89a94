"""hymba-1.5b — hybrid: parallel attention + mamba heads, ssm_state=16.
[arXiv:2411.13676] Sliding-window attention (1024) everywhere; meta tokens
stubbed (DESIGN.md §Arch-applicability)."""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    head_dim=64,
    d_ff=5504,
    vocab_size=32001,          # padded to 32256 for TP
    activation="silu",
    window=1024,
    rope_theta=10000.0,
    ssm=SSMConfig(state=16, d_inner=3200, conv_width=4),
)
