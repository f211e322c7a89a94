"""deepseek-v2-236b — MLA (kv_lora=512) + 2 shared / 160 routed top-6 MoE.
[arXiv:2405.04434]"""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b",
    family="moe",
    n_layers=60,
    d_model=5120,
    n_heads=128,
    n_kv_heads=128,
    d_ff=1536,                 # per-expert hidden
    vocab_size=102400,
    activation="silu",
    rope_theta=10000.0,
    mla=MLAConfig(q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64,
                  v_head=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536,
                  n_shared=2, d_shared=1536,
                  first_dense=1, d_ff_dense=12288,
                  capacity_factor=1.25),
)
