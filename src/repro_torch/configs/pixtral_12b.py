"""pixtral-12b — mistral-nemo decoder backbone; pixtral-ViT frontend stubbed
(input_specs provides patch embeddings). [hf:mistralai/Pixtral-12B-2409]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="dense",
    n_layers=40,
    d_model=5120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    activation="silu",
    rope_theta=1000000.0,
)
