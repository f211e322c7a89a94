"""bert-large — the paper's larger evaluation network (Table III)."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-large",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab_size=30522,
    activation="gelu",
    causal=False,
    rope_theta=10000.0,
    tie_embeddings=True,
)
