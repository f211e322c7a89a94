"""bert-base — the paper's own evaluation network (encoder-only); used by the
Table-III accuracy benchmark, not part of the 40-cell grid."""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="bert-base",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab_size=30522,
    activation="gelu",
    causal=False,              # bidirectional encoder
    rope_theta=10000.0,        # RoPE in place of learned positions
    tie_embeddings=True,
)
