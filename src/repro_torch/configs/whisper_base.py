"""whisper-base — enc-dec, conv/mel frontend stubbed (frame embeddings in).
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-base",
    family="encdec",
    n_layers=6,                # decoder layers
    n_enc_layers=6,
    enc_positions=1500,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab_size=51865,          # padded to 51968 for TP
    activation="gelu",
    rope_theta=0.0,            # additive positions (sinusoidal/learned)
    tie_embeddings=True,
)
