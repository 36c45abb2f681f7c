"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36) d_ff=5760
vocab=122753, WSD schedule, llama-like. [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab_size=122_753,
    head_dim=64,
    mlp="swiglu",
    norm="rmsnorm",
    schedule="wsd",
    tie_embeddings=True,
)
