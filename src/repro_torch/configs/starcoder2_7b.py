"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GQA + RoPE, gelu MLP + layernorm. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18_432,
    vocab_size=49_152,
    head_dim=128,
    mlp="gelu",
    norm="layernorm",
    attn_bias=True,
    rope_theta=1_000_000.0,
)
