"""llama-3.2-vision-90b [vlm] — 100L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256, cross-attention image layers every 5th layer.
[hf:meta-llama/Llama-3.2-11B-Vision]

The vision frontend is a stub: the batch supplies precomputed patch
embeddings (vision_tokens x vision_dim); the model owns only the projection
+ gated cross-attention layers."""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28_672,
    vocab_size=128_256,
    head_dim=128,
    rope_theta=500_000.0,
    cross_attn_every=5,
    vision_tokens=1601,
    vision_dim=7680,
)
