"""whisper-large-v3 [audio] — enc-dec, 32L(+32 enc) d_model=1280 20H (kv=20)
d_ff=5120 vocab=51866, conv frontend a stub (the batch supplies precomputed
frame embeddings, 1500 frames). [arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3",
    family="audio",
    n_layers=32,            # decoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab_size=51_866,
    mlp="gelu",
    norm="layernorm",
    attn_bias=True,
    enc_layers=32,
    audio_frames=1500,
)
