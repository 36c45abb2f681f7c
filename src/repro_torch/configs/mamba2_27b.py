"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, ssm_state=128,
SSD (state-space duality). [arXiv:2405.21060]

d_inner = 2*2560 = 5120; head_dim 64 -> 80 SSD heads. Runs long_500k
(O(1)-state decode)."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-2.7b",
    family="ssm",
    n_layers=64,
    d_model=2560,
    n_heads=80,            # SSD heads = d_inner / head_dim
    n_kv_heads=80,
    d_ff=0,                # attention-free, no separate MLP block (mamba2 arch)
    vocab_size=50_280,
    ssm=SSMConfig(d_state=128, head_dim=64, expand=2, n_groups=1, d_conv=4,
                  chunk=128),
    sub_quadratic=True,
    tie_embeddings=True,
)
