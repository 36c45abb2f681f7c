"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16, parallel attention + mamba heads in every layer.
[arXiv:2411.13676; hf]

Runs long_500k: the SSM half carries long-range state; the attention half
uses a sliding window (Hymba's global+local scheme) so decode stays
sub-quadratic."""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab_size=32_001,
    head_dim=64,
    hybrid=True,
    ssm=SSMConfig(d_state=16, head_dim=64, expand=2, n_groups=1, d_conv=4,
                  chunk=128),
    sub_quadratic=True,
)
