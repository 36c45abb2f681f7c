"""llama4-maverick-400b-a17b [moe] — 48L d_model=5120 40H (GQA kv=8)
d_ff=8192 (per expert), vocab=202048, MoE 128 experts top-1 with shared
expert, MoE every 2nd layer (interleaved dense d_ff=4*8192/2) — yields
~400B total / ~17B active. [hf:meta-llama/Llama-4-*]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=16_384,            # dense (non-MoE) interleaved layers
    vocab_size=202_048,
    head_dim=128,
    qk_norm=True,
    rope_theta=500_000.0,
    moe=MoEConfig(n_experts=128, top_k=1, d_ff_expert=8192, every=2,
                  shared_expert=True, aux_loss_weight=0.001),
)
