"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8. [arXiv:2409.02060; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1024,
    vocab_size=50_304,
    qk_norm=True,           # OLMoE uses QK-norm
    moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024, every=1,
                  shared_expert=False, aux_loss_weight=0.01),
)
