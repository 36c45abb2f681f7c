"""Config registry: ``get_config(arch_id)`` -> ArchConfig, for the ten
architectures the reference package names (dense, mixture-of-experts,
state-space, hybrid, vision and audio families)."""
from repro_torch.configs.base import (ALL_CELLS, DECODE_32K, LONG_500K,  # noqa: F401
                                      PREFILL_32K, TRAIN_4K, ArchConfig,
                                      MoEConfig, ShapeCell, SSMConfig,
                                      supported_cells)
from repro_torch.configs.codeqwen15_7b import CONFIG as CODEQWEN15_7B
from repro_torch.configs.hymba_15b import CONFIG as HYMBA_15B
from repro_torch.configs.llama32_vision_90b import CONFIG as LLAMA32_VISION_90B
from repro_torch.configs.llama4_maverick import CONFIG as LLAMA4_MAVERICK
from repro_torch.configs.mamba2_27b import CONFIG as MAMBA2_27B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.olmoe_1b_7b import CONFIG as OLMOE_1B_7B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.starcoder2_7b import CONFIG as STARCODER2_7B
from repro_torch.configs.whisper_large_v3 import CONFIG as WHISPER_LARGE_V3

REGISTRY: dict[str, ArchConfig] = {
    c.name: c
    for c in [MINICPM_2B, QWEN3_32B, CODEQWEN15_7B, STARCODER2_7B, MAMBA2_27B,
              OLMOE_1B_7B, LLAMA4_MAVERICK, HYMBA_15B, LLAMA32_VISION_90B,
              WHISPER_LARGE_V3]
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
