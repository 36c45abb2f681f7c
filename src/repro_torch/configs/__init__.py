"""Config registry: ``get_config(arch_id)`` -> ArchConfig.

The port runs the dense decoders so far. The other architectures of the
reference package are named here so that asking for one says which slice of
the port brings it, instead of failing as an unknown name."""
from repro_torch.configs.base import ArchConfig  # noqa: F401
from repro_torch.configs.codeqwen15_7b import CONFIG as CODEQWEN15_7B
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM_2B
from repro_torch.configs.qwen3_32b import CONFIG as QWEN3_32B
from repro_torch.configs.starcoder2_7b import CONFIG as STARCODER2_7B

REGISTRY: dict[str, ArchConfig] = {
    c.name: c for c in [MINICPM_2B, QWEN3_32B, CODEQWEN15_7B, STARCODER2_7B]
}

# Architectures of another family: id -> family. Their layers (state-space,
# mixture-of-experts, hybrid, vision cross-attention, audio encoder) are
# ported with the LM training stack, a later slice (ROADMAP Queue A).
LATER_SLICE: dict[str, str] = {
    "mamba2-2.7b": "ssm", "olmoe-1b-7b": "moe",
    "llama4-maverick-400b-a17b": "moe", "hymba-1.5b": "hybrid",
    "llama-3.2-vision-90b": "vlm", "whisper-large-v3": "audio",
}

ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id in LATER_SLICE:
        raise NotImplementedError(
            f"'{arch_id}' is a {LATER_SLICE[arch_id]} model: the port runs "
            f"the dense family only; the {LATER_SLICE[arch_id]} layers come "
            f"with the LM training-stack slice (ROADMAP Queue A)")
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch '{arch_id}'; known: {sorted(REGISTRY)}")
    return REGISTRY[arch_id]
