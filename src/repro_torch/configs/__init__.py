"""Architecture configs (one module per ported arch)."""
from repro_torch.configs.base import (  # noqa: F401
    FrontendConfig,
    HybridConfig,
    MLAConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
    ServeConfig,
    get_arch,
    register_arch,
)

_LOADED = False

ARCH_MODULES = ("qwen25_3b", "codeqwen15_7b", "stablelm_12b",
                "granite_moe_3b_a800m", "qwen3_moe_235b_a22b",
                "minicpm3_4b", "paligemma_3b", "whisper_large_v3",
                "recurrentgemma_9b", "mamba2_780m")


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
