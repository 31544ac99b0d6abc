"""Architecture configs (one module per ported arch)."""
from repro_torch.configs.base import (  # noqa: F401
    ModelConfig,
    ServeConfig,
    get_arch,
    register_arch,
)

_LOADED = False

ARCH_MODULES = ("qwen25_3b",)


def _load_all() -> None:
    global _LOADED
    if _LOADED:
        return
    import importlib
    for mod in ARCH_MODULES:
        importlib.import_module(f"repro_torch.configs.{mod}")
    _LOADED = True
