"""Models (counterpart of ``repro.models``): the dense family."""
from repro_torch.models.registry import Model, build_model  # noqa: F401
