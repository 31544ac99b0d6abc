"""Data pipelines (deterministic synthetic LM)."""
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: F401
