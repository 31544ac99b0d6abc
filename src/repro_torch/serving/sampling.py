"""Token sampling for the serving engine.

Counterpart of ``repro.serving.sampling``: :class:`SamplingParams` is the
per-request knob set; a :class:`Sampler` turns a batch of logits into a
batch of tokens.  Only :class:`GreedySampler` is ported so far, and, as
in the reference, it rejects at submit any request that asks for
sampling it would ignore.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling knobs.  ``temperature == 0`` is greedy;
    ``top_k == 0`` and ``top_p == 1.0`` disable the truncations.  ``stop``
    tokens end the request with ``finish_reason="stop"`` (the stop token
    itself is emitted)."""
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, "
                             f"got {self.temperature}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")


GREEDY = SamplingParams()


class Sampler:
    """Base sampler: ``check`` at submit, ``sample`` per launch."""

    def check(self, sp: SamplingParams) -> None:
        """Reject params this sampler would silently ignore."""

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        """logits (B, V) -> tokens (B,) int64."""
        raise NotImplementedError


class GreedySampler(Sampler):
    """Argmax; ties go to the lowest index, as ``jnp.argmax`` does."""

    def sample(self, logits: torch.Tensor) -> torch.Tensor:
        return torch.argmax(logits, dim=-1)

    def check(self, sp: SamplingParams) -> None:
        if sp.temperature > 0 or sp.top_k > 0 or sp.top_p < 1.0:
            raise ValueError(
                "GreedySampler ignores temperature/top_k/top_p, and the "
                f"port has no other sampler yet; got {sp}")
