"""VerifyOutcome: one slot's result of one verify launch.

Counterpart of ``repro.spec.outcome``: what was proposed, what survived
accept/reject, and what the engine emitted.  The engine aggregates these
counts into ``PlanCacheStats`` (acceptance rate, tokens per step).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VerifyOutcome:
    """Result of one verify step for one slot.

    - ``slot``: batch slot index.
    - ``proposed``: draft tokens scored this step (0 for a slot that rode
      the launch without drafts).
    - ``accepted``: drafts that survived accept/reject, already clamped
      to ``proposed``.
    - ``emitted``: the accepted drafts plus the correction or bonus token
      sampled at the first non-accepted row.  ``len(emitted) == accepted
      + 1`` unless the request finished mid-commit (eos, stop, length).
    """
    slot: int
    proposed: int
    accepted: int
    emitted: Tuple[int, ...]

    def __post_init__(self) -> None:
        if not 0 <= self.accepted <= self.proposed:
            raise ValueError(
                f"accepted ({self.accepted}) must be in "
                f"[0, proposed={self.proposed}]")

    @property
    def tokens_gained(self) -> int:
        """Tokens beyond what a plain decode step would have emitted."""
        return max(0, len(self.emitted) - 1)
