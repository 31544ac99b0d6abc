"""SpecConfig: the declarative speculative-decoding knob of one request.

Counterpart of ``repro.spec.config``: a frozen, validating dataclass the
serving stack can hash, log and carry on ``SamplingParams``.  The
resolver half is the :func:`~repro_torch.spec.get_drafter` registry; the
artifact half is :class:`~repro_torch.spec.VerifyOutcome`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Draft lengths are bounded so a bad knob cannot make the engine plan a
# verify launch with an absurd query block (the verify launch scores k + 1
# query rows; plans are cached per ("verify", k, bucket) key).
MAX_DRAFT_LEN = 64


@dataclasses.dataclass(frozen=True)
class SpecConfig:
    """Per-request speculative-decoding knob.

    - ``method``: drafter name in the :func:`~repro_torch.spec.get_drafter`
      registry (``"ngram"`` / ``"prompt_lookup"`` built in).
    - ``k``: draft length, the tokens proposed per verify step.  The
      verify launch scores ``k + 1`` query rows (the committed current
      token plus the k drafts) and emits between 1 and ``k + 1`` tokens.
    - ``max_rejects``: after this many consecutive verify steps with zero
      accepted drafts, the engine stops drafting for the request and
      falls back to plain decode (``None`` = never give up).  Counted in
      ``PlanCacheStats.spec_disabled``.
    """
    method: str = "ngram"
    k: int = 4
    max_rejects: Optional[int] = None

    def __post_init__(self) -> None:
        if not self.method or not isinstance(self.method, str):
            raise ValueError("SpecConfig.method must be a drafter name")
        if not 1 <= int(self.k) <= MAX_DRAFT_LEN:
            raise ValueError(
                f"SpecConfig.k must be in [1, {MAX_DRAFT_LEN}], got {self.k}")
        if self.max_rejects is not None and int(self.max_rejects) < 1:
            raise ValueError(
                f"SpecConfig.max_rejects must be >= 1 or None, "
                f"got {self.max_rejects}")

    def describe(self) -> str:
        mr = "∞" if self.max_rejects is None else str(self.max_rejects)
        return f"spec[{self.method} k={self.k} max_rejects={mr}]"
