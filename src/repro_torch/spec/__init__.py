"""Speculative decoding (counterpart of ``repro.spec``): SpecConfig ->
Drafter -> VerifyOutcome.

- :class:`SpecConfig` is the per-request knob (drafter ``method``, draft
  length ``k``, the ``max_rejects`` give-up threshold), carried on
  ``SamplingParams.speculation`` and validated at submit.
- :class:`Drafter` proposes draft tokens on the host from a slot's
  prompt and emitted tokens.  The built-ins are self-speculative
  (:class:`NGramDrafter`, :class:`PromptLookupDrafter`);
  :func:`register_drafter` adds others under a name.
- :class:`VerifyOutcome` is one slot's accept/reject result of one
  verify launch.

The verify launch is planned like decode: a ``"verify"``
:class:`~repro_torch.plan.AttentionSpec` frozen under ``("verify", k,
bucket)`` keys in the engine's :class:`~repro_torch.plan.PlanCache`.
Everything here is host-side Python; nothing imports torch.
"""
from repro_torch.spec.config import MAX_DRAFT_LEN, SpecConfig  # noqa: F401
from repro_torch.spec.drafter import (  # noqa: F401
    Drafter,
    NGramDrafter,
    PromptLookupDrafter,
    available_drafters,
    get_drafter,
    register_drafter,
)
from repro_torch.spec.outcome import VerifyOutcome  # noqa: F401
