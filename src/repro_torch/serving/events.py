"""Serving events: what :meth:`ServingEngine.step` emits.

Counterpart of ``repro.serving.events``.  Every generated token surfaces
as one :data:`TOKEN` event; a request's last event is a :data:`FINISHED`
event carrying the ``finish_reason`` that ended it:

- ``"eos"``            — the request's ``eos_id`` was sampled.
- ``"stop"``           — a ``SamplingParams.stop`` token was sampled.
- ``"length"``         — the ``max_new_tokens`` budget is exhausted.
- ``"cache_capacity"`` — the slot hit the KV cache's last writable row
  (``max_len - 1``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

TOKEN = "token"
FINISHED = "finished"

FINISH_EOS = "eos"
FINISH_STOP = "stop"
FINISH_LENGTH = "length"
FINISH_CACHE_CAPACITY = "cache_capacity"

FINISH_REASONS = (FINISH_EOS, FINISH_STOP, FINISH_LENGTH,
                  FINISH_CACHE_CAPACITY)


@dataclass(frozen=True)
class Event:
    """One serving event.  ``index`` is the 0-based position of ``token``
    among the request's generated tokens (TOKEN only); ``finish_reason``
    is set on FINISHED only."""
    kind: str                           # TOKEN | FINISHED
    handle: int                         # ServingEngine.submit() handle
    request_id: int
    token: Optional[int] = None
    index: Optional[int] = None
    finish_reason: Optional[str] = None
