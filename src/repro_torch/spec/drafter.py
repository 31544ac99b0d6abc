"""Drafters: the resolver half of ``repro_torch.spec``.

Counterpart of ``repro.spec.drafter``.  A :class:`Drafter` turns a
slot's token history (prompt plus everything emitted so far) into up to
``k`` draft tokens, which the engine scores in one planned verify launch
and accepts or rejects as a batch.

The built-ins are self-speculative: they copy continuations out of the
request's own history, so they cost no model FLOPs and no weights.
``propose`` receives the whole history and may return fewer than ``k``
tokens, or none, so a draft-model backend fits the same contract under a
name of its own (:func:`register_drafter`).
"""
from __future__ import annotations

from typing import Dict, List, Sequence, Type


class Drafter:
    """Base drafter: propose up to ``k`` draft tokens from a history.

    The engine makes one instance per admitted request, so a backend can
    keep per-request state across calls.  ``propose`` runs on the host
    inside the engine's step loop and must be cheap.
    """

    #: registry name (set by ``register_drafter``)
    name: str = "base"

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        """Return 0..k draft tokens continuing ``history`` (the prompt
        followed by every emitted token).  ``[]`` skips speculation for
        this step: the slot rides the verify launch as a 1-token row."""
        raise NotImplementedError

    def observe(self, accepted: int, proposed: int) -> None:
        """Feedback after each verify step (accepted of proposed).  The
        built-ins ignore it.  Must not raise."""


class NGramDrafter(Drafter):
    """Self-speculative n-gram continuation over the whole history: the
    trailing ``n - 1``-gram is matched against earlier occurrences, most
    recent first, and the tokens that followed the match are proposed."""

    name = "ngram"

    def __init__(self, n: int = 3) -> None:
        if n < 2:
            raise ValueError(f"NGramDrafter needs n >= 2, got {n}")
        self.n = int(n)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        m = self.n - 1
        if len(h) <= m:
            return []
        key = tuple(h[-m:])
        # most recent earlier occurrence of the trailing (n-1)-gram
        for start in range(len(h) - m - 1, -1, -1):
            if tuple(h[start:start + m]) == key:
                return h[start + m:start + m + k]
        return []


class PromptLookupDrafter(Drafter):
    """Prompt-lookup decoding: trailing n-grams from ``max_ngram`` down
    to ``min_ngram`` are matched against the history, and the most recent
    match's continuation is proposed."""

    name = "prompt_lookup"

    def __init__(self, min_ngram: int = 1, max_ngram: int = 4) -> None:
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError("need 1 <= min_ngram <= max_ngram")
        self.min_ngram = int(min_ngram)
        self.max_ngram = int(max_ngram)

    def propose(self, history: Sequence[int], k: int) -> List[int]:
        h = list(history)
        for m in range(min(self.max_ngram, len(h) - 1),
                       self.min_ngram - 1, -1):
            key = tuple(h[-m:])
            for start in range(len(h) - m - 1, -1, -1):
                if tuple(h[start:start + m]) == key:
                    cont = h[start + m:start + m + k]
                    if cont:
                        return cont
        return []


_DRAFTERS: Dict[str, Type[Drafter]] = {}


def register_drafter(name: str, cls: Type[Drafter]) -> None:
    """Register a drafter class under ``name`` (``SpecConfig.method``
    selects by this name)."""
    cls.name = name
    _DRAFTERS[name] = cls


def get_drafter(name: str) -> Type[Drafter]:
    if name not in _DRAFTERS:
        raise KeyError(
            f"unknown drafter {name!r}; have {sorted(_DRAFTERS)}")
    return _DRAFTERS[name]


def available_drafters() -> List[str]:
    return sorted(_DRAFTERS)


register_drafter("ngram", NGramDrafter)
register_drafter("prompt_lookup", PromptLookupDrafter)
