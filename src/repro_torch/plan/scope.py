"""plan_scope: the one ambient plan stack.

Counterpart of ``repro.plan.scope``.  A caller pushes one
:class:`~repro_torch.plan.LaunchPlan`; every attention op called inside
the scope reads it back filtered by launch kind, so a decode plan never
reaches a prefill launch and the reverse.  The engine passes its plans
explicitly; the scope serves callers that cannot (a model's forward
called from outside the engine) and the internal-heuristic A/B.
"""
from __future__ import annotations

import contextlib
from typing import List, Optional

from repro_torch.plan.plan import LaunchPlan

_SCOPE: List[Optional[LaunchPlan]] = [None]


@contextlib.contextmanager
def plan_scope(plan: Optional[LaunchPlan]):
    """Make ``plan`` the ambient launch plan for ops called inside.
    ``plan=None`` pushes an empty scope, shadowing any outer plan."""
    _SCOPE.append(plan)
    try:
        yield plan
    finally:
        _SCOPE.pop()


def current_plan(kind: Optional[str] = None) -> Optional[LaunchPlan]:
    """The innermost ambient plan, filtered by launch-kind family:
    ``kind="prefill"`` returns only prefill plans, any other kind only
    plans of the decode family; ``kind=None`` returns the top."""
    plan = _SCOPE[-1]
    if plan is None or kind is None:
        return plan
    if (plan.kind == "prefill") != (kind == "prefill"):
        return None
    return plan
