"""ShardSpec: the declarative mesh-native serving topology.

Counterpart of ``repro.shard.spec``, with the same fields and messages.
The spec is pure data: how many data-parallel slot shards (``dp``), how
many devices each shard sequence-shards its KV cache over (``sp``), how
many decode slots and KV pages each shard owns, and how params land on a
shard's devices.  Resolution (the device grid, divisibility against a
concrete cache layout) is the :class:`~repro_torch.shard.ShardResolver`'s
job, as ``CacheSpec`` -> ``CacheManager``.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, replace
from typing import Any, Dict, Optional

PARAM_POLICIES = ("replicated", "tp")


@dataclass(frozen=True)
class ShardSpec:
    """A ``dp x sp`` serving topology over ``dp * sp`` devices.

    ``dp`` slot shards each run an independent request lifecycle
    (scheduler, cache manager, page budget) over ``slots_per_shard``
    lockstep decode slots; within a shard, ``sp`` devices sequence-shard
    the KV cache's L dim: the paper's split-KV decision lifted to the
    mesh, with devices in place of SMs.
    """
    dp: int = 1                     # data-parallel slot shards
    sp: int = 1                     # sequence-shard width per shard
    slots_per_shard: int = 4        # decode slots per dp shard
    # paged layout only: each shard's page pool is budgeted separately
    # (None = the ServeConfig's engine-wide budget, per shard)
    page_budget_per_shard: Optional[int] = None
    params: str = "replicated"      # "replicated" | "tp" (model axis)

    def __post_init__(self):
        if self.dp < 1 or self.sp < 1:
            raise ValueError(
                f"shard topology axes must be >= 1, got dp={self.dp}, "
                f"sp={self.sp}")
        if self.slots_per_shard < 1:
            raise ValueError(
                f"slots_per_shard must be >= 1, got "
                f"{self.slots_per_shard}")
        if self.page_budget_per_shard is not None \
                and self.page_budget_per_shard < 1:
            raise ValueError(
                f"page_budget_per_shard must be >= 1 (or None), got "
                f"{self.page_budget_per_shard}")
        if self.params not in PARAM_POLICIES:
            raise ValueError(
                f"unknown params policy {self.params!r}; known: "
                f"{PARAM_POLICIES}")

    # --- derived ------------------------------------------------------------

    @property
    def num_devices(self) -> int:
        return self.dp * self.sp

    @property
    def total_slots(self) -> int:
        """Aggregate decode slots across all dp shards (dp=4 serves 4x
        the slots)."""
        return self.dp * self.slots_per_shard

    @property
    def fingerprint(self) -> str:
        """Stable topology identity: keys the per-topology PlanCache
        registry and stamps the stats dump."""
        canon = json.dumps(
            {"dp": self.dp, "sp": self.sp,
             "slots_per_shard": self.slots_per_shard,
             "page_budget_per_shard": self.page_budget_per_shard,
             "params": self.params},
            sort_keys=True)
        return "shard." + hashlib.sha256(canon.encode()).hexdigest()[:12]

    def describe(self) -> Dict[str, Any]:
        return {
            "dp": self.dp, "sp": self.sp,
            "slots_per_shard": self.slots_per_shard,
            "total_slots": self.total_slots,
            "num_devices": self.num_devices,
            "page_budget_per_shard": self.page_budget_per_shard,
            "params": self.params,
            "fingerprint": self.fingerprint,
        }

    # --- parsing ------------------------------------------------------------

    @classmethod
    def parse(cls, text: str, **overrides: Any) -> "ShardSpec":
        """Parse the CLI/config form: ``"4,2"`` (dp,sp positional) or
        ``"dp=4,sp=2"`` (named, any subset).  ``overrides`` win over
        the parsed fields."""
        fields: Dict[str, Any] = {}
        parts = [p.strip() for p in str(text).split(",") if p.strip()]
        if not parts:
            raise ValueError(f"empty shard topology string {text!r}")
        if any("=" in p for p in parts):
            for p in parts:
                if "=" not in p:
                    raise ValueError(
                        f"mixed positional/named shard topology {text!r}"
                        " — use 'dp,sp' or 'dp=...,sp=...'")
                k, v = (s.strip() for s in p.split("=", 1))
                if k not in ("dp", "sp", "slots_per_shard",
                             "page_budget_per_shard"):
                    raise ValueError(
                        f"unknown shard topology field {k!r} in {text!r}")
                fields[k] = int(v)
        else:
            if len(parts) > 2:
                raise ValueError(
                    f"positional shard topology takes 'dp' or 'dp,sp', "
                    f"got {text!r}")
            fields["dp"] = int(parts[0])
            if len(parts) == 2:
                fields["sp"] = int(parts[1])
        fields.update(overrides)
        return cls(**fields)

    def with_(self, **changes: Any) -> "ShardSpec":
        return replace(self, **changes)
