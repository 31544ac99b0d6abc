"""TuneSpec: the declarative input to the calibrator.

Counterpart of ``repro.tune.spec``.  A spec says WHAT is measured: the
workload grid (L_K buckets x head shapes x batch x impl family x dtype),
the candidate split set and the timing budget.  HOW it is timed is the
:class:`~repro_torch.tune.Calibrator`'s business.

Two grids:

- :data:`REFERENCE_SPEC` is the reference's grid, field for field: the
  reduced-config serving shapes (H_Q 4 over one KV head, head dims 8 /
  16 / 32) and the paper's Table 1 rows, bf16 and int8, family ``xla``,
  8 cores.  Calibrated in modeled mode at ``TPU_V5E`` it reproduces the
  reference's committed table (a parity fixture, not a measurement).
- :data:`H100_SPEC` is the port's own grid for the card: the head shapes
  of the served configs (qwen2.5-3b 16/2, codeqwen1.5-7b 32/32,
  stablelm-12b 32/8 at head dim 160), the paper's Table 1 at H_KV 1 and
  2 (64/1, 64/2), the reference grid's 32/4 and the serving CLI's
  reduced qwen2.5-3b (4/1 at head dim 128), at batches 1, 2, 4 and 8,
  L_K 128 to 4096, in bf16 and int8, family ``cuda``, 132 SMs.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

from repro_torch.core.split_policy import (
    DEFAULT_NUM_CORES,
    KV_BLOCK,
    KV_DTYPES,
    MAX_SPLITS,
    DecodeWorkload,
)

# bytes per cache element, by calibration dtype name (KV_DTYPES under
# the reference's tune-facing name); int8 and fp8 are both 1 byte and
# keyed apart by name in the table
DTYPE_BYTES = dict(KV_DTYPES)


@dataclass(frozen=True)
class TuneSpec:
    """One calibration run, declaratively.  The grid defaults are the
    reference's; ``num_cores`` defaults to the H100's 132 SMs."""
    # multiples of KV_BLOCK: the decision is lossless within a block
    lk_buckets: Tuple[int, ...] = (128, 256, 384, 512, 640, 1024, 4096)
    batches: Tuple[int, ...] = (1, 2, 4, 8)
    # (num_heads_q, num_heads_kv, head_dim)
    head_shapes: Tuple[Tuple[int, int, int], ...] = (
        (4, 1, 8), (4, 1, 16), (4, 1, 32),
        (64, 1, 128), (16, 2, 128), (32, 4, 128),
    )
    impls: Tuple[str, ...] = ("xla",)
    dtypes: Tuple[str, ...] = ("bfloat16", "int8")
    # explicit candidate split counts; None = every feasible split
    # (1..min(nblk, num_cores), skipping counts that do not refine the
    # partitioning, as the efficiency loop does)
    candidates: Optional[Tuple[int, ...]] = None
    num_cores: int = DEFAULT_NUM_CORES
    # per-candidate timed repeats after ``warmup`` untimed ones; past
    # ``budget_s`` of wall time the remaining cells are modeled
    repeats: int = 5
    warmup: int = 2
    budget_s: Optional[float] = None

    def __post_init__(self):
        for lk in self.lk_buckets:
            if lk % KV_BLOCK:
                raise ValueError(
                    f"lk_buckets must be multiples of KV_BLOCK "
                    f"({KV_BLOCK}); got {lk}")
        for d in self.dtypes:
            if d not in DTYPE_BYTES:
                raise ValueError(f"unknown dtype {d!r}; "
                                 f"known: {sorted(DTYPE_BYTES)}")
        if self.repeats < 1 or self.warmup < 0:
            raise ValueError("repeats must be >= 1 and warmup >= 0")

    def workloads(self) -> Iterator[Tuple[DecodeWorkload, str]]:
        """Every (workload, impl) cell of the grid, in a fixed order (the
        calibrator's per-cell seeds index into it)."""
        for impl in self.impls:
            for dtype in self.dtypes:
                for hq, hkv, hd in self.head_shapes:
                    for b in self.batches:
                        for lk in self.lk_buckets:
                            yield DecodeWorkload(
                                b, 1, lk, hq, hkv, hd,
                                dtype_bytes=DTYPE_BYTES[dtype],
                                kv_dtype=dtype), impl

    def candidate_splits(self, w: DecodeWorkload) -> Tuple[int, ...]:
        """The feasible candidates of one workload (always holding 1,
        deduplicated, clamped to the block count)."""
        cap = min(w.num_n_blocks, self.num_cores, MAX_SPLITS)
        if self.candidates is not None:
            cands = sorted({max(1, min(s, w.num_n_blocks))
                            for s in self.candidates})
            return tuple(cands) if 1 in cands else (1, *cands)
        out = [1]
        for s in range(2, cap + 1):
            if math.ceil(w.num_n_blocks / s) == \
                    math.ceil(w.num_n_blocks / (s - 1)):
                continue
            out.append(s)
        return tuple(out)

    def grid_size(self) -> int:
        return sum(1 for _ in self.workloads())

    def describe(self) -> dict:
        """JSON-safe summary persisted into the table."""
        return {
            "lk_buckets": list(self.lk_buckets),
            "batches": list(self.batches),
            "head_shapes": [list(h) for h in self.head_shapes],
            "impls": list(self.impls),
            "dtypes": list(self.dtypes),
            "candidates": (None if self.candidates is None
                           else list(self.candidates)),
            "num_cores": self.num_cores,
            "repeats": self.repeats,
            "warmup": self.warmup,
            "budget_s": self.budget_s,
        }

    def replace(self, **kw) -> "TuneSpec":
        return dataclasses.replace(self, **kw)


# the reference's grid (its TuneSpec() at its 8 cores)
REFERENCE_SPEC = TuneSpec(num_cores=8)

# the port's grid on one H100
H100_SPEC = TuneSpec(
    lk_buckets=(128, 256, 384, 512, 640, 1024, 2048, 4096),
    batches=(1, 2, 4, 8),
    head_shapes=((16, 2, 128), (32, 32, 128), (32, 8, 160),
                 (64, 1, 128), (64, 2, 128), (32, 4, 128), (4, 1, 128)),
    impls=("cuda",),
    dtypes=("bfloat16", "int8"),
    num_cores=DEFAULT_NUM_CORES,
)
