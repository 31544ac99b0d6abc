"""The paper's contribution: sequence-aware split-KV scheduling policies.

Counterpart of ``repro.core.split_policy``, for the H100.  Four
policies:

``fa3_baseline``
    The flawed upstream FlashAttention-3 heuristic (``heuristics.h``
    pre-patch): ``num_splits = 1`` whenever ``num_n_blocks <= 4`` (L_K <=
    512 with the 128-wide KV block), however starved the grid is.
    Longer contexts go through the upstream wave-efficiency loop.

``paper``
    The paper's conservative policy (Fig. 2):

    - Guard 1: ``nblk <= 3``                       -> s = 1
    - Guard 2: ``nblk == 4 and tiles >= 4``        -> s = 1
    - Override: ``nblk == 4 and tiles < 4``        -> s = 3
    - longer contexts -> upstream efficiency loop

``tpu_adaptive``
    The reference's beyond-paper policy: the argmin of the occupancy cost
    model over every feasible split, moving to a larger split only for a
    modeled win of more than 2%.  The port reads the model at
    ``hw=H100_SXM`` (the reference at ``TPU_V5E``); pass ``hw`` to
    compare.  Kept as the reference has it: it can stop below
    ``fa3_baseline``'s split and model slower (ROADMAP Queue 3).

``measured``
    Decides from a calibrated :class:`~repro_torch.tune.SplitTable`
    (nearest L_K bucket in the workload's exact family), injected at
    :class:`~repro_torch.plan.Planner` construction.  Shapes the table
    does not cover fall back to ``paper``, counted.  Marked
    ``needs_table``, so :func:`analytic_policies` leaves it out.

On the card a split count is a count of CTAs spread over the SMs, so
``num_cores`` is the SM count: 132 on an H100 SXM, or what the serving
engine reads from ``torch.cuda.get_device_properties``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional

# KV block width: FA3 Hopper's kBlockN for decode head_dim=128, and the
# block the decode kernel's split bounds are counted in.
KV_BLOCK = 128

# Streaming multiprocessors of one H100 SXM.
DEFAULT_NUM_CORES = 132
MAX_SPLITS = 128

# Bytes per KV-cache element, by dtype name.
KV_DTYPES: Dict[str, int] = {
    "bfloat16": 2,
    "float32": 4,
    "int8": 1,
    "fp8": 1,        # float8_e4m3fn storage, f32 scales
}

_BYTES_TO_NAME: Dict[int, str] = {2: "bfloat16", 4: "float32", 1: "int8"}


@dataclass(frozen=True)
class DecodeWorkload:
    """Shape tuple of one decode-attention launch: the paper's
    (Batch, L_Q, L_K, H_Q, H_KV, D)."""
    batch: int
    seqlen_q: int          # 1 for pure decode
    seqlen_k: int          # KV cache length (L_K)
    num_heads_q: int
    num_heads_kv: int
    head_dim: int = 128
    dtype_bytes: int = 2   # bf16
    # KV dtype name (a KV_DTYPES key); None = inferred from dtype_bytes
    kv_dtype: Optional[str] = None

    def __post_init__(self) -> None:
        if self.kv_dtype is None:
            object.__setattr__(self, "kv_dtype",
                               _BYTES_TO_NAME.get(self.dtype_bytes))
            return
        if self.kv_dtype not in KV_DTYPES:
            raise ValueError(
                f"unknown kv_dtype {self.kv_dtype!r}; "
                f"known: {sorted(KV_DTYPES)}")
        if KV_DTYPES[self.kv_dtype] != self.dtype_bytes:
            raise ValueError(
                f"kv_dtype={self.kv_dtype!r} is "
                f"{KV_DTYPES[self.kv_dtype]} byte(s)/element but "
                f"dtype_bytes={self.dtype_bytes}")

    @property
    def kv_dtype_name(self) -> str:
        if self.kv_dtype is not None:
            return self.kv_dtype
        return f"bytes{self.dtype_bytes}"

    @property
    def num_n_blocks(self) -> int:
        """Sequence blocks: the ``nblk`` of the paper."""
        return max(1, math.ceil(self.seqlen_k / KV_BLOCK))

    @property
    def num_m_blocks(self) -> int:
        """M-blocks per (batch, kv-head): 1 for decode, the G query
        heads of one KV head share one 128-row block."""
        group = max(1, self.num_heads_q // max(1, self.num_heads_kv))
        return max(1, math.ceil(self.seqlen_q * group / 128))

    @property
    def total_mblocks(self) -> int:
        """Work tiles before splitting (paper: Batch x H_KV for decode)."""
        return self.batch * self.num_heads_kv * self.num_m_blocks

    def tiles(self, num_splits: int) -> int:
        return self.total_mblocks * num_splits


def _upstream_efficiency_loop(w: DecodeWorkload, num_cores: int,
                              max_splits: int = MAX_SPLITS) -> int:
    """FA3's ``num_splits_heuristic``: the smallest ``s`` whose wave
    efficiency is within 85% of the best, skipping split counts that do
    not reduce the per-split block count."""
    tiles_1 = w.tiles(1)
    if tiles_1 >= 0.8 * num_cores:
        return 1
    max_splits = min(max_splits, w.num_n_blocks, num_cores)
    if max_splits <= 1:
        return 1

    def efficiency(s: int) -> float:
        n_waves = w.tiles(s) / num_cores
        return n_waves / math.ceil(n_waves) if n_waves > 0 else 0.0

    best_eff = max(efficiency(s) for s in range(1, max_splits + 1))
    for s in range(1, max_splits + 1):
        if s > 1 and math.ceil(w.num_n_blocks / s) == \
                math.ceil(w.num_n_blocks / (s - 1)):
            continue
        if efficiency(s) >= 0.85 * best_eff:
            return s
    return 1


def fa3_baseline(w: DecodeWorkload, num_cores: int = DEFAULT_NUM_CORES) -> int:
    """The flawed upstream heuristic: ``if (num_n_blocks <= 4) return 1;``."""
    if w.num_n_blocks <= 4:
        return 1
    return _upstream_efficiency_loop(w, num_cores)


def paper_policy(w: DecodeWorkload, num_cores: int = DEFAULT_NUM_CORES) -> int:
    """Paper Fig. 2: the conservative sequence-aware policy."""
    if w.num_n_blocks <= 3:
        return 1
    if w.num_n_blocks <= 4 and w.total_mblocks >= 4:
        return 1
    if w.num_n_blocks == 4 and w.total_mblocks < 4:
        return 3
    return _upstream_efficiency_loop(w, num_cores)


def tpu_adaptive(w: DecodeWorkload, num_cores: int = DEFAULT_NUM_CORES,
                 hw=None) -> int:
    """The occupancy cost model's argmin over the feasible splits, ties
    and wins of 2% or less going to the smaller split.  ``hw`` is the
    model's machine (``None``: ``H100_SXM``)."""
    from repro_torch.core.occupancy import H100_SXM, modeled_latency_us
    hw = H100_SXM if hw is None else hw
    max_s = min(w.num_n_blocks, num_cores, MAX_SPLITS)
    if max_s <= 1 or w.tiles(1) >= num_cores:
        return 1
    best_s, best_t = 1, modeled_latency_us(w, 1, num_cores=num_cores, hw=hw)
    for s in range(2, max_s + 1):
        if math.ceil(w.num_n_blocks / s) == \
                math.ceil(w.num_n_blocks / (s - 1)):
            continue
        t = modeled_latency_us(w, s, num_cores=num_cores, hw=hw)
        if t < best_t * 0.98:
            best_s, best_t = s, t
    return best_s


def measured(w: DecodeWorkload, num_cores: int = DEFAULT_NUM_CORES,
             table=None, impl: Optional[str] = None) -> int:
    """Decide from a calibrated ``SplitTable`` (``impl`` names its table
    family; ``None`` is the port's own).  A bare ``choose_num_splits(...,
    policy="measured")`` must pass the table."""
    if table is None:
        raise ValueError(
            "split policy 'measured' decides from a repro_torch.tune "
            "SplitTable; pass Planner(policy='measured', "
            "table=SplitTable.load(path)) (serving: "
            "ServeConfig.tune_table_path / serve --tune-table; calibrate "
            "one with `python -m repro_torch.launch.tune`)")
    s, _tuned = table.choose(w, impl=impl, num_cores=num_cores)
    return s


measured.needs_table = True       # left out of analytic_policies()
measured.fallback = "paper"       # uncovered shapes, the inline path


POLICIES: Dict[str, Callable[..., int]] = {
    "fa3_baseline": fa3_baseline,
    "paper": paper_policy,
    "tpu_adaptive": tpu_adaptive,
    "measured": measured,
}


def available_policies() -> list:
    return sorted(POLICIES)


def analytic_policies() -> list:
    """The policies that decide from the workload alone (no table)."""
    return sorted(n for n, fn in POLICIES.items()
                  if not getattr(fn, "needs_table", False))


def get_policy(name: str) -> Callable[..., int]:
    if name not in POLICIES:
        raise KeyError(f"unknown split policy {name!r}; known: "
                       f"{available_policies()}")
    return POLICIES[name]


def choose_num_splits(w: DecodeWorkload, policy: str = "paper",
                      num_cores: int = DEFAULT_NUM_CORES,
                      table=None, impl: Optional[str] = None) -> int:
    fn = get_policy(policy)
    kw = {"table": table, "impl": impl} \
        if getattr(fn, "needs_table", False) else {}
    s = fn(w, num_cores=num_cores, **kw)
    return max(1, min(int(s), w.num_n_blocks))


# ---------------------------------------------------------------------------
# Mesh-level variant: the same decision, lifted to devices on a mesh axis
# ---------------------------------------------------------------------------


def choose_mesh_splits(w: DecodeWorkload, chips_on_axis: int,
                       policy: str = "tpu_adaptive", table=None,
                       impl: Optional[str] = None) -> int:
    """How many ways to sequence-shard the KV cache over the devices of a
    mesh axis: the policy's split decision with the axis's devices in
    place of SMs (when the ``B x H_KV`` tiles are fewer than the devices,
    sequence-sharding recovers the idle ones), rounded down to a divisor
    of ``chips_on_axis`` so every device holds an equal chunk."""
    s = choose_num_splits(w, policy=policy, num_cores=chips_on_axis,
                          table=table, impl=impl)
    for d in range(min(s, chips_on_axis), 0, -1):
        if chips_on_axis % d == 0:
            return d
    return 1
