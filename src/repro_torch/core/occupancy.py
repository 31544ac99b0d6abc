"""Analytic occupancy / latency model for split-KV decode attention.

Counterpart of ``repro.core.occupancy``: the same three-regime cost model
of a split-KV decode kernel on a machine with ``num_cores`` parallel
execution slots, and the same two constant sets.  Only the default
machine differs: the port runs on one H100, so every function defaults
to ``hw=H100_SXM`` (the reference defaults to ``TPU_V5E``).  Callers that
compare with the reference pass ``hw`` explicitly.

Regimes (the ones the paper's Table 1 / Fig. 3 exhibit):

1. **Launch-bound** (tiny L_K): fixed launch overhead dominates;
   splitting cannot help.
2. **Latency-bound, starved grid** (few tiles, moderate L_K): a single
   work tile walks its KV blocks one after another with memory latency
   exposed; splitting turns chain length into parallel width.
3. **Bandwidth-bound, saturated grid** (many tiles or long L_K): all
   cores busy; splitting only adds combine overhead.

``H100_SXM`` was calibrated against the paper's measured Table 1 (the
L_K = 128 row pins the launch plus one block; the 128 -> 512 slope pins
the per-block latency).  It is a model of the paper's FA3 kernel, not a
measurement of this port's kernels: ``chip_smoke.py --phase table1``
prints the two side by side.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

from repro_torch.core.split_policy import KV_BLOCK, DecodeWorkload


@dataclass(frozen=True)
class HardwareModel:
    name: str
    num_cores: int              # parallel execution slots for one launch
    mxu_flops: float            # peak FLOP/s (bf16)
    hbm_bw: float               # B/s
    ici_bw: float               # B/s per link (mesh-level combine)
    launch_us: float            # fixed kernel dispatch overhead
    block_latency_us: float     # exposed latency per sequential KV block
    tile_fixed_us: float        # per-grid-cell setup
    combine_fixed_us: float     # split-combine fixed cost
    vmem_bytes: int = 64 * 2**20


TPU_V5E = HardwareModel(
    name="tpu_v5e",
    num_cores=8,
    mxu_flops=197e12,
    hbm_bw=819e9,
    ici_bw=50e9,
    launch_us=2.0,
    block_latency_us=1.0,
    tile_fixed_us=0.05,
    combine_fixed_us=0.3,
    vmem_bytes=128 * 2**20,
)

H100_SXM = HardwareModel(
    name="h100_sxm",
    num_cores=132,
    mxu_flops=989e12,
    hbm_bw=3.35e12,
    ici_bw=450e9,
    launch_us=8.40,
    block_latency_us=1.17,
    tile_fixed_us=0.02,
    combine_fixed_us=0.35,
    vmem_bytes=228 * 1024,      # shared memory per SM; unused in the terms
)


def _per_tile_kv_bytes(w: DecodeWorkload, num_splits: int) -> int:
    blocks = math.ceil(w.num_n_blocks / num_splits)
    return blocks * KV_BLOCK * 2 * w.head_dim * w.dtype_bytes  # K and V


def modeled_latency_us(
    w: DecodeWorkload,
    num_splits: int,
    num_cores: Optional[int] = None,
    hw: HardwareModel = H100_SXM,
    pack_gqa: bool = True,
    sm_margin: int = 0,
) -> float:
    """Modeled kernel latency (microseconds) for a given split count.
    ``sm_margin`` reserves cores for the combine stage."""
    cores = (num_cores if num_cores is not None else hw.num_cores) - sm_margin
    cores = max(1, cores)
    s = max(1, min(num_splits, w.num_n_blocks))

    group = max(1, w.num_heads_q // max(1, w.num_heads_kv))
    tiles = w.tiles(s)
    waves = math.ceil(tiles / cores)
    blocks_per_split = math.ceil(w.num_n_blocks / s)

    # per-block service time: latency, hidden by resident tiles, or the
    # bandwidth share of the tiles streaming at once
    block_bytes = KV_BLOCK * 2 * w.head_dim * w.dtype_bytes
    concurrency = min(tiles, cores)
    bw_block_us = block_bytes * concurrency / hw.hbm_bw * 1e6
    resident = tiles / cores
    latency_us = hw.block_latency_us / min(4.0, max(1.0, resident))
    block_us = max(latency_us, bw_block_us)

    # compute term: the GQA-packed group rides one matrix product
    flops_per_block = 2 * 2 * (w.seqlen_q * group) * KV_BLOCK * w.head_dim
    compute_block_us = flops_per_block / hw.mxu_flops * 1e6
    block_us = max(block_us, compute_block_us)

    # pack_gqa=False issues per-head Q loads: extra per-tile fixed cost
    tile_fixed = hw.tile_fixed_us * (1.0 if pack_gqa
                                     else 1.0 + 0.25 * (group - 1))

    t_main = waves * (blocks_per_split * block_us + tile_fixed)

    # combine stage: write s partials (out + lse), then one reduction pass
    t_combine = 0.0
    if s > 1:
        partial_bytes = s * w.batch * w.num_heads_q * (w.head_dim + 1) * 4 * 2
        t_combine = hw.combine_fixed_us + partial_bytes / hw.hbm_bw * 1e6

    return hw.launch_us + t_main + t_combine


def modeled_speedup(w: DecodeWorkload, s_base: int, s_new: int,
                    num_cores: Optional[int] = None,
                    hw: HardwareModel = H100_SXM) -> float:
    t0 = modeled_latency_us(w, s_base, num_cores=num_cores, hw=hw)
    t1 = modeled_latency_us(w, s_new, num_cores=num_cores, hw=hw)
    return t0 / t1


def occupancy_fraction(w: DecodeWorkload, num_splits: int,
                       num_cores: Optional[int] = None,
                       hw: HardwareModel = H100_SXM) -> float:
    """Fraction of cores holding at least one tile."""
    cores = num_cores if num_cores is not None else hw.num_cores
    return min(1.0, w.tiles(num_splits) / cores)
