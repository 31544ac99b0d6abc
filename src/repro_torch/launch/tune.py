"""Autotuning launcher: ``python -m repro_torch.launch.tune ...``

Counterpart of ``repro.launch.tune``.  Calibrates a
:class:`~repro_torch.tune.TuneSpec` grid through the
:class:`~repro_torch.tune.Calibrator` and writes the
:class:`~repro_torch.tune.SplitTable` JSON, which
``Planner(policy="measured")`` and ``serve --tune-table`` read.  It runs
on the card unless ``--device cpu`` is given.

    # the port's grid on the card, into the H100 registry
    python -m repro_torch.launch.tune --h100 \\
        --out experiments/tune/h100/h100_sxm.json

    # the reference's grid, modeled at TPU_V5E: reproduces the
    # reference's experiments/tune/reference_reduced.json (a parity
    # fixture, not a measurement), written to build/tune/
    python -m repro_torch.launch.tune --reference

    # a custom grid by wall clock, merged into an existing table
    python -m repro_torch.launch.tune --mode wallclock --lk 512 \\
        --heads 64:1:128 --merge t.json --out t.json

Each table's fingerprint names the device (``nvidia-smi``'s name and
power limit on the card), CUDA, torch, the mode, ``num_cores``, the seed
and its sources.
"""
from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import Optional, Tuple

from repro_torch.core.occupancy import TPU_V5E
from repro_torch.core.split_policy import available_policies
from repro_torch.tune import (
    H100_SPEC,
    H100_TABLE_DIR,
    REFERENCE_SPEC,
    Calibrator,
    SplitTable,
    TuneSpec,
)


# --reference writes here, never over the reference's own table
REFERENCE_OUT = H100_TABLE_DIR.parents[2] / "build" / "tune" / \
    "reference_reduced.json"


def _parse_heads(items) -> Tuple[Tuple[int, int, int], ...]:
    out = []
    for it in items:
        try:
            hq, hkv, hd = (int(x) for x in it.split(":"))
        except ValueError:
            raise SystemExit(f"--heads wants HQ:HKV:HEAD_DIM, got {it!r}")
        out.append((hq, hkv, hd))
    return tuple(out)


def run_tune(spec: TuneSpec, *, mode: str = "auto", seed: int = 0,
             out: Path, merge: Optional[Path] = None, hw=None, device=None,
             log_fn=print) -> SplitTable:
    """Calibrate ``spec``, merge into ``merge`` if given, write ``out``
    and log the reference's summary lines; returns the table."""
    log_fn(f"calibrating {spec.grid_size()} grid cells "
           f"(mode={mode}, repeats={spec.repeats}, seed={seed}) ...")
    t0 = time.perf_counter()
    table = Calibrator(spec, mode=mode, seed=seed, hw=hw,
                       device=device).calibrate()
    log_fn(f"calibrated in {time.perf_counter() - t0:.1f} s")
    if merge is not None:
        base = SplitTable.load(merge)
        log_fn(f"merging into {merge} ({len(base)} cells, "
               f"version {base.version})")
        table = base.merge(table)
        table.validate()
    path = table.save(out)
    d = table.describe()
    log_fn(f"wrote {path}: {d['cells']} cells / {d['families']} shape "
           f"families, version {d['version']}")
    log_fn(f"fingerprint: {table.fingerprint}")
    by_split: dict = {}
    for e in table.entries:
        by_split[e["best_split"]] = by_split.get(e["best_split"], 0) + 1
    log_fn("decision histogram (num_splits -> cells): "
           f"{dict(sorted(by_split.items()))}")
    log_fn(f"serve from it: python -m repro_torch.launch.serve --arch "
           f"qwen2.5-3b --policy measured --tune-table {path}")
    return table


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
        epilog=f"registered split policies: {available_policies()} "
               "(this tool feeds the 'measured' backend)")
    grid = ap.add_mutually_exclusive_group()
    grid.add_argument("--reference", action="store_true",
                      help="calibrate the reference's grid in modeled mode "
                           "at TPU_V5E, seed 0: reproduces the reference's "
                           "committed table")
    grid.add_argument("--h100", action="store_true",
                      help="calibrate the port's H100 grid (H100_SPEC)")
    ap.add_argument("--out", type=Path, default=None,
                    help="output table path (default: "
                         f"{H100_TABLE_DIR}/split_table.json)")
    ap.add_argument("--merge", type=Path, default=None,
                    help="existing table to merge the new cells into "
                         "(new cells win; schema must match)")
    ap.add_argument("--mode", default="auto",
                    choices=("auto", "wallclock", "modeled"),
                    help="timing mode: wallclock on the card, modeled = the "
                         "occupancy cost model (auto: modeled on a CPU "
                         "device)")
    ap.add_argument("--lk", type=int, nargs="+", default=None,
                    help="L_K grid (multiples of 128)")
    ap.add_argument("--batches", type=int, nargs="+", default=None)
    ap.add_argument("--heads", nargs="+", default=None,
                    metavar="HQ:HKV:HEAD_DIM",
                    help="head shapes, e.g. 64:1:128 16:2:128")
    ap.add_argument("--impl", nargs="+", default=None,
                    help="table family labels to write (default: the "
                         "grid's; the port's own is 'cuda')")
    ap.add_argument("--candidates", type=int, nargs="+", default=None,
                    help="explicit candidate split counts "
                         "(default: every feasible split)")
    ap.add_argument("--num-cores", type=int, default=None,
                    help="SMs the grid and the modeled mode target")
    ap.add_argument("--repeats", type=int, default=None,
                    help="timed repeats per candidate (median taken)")
    ap.add_argument("--warmup", type=int, default=None,
                    help="untimed repeats before them")
    ap.add_argument("--budget-s", type=float, default=None,
                    help="wall-clock cap; past it, the remaining cells are "
                         "modeled")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' "
                         "times the plain PyTorch path or models)")
    args = ap.parse_args(argv)

    over = {k: v for k, v in dict(
        lk_buckets=tuple(args.lk) if args.lk else None,
        batches=tuple(args.batches) if args.batches else None,
        head_shapes=_parse_heads(args.heads) if args.heads else None,
        impls=tuple(args.impl) if args.impl else None,
        candidates=(tuple(args.candidates) if args.candidates else None),
        num_cores=args.num_cores,
        repeats=args.repeats,
        warmup=args.warmup,
        budget_s=args.budget_s,
    ).items() if v is not None}
    hw = None
    if args.reference:
        overridden = sorted(over) + [f for f, v in (
            ("merge", args.merge),
            ("mode", None if args.mode == "auto" else args.mode),
            ("seed", args.seed or None)) if v is not None]
        if overridden:
            raise SystemExit(
                "--reference fixes the grid, mode=modeled at TPU_V5E and "
                f"seed=0 so it reproduces the reference's table; drop "
                f"{overridden} (or run without --reference)")
        spec, mode, seed, hw = REFERENCE_SPEC, "modeled", 0, TPU_V5E
        out = args.out or REFERENCE_OUT
    else:
        base = H100_SPEC if args.h100 else TuneSpec()
        spec, mode, seed = base.replace(**over), args.mode, args.seed
        out = args.out or H100_TABLE_DIR / "split_table.json"
    run_tune(spec, mode=mode, seed=seed, out=out, merge=args.merge, hw=hw,
             device=args.device)


if __name__ == "__main__":
    main()
