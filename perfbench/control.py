"""The readings each cell's limits are set from: the program's compared
numbers and its control's, seed by seed.

    python3 perfbench/control.py --workload <cell> --seeds 11 12 13 [--seconds 10]

For each seed the cell sets up, runs a window of ``--seconds`` at its
own load, and then gives through its ``check`` the program's numbers and
through its ``control`` those of the plain reference put in the
program's place at the precision below the configuration's (and of any
fault it plants there), each beside its limit.  One JSON line a seed,
with ``correct`` for every side.  The benchmark's own runs never run
this.
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

sys.path[:0] = [str(Path(__file__).resolve().parents[1])]

from perfbench import run  # noqa: E402


def readings(bench: dict, workload: str, seed: int, seconds: float, device,
             updates: dict | None = None) -> dict:
    """``{side: {"correct": bool, "numbers": {name: value}}}`` for the
    side ``program`` and each of the cell's controls on ``seed``."""
    _, cfg, traffic = run.cell_files(bench, workload, updates=updates)
    driver = importlib.import_module(f"perfbench.drivers.{traffic['driver']}")
    cell = driver.Cell(cfg, traffic, seed, device, False)
    try:
        cell.run(seconds)
        cell.release()
        sides = {"program": cell.check(), **cell.control()}
    finally:
        cell.close()
    return {side: {"correct": run.correct(checks),
                   "numbers": {k: c[0] for k, c in checks.items()}}
            for side, checks in sides.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)
    run._setup_paths()
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    bench = run.load_benchmark()
    for seed in args.seeds:
        r = readings(bench, args.workload, seed, args.seconds, device)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
