"""The control of the check: the plain reference put in the program's place,
computed in the nearest precision below the one the cell states (the traffic
file's ``control_precision``: TF32 where the configuration states float32
with TF32 off, float32 where it states float64), and judged by the same
comparison a run makes. It has to come out not correct.

    python3 benchmark/control.py --workload <name> --seeds <n,n,...> [--precision P]

For each seed it makes the pool a run would make, solves as many of its
batches as a run compares (``check_batches``) with the reference solve of
the cell's check (``reference_solve``), and prints the check's numbers as
one JSON line a seed. The benchmark's own runs never run this; the tests
run it at a small size.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def control_numbers(cell, seed: int, device, precision: str = None) -> dict:
    """The check's numbers for the reference solved in ``precision`` (the
    cell's ``control_precision`` if None) on a run's pool and sample size."""
    from benchmark import check
    from benchmark.traffic import make_pool
    precision = precision or cell.traffic["control_precision"]
    pool = make_pool(cell.config, cell.traffic, seed, device)
    block = int(cell.traffic["check_block"])
    kept, flags = [], []
    for j in range(min(int(cell.traffic["check_batches"]), len(pool))):
        x, conv = check.checker(cell).reference_solve(cell, *pool[j], precision, block)
        kept.append((j, x))
        flags.append(conv)
    correct, numbers, lanes, _ = check.judge(cell, pool, kept, flags, block)
    return {"seed": seed, "precision": precision, "correct": correct, "lanes": lanes,
            "checks": check.as_json(numbers)}


def main(argv=None) -> int:
    sys.path[0] = str(ROOT)
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--precision", default=None)
    args = ap.parse_args(argv)
    import torch
    from benchmark.cells import Cell, load_benchmark
    cell = Cell(load_benchmark(), args.workload)
    device = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    torch.backends.cuda.matmul.allow_tf32 = False
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = control_numbers(cell, seed, device, args.precision)
        out["seconds"] = time.perf_counter() - t0
        out["device"] = str(torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu")
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
