"""The benchmark's command:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

One run of one cell of ``BENCHMARK.json`` on this machine's CUDA card:
set-up, warm-up, a window of ``--seconds``, the check against the plain
reference, and one JSON line last on standard output (``--trace 0``: the
cell's end-to-end metrics; ``--trace 1``: its per-layer metrics from spans,
counters and a device trace). Exits nonzero, printing no result, without
enough CUDA cards, without the port beside it, or if JAX or the JAX package
was loaded.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "field_interpolation_tpu"}


def _paths() -> None:
    """Import from the checkout's root (not this folder), and keep every
    build and kernel cache at a fixed path inside the checkout."""
    sys.path[0] = str(ROOT)
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")


def loaded_jax() -> list:
    """The forbidden top-level names among the loaded modules (compared
    whole: the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def main(argv=None) -> int:
    _paths()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from benchmark.cells import Cell, load_benchmark
    cell = Cell(load_benchmark(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # The window's work runs on the card; torch's CPU thread pool only adds
    # threads that contend with the one issuing it on a shared host.
    torch.set_num_threads(1)
    from benchmark.harness import run_cell
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0))
    bad = loaded_jax()
    if bad:
        print(f"benchmark: the run loaded {', '.join(bad)}; no result", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
