"""The benchmark's own tests (run with ``python -m pytest benchmark/tests``);
the repository's tier-1 run collects ``tests/`` only."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import pytest  # noqa: E402


def shrink(cell):
    """A cell of BENCHMARK.json cut to a size the CPU runs in seconds (the
    plain versions of the port's kernels run on CPU tensors)."""
    cell.config["grid"], cell.config["cloud"]["points"] = [32, 32], 40
    cell.traffic.update(lanes=4, pool_batches=3, warmup_batches=1, check_batches=2,
                        check_block=2)
    return cell


@pytest.fixture
def tiny_cell():
    from benchmark.cells import Cell, load_benchmark

    def make(name):
        return shrink(Cell(load_benchmark(), name))
    return make
