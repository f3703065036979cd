"""On the card: a short run of each cell through the command, traced, comes
out correct with its per-layer metrics. Skips without a CUDA card."""

import json
import subprocess
import sys

import pytest

from benchmark.cells import ROOT, Cell, load_benchmark

CELLS = [w["name"] for w in load_benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_short_traced_run_on_the_card(name):
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", name,
                          "--seed", str(2**31 + 41), "--seconds", "2", "--trace", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=1500)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    cell = Cell(load_benchmark(), name)
    assert set(line["metrics"]) == {m["name"] for m in cell.per_layer}
    assert 0 < line["device"]["busy_s"] <= line["device"]["window_s"]
