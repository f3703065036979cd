"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): the result line has the contract's keys, and nothing else."""

import json
import subprocess
import sys

import pytest
import torch

from benchmark.cells import ROOT, load_benchmark
from benchmark.harness import run_cell
from benchmark.trace import Trace

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device", "checks"]


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_prints_the_contract_keys(name, tiny_cell, capsys):
    cell = tiny_cell(name)
    result = run_cell(cell, 2**31 + 11, 0.5, False, torch.device("cpu"))
    line = json.loads(json.dumps(result))
    assert list(line) == KEYS  # the check's numbers last
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0 and line["attempted"] % cell.lanes == 0
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert line["metrics"][m["name"]]["unit"] == m["unit"]
        assert line["metrics"][m["name"]]["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-2].startswith("check true_rel_residual_max") and " limit " in err[-2]
    assert err[-1] == "check unconverged_fields 0 limit 0"


def test_same_seed_same_inputs():
    from benchmark.cells import Cell
    from benchmark.traffic import make_pool
    cell = Cell(load_benchmark(), CELLS[0])
    cell.traffic.update(lanes=8, pool_batches=2)
    a = make_pool(cell.config, cell.traffic, 3 * 2**31, "cpu")
    b = make_pool(cell.config, cell.traffic, 3 * 2**31, "cpu")
    c = make_pool(cell.config, cell.traffic, 3 * 2**31 + 1, "cpu")
    assert all(torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) for x, y in zip(a, b))
    assert not torch.equal(a[0][0], c[0][0])
    # every seed draws the same radii, in its own order
    center = (torch.tensor(cell.config["grid"]) - 1) / 2
    radii = [torch.sort(torch.cat([(p - center).norm(dim=-1)[:, 0] for p, _ in pool]))[0]
             for pool in (a, c)]
    assert torch.allclose(radii[0], radii[1], atol=1e-4)


def test_command_refuses_without_a_card():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELLS[0],
                          "--seed", "5", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_jax_is_found_by_whole_name(monkeypatch):
    from benchmark import run
    monkeypatch.setitem(sys.modules, "field_interpolation_tpu_torch.batch", object())
    assert "field_interpolation_tpu" not in run.loaded_jax()
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in run.loaded_jax()


def test_readers_on_a_trace():
    from benchmark.cells import Cell, reader
    from benchmark.harness import Run
    # two batches: segment 0-40 µs, plain 50-60, apply 60-70; idle 40-50 and 70-100
    events = [(True, "pcg_segment_batch_kernel<256,2>", 0.0, 40.0),
              (True, "elementwise_kernel", 50.0, 60.0),
              (True, "normal_apply_2d", 60.0, 70.0),
              (False, "cudaLaunchCooperativeKernel", 0.0, 1.0),
              (False, "cudaLaunchKernel", 49.0, 50.0),
              (False, "cuLaunchKernel", 59.0, 60.0),
              (False, "aten::mul", 40.0, 50.0)]
    t = Trace(events, (0.0, 100.0), 2)
    assert t.launch_calls == 3 and t.kept == 1.0
    assert abs(t.busy_s - 60e-6) < 1e-12 and abs(t.window_s - 100e-6) < 1e-12
    assert t.idle_gaps()[0] == ["host between recorded ops", pytest.approx(30e-6)]
    assert t.idle_gaps()[1] == ["aten::mul", pytest.approx(10e-6)]
    cell = Cell(load_benchmark(), "c3-b1024-true1e-6")
    run = Run(cell=cell, spans={"assemble": [0.004], "solve": [0.06]}, fields=2048,
              iterations=20480, trace=t, trace_iterations=20480, trace_lanes=2048)
    assert reader("device_idle")(run) == pytest.approx(40.0)
    assert reader("launch_calls_per_batch")(run) == 1.5
    assert reader("plain_ms_per_batch")(run) == pytest.approx(0.005)
    assert reader("smooth_ms_per_batch")(run) is None
    assert reader("iters_per_field")(run) == 10.0
    assert reader("assemble_ms")(run) == pytest.approx(4.0)
    seg = reader("segment_roofline")(run)
    from benchmark import work
    flops = 20480 * work.lane_iteration_flops(work.level_shapes((128, 128)), [2], 3)
    assert seg == pytest.approx(100 * flops / 67e12 / 40e-6)


def test_segment_bytes_once_a_batch_per_iterating_lane():
    """With few iterations the bytes bound binds: the least time charges each
    iterating lane's bytes once a batch, however many segment launches the
    trace holds (here two a batch)."""
    from benchmark import work
    from benchmark.cells import Cell, reader
    from benchmark.harness import Run
    events = [(True, "pcg_segment_batch_kernel<256,2>", 0.0, 400.0),
              (True, "pcg_segment_batch_kernel<256,2>", 500.0, 600.0),
              (True, "pcg_segment_batch_kernel<256,2>", 1000.0, 1400.0),
              (True, "pcg_segment_batch_kernel<256,2>", 1500.0, 1600.0)]
    t = Trace(events, (0.0, 2000.0), 2)
    cell = Cell(load_benchmark(), "c3-b1024-true1e-6")
    run = Run(cell=cell, spans={}, fields=2048, iterations=1, trace=t,
              trace_iterations=1, trace_lanes=2000)
    shapes = work.level_shapes((128, 128))
    nbytes = 2000 * work.lane_bytes(shapes)
    assert work.least_seconds(nbytes, work.lane_iteration_flops(shapes, [2], 3))[1] == "bytes"
    assert reader("segment_roofline")(run) == pytest.approx(100 * nbytes / 3.35e12 / 1000e-6)
