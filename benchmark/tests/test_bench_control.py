"""The check fails what it must: the control (the reference in the program's
place, a precision below the cell's) and runs whose timed path is broken
underneath. The same reference at the cell's own precision passes."""

import dataclasses

import pytest
import torch

from benchmark.cells import load_benchmark
from benchmark.control import control_numbers
from benchmark.harness import run_cell

CELLS = [w["name"] for w in load_benchmark()["workloads"]]
STATED = {"tf32": "float32", "float32": "float64"}


def control_cell(name, tiny_cell):
    """The cell at a size the control separates at in a test run: the
    float32 cells at their own 128² grid and points, four lanes (a TF32 CG
    at 32² still meets the limit on a few lanes; at 128² most of its lanes
    end unconverged, as on the card), the float64 cell at the tiny size."""
    cell = tiny_cell(name)
    if cell.traffic["control_precision"] == "tf32":
        cell.config["grid"], cell.config["cloud"]["points"] = [128, 128], 256
        cell.traffic.update(pool_batches=1, check_batches=1, check_block=4)
    return cell


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, tiny_cell):
    out = control_numbers(control_cell(name, tiny_cell), 2**31 + 21, torch.device("cpu"))
    assert out["correct"] is False, out


@pytest.mark.parametrize("name", CELLS)
def test_reference_at_the_stated_precision_is_correct(name, tiny_cell):
    cell = control_cell(name, tiny_cell)
    stated = STATED[cell.traffic["control_precision"]]
    out = control_numbers(cell, 2**31 + 21, torch.device("cpu"), stated)
    assert out["correct"] is True, out


def _unchanged(x, info):
    return torch.zeros_like(x), info


def _half_left_out(x, info):
    x = x.clone()
    x[x.shape[0] // 2:] = 0
    return x, info


def _answer_altered(x, info):
    x = x.clone()
    x[1] *= 1.01
    return x, info


# One chip a cell: no exchange between chips to leave out.
FAULTS = {"state_unchanged": _unchanged, "half_batch_left_out": _half_left_out,
          "answer_altered": _answer_altered}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, tiny_cell, monkeypatch):
    import importlib
    cell = tiny_cell(name)
    module_name, _, solve_name = cell.traffic["stages"][1].partition(":")
    batch = importlib.import_module(module_name)
    solve = getattr(batch, solve_name)

    def broken(*args, **kwargs):
        x, info = solve(*args, **kwargs)
        x, info = FAULTS[fault](x, info)
        return x, dataclasses.replace(info, converged=torch.ones_like(info.converged))

    monkeypatch.setattr(batch, solve_name, broken)
    result = run_cell(cell, 2**31 + 31, 0.3, False, torch.device("cpu"))
    assert result["correct"] is False
    assert result["checks"]["true_rel_residual_max"]["value"] > \
        result["checks"]["true_rel_residual_max"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_one_unconverged_field_is_not_correct(name, tiny_cell, monkeypatch):
    """A single field the program flags unconverged, whatever its residual,
    fails the run: the limit on unconverged fields is 0."""
    import importlib
    cell = tiny_cell(name)
    module_name, _, solve_name = cell.traffic["stages"][1].partition(":")
    batch = importlib.import_module(module_name)
    solve = getattr(batch, solve_name)

    def one_flag(*args, **kwargs):
        x, info = solve(*args, **kwargs)
        conv = info.converged.clone()
        conv[-1] = False
        return x, dataclasses.replace(info, converged=conv)

    monkeypatch.setattr(batch, solve_name, one_flag)
    result = run_cell(cell, 2**31 + 33, 0.3, False, torch.device("cpu"))
    assert result["correct"] is False and result["failed"] >= 1
    assert result["checks"]["unconverged_fields"]["value"] == result["failed"]
    assert result["checks"]["true_rel_residual_max"]["value"] <= \
        result["checks"]["true_rel_residual_max"]["limit"]
