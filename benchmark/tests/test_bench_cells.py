"""BENCHMARK.json keeps to its contract, and every cell's files are found
by the names it gives."""

import json
import re

import pytest

from benchmark.cells import HERE, ROOT, Cell, load_benchmark, module, reader

BENCH = load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
RUN_KEYS = {"name", "config", "traffic", "chips", "why"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    cells = len(BENCH["workloads"])
    # a full check of 24 cells, 2 + 14 runs a cell, fits in 43,200 s
    assert 2 + 14 * 24 <= (43200 - 1200 - 24 * 180) / (BENCH["run_seconds"] + 60)
    assert 1 <= cells <= 24


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load_by_name(w):
    assert set(w) == RUN_KEYS and w["chips"] in (1, 4)
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
    cell = Cell(BENCH, w["name"])
    assert cell.config["name"] == w["config"]
    assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
    tr = cell.traffic
    for key in ("lanes", "adapter", "entry", "stages", "pool_batches", "warmup_batches",
                "check_batches", "check_block", "trace_batches", "control_precision",
                "limits"):
        assert key in tr, key
    assert set(tr["limits"]) == {"true_rel_residual_max", "unconverged_fields"}
    assert tr["limits"]["unconverged_fields"] == 0
    reported = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and cell.per_layer


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_modules_found_by_name(w):
    """The adapter, the entry and stages it calls, the inputs and the check
    are found by the names the data files give."""
    from benchmark.adapters.sdf_batch import resolve
    cell = Cell(BENCH, w["name"])
    tr = cell.traffic
    assert callable(module("adapters", tr["adapter"]).Program)
    for spec in [tr["entry"], *tr["stages"]]:
        assert ":" in spec and callable(resolve(spec))
    assert callable(module("inputs", cell.config["cloud"]["kind"]).make)
    chk = module("checks", cell.config["check"])
    assert callable(chk.judge) and callable(chk.reference_solve)


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_entries(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert c["file"].startswith("benchmark/configs/")
    assert c["reduced"] == []
    with open(ROOT / c["file"]) as f:
        conf = json.load(f)
    assert conf["name"] == c["name"]
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["end_to_end"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert callable(reader(m["name"]))
        for w in m.get("workloads", []):
            assert any(x["name"] == w for x in BENCH["workloads"])
