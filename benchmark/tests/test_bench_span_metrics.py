"""The readers of the program's own spans and counters (`benchmark.records`
and the six metrics that read it), on hand-built records and traces, on a
port that keeps no records, and on the records a tiny CPU batch leaves."""

import pytest
import torch

from benchmark import records
from benchmark.cells import Cell, load_benchmark, reader
from benchmark.harness import Run
from benchmark.trace import Trace

SPAN_METRICS = ["mg_setup_ms", "refine_self_ms", "refine_rounds_per_field", "lane_use",
                "host_syncs_per_batch", "sync_idle_ms"]
REFINED = "c3-b1024-true1e-6"


def _span(sid, name, parent, start_us, end_us, device_ms=None, batch=1):
    return {"name": name, "id": sid, "parent": parent, "batch": batch,
            "start_ns": int(start_us * 1e3), "end_ns": int(end_us * 1e3),
            "device_ms": device_ms}


def _refined_record(batch, t0):
    """One refined batch from ``t0`` µs: set-up 2 ms, two rounds (6 and 4 ms,
    their inner solves 5 and 3.5 ms), three flag reads, 1024 lanes."""
    s = [_span(1, "batch", None, t0, t0 + 100),
         _span(2, "mg_setup", 1, t0 + 1, t0 + 10, 2.0),
         _span(3, "refine_round", 1, t0 + 10, t0 + 40, 6.0),
         _span(4, "inner_solve", 3, t0 + 11, t0 + 35, 5.0),
         _span(5, "segment_round", 4, t0 + 12, t0 + 30),
         _span(6, "host_read", 4, t0 + 30, t0 + 34),
         _span(7, "host_read", 1, t0 + 40, t0 + 44),
         _span(8, "refine_round", 1, t0 + 44, t0 + 90, 4.0),
         _span(9, "inner_solve", 8, t0 + 45, t0 + 80, 3.5),
         _span(10, "host_read", 9, t0 + 70, t0 + 75)]
    for e in s:
        e["batch"] = batch
    return {"batch": batch, "spans": s,
            "counters": {"host_syncs": 3, "refine_rounds": 1024 + 100,
                         "lanes_offered": 2048, "lanes_working": 1124}}


def _trace(busy, batches):
    events = [(True, "pcg_segment_batch_kernel<256,2>", a, b) for a, b in busy]
    return Trace(events, (0.0, 1000.0), batches)


def _run(cell, trace):
    return Run(cell=Cell(load_benchmark(), cell), spans={}, fields=0, iterations=0,
               trace=trace)


@pytest.fixture
def kept(monkeypatch):
    """Stand the given records in for the program's."""
    def use(recs):
        monkeypatch.setattr(records, "program_records", lambda: recs)
    return use


def test_readers_on_hand_built_records(kept):
    # an older record first: only the last trace.batches records are read
    old = _refined_record(0, 0.0)
    old["counters"]["host_syncs"] = 99
    kept([old, _refined_record(1, 0.0), _refined_record(2, 500.0)])
    # busy until 31 (ends inside the read at 30-34), idle to 36; busy to 42
    # (inside the read at 40-44), idle to 50; busy to 60 (no read), idle to
    # 66; busy to 72 (inside 70-75), idle to 73; then the second batch's
    # reads at 530-534 and 540-544 close the gaps 532-533 and 541-546.
    busy = [(0, 31), (36, 42), (50, 60), (66, 72), (73, 200), (210, 532), (533, 541),
            (546, 900)]
    run = _run(REFINED, _trace(busy, 2))
    got = {m: reader(m)(run) for m in SPAN_METRICS}
    assert got["mg_setup_ms"] == pytest.approx(2.0)
    assert got["refine_self_ms"] == pytest.approx((6.0 - 5.0) + (4.0 - 3.5))
    assert got["refine_rounds_per_field"] == pytest.approx(1124 / 1024)
    assert got["lane_use"] == pytest.approx(100 * 1124 / 2048)
    assert got["host_syncs_per_batch"] == 3
    idle_us = (36 - 31) + (50 - 42) + (73 - 72) + (533 - 532) + (546 - 541)
    assert got["sync_idle_ms"] == pytest.approx(idle_us / 1e3 / 2)


def test_sync_idle_counts_only_gaps_opening_inside_a_read(kept):
    rec = {"batch": 1, "counters": {"host_syncs": 2},
           "spans": [_span(1, "batch", None, 0, 100), _span(2, "host_read", 1, 20, 30),
                     _span(3, "host_read", 1, 60, 61)]}
    kept([rec])
    # gaps open at 10 (before any read), 25 (inside 20-30), 45 (between reads),
    # 61 (at the end of 60-61) and 90 (after every read)
    busy = [(0, 10), (15, 25), (40, 45), (50, 61), (70, 90), (95, 100)]
    assert reader("sync_idle_ms")(_run("c3-b4096", _trace(busy, 1))) == pytest.approx(
        ((40 - 25) + (70 - 61)) / 1e3)


def test_readers_give_none_where_their_spans_do_not_run(kept):
    """The cycle route's batch: no refinement rounds, host spans only on the
    CPU (no device ms); a trace without records; a run without a trace."""
    rec = {"batch": 1, "counters": {"host_syncs": 5, "lanes_offered": 40, "lanes_working": 30},
           "spans": [_span(1, "batch", None, 0, 100), _span(2, "mg_setup", 1, 1, 10),
                     _span(3, "segment_round", 1, 10, 90),
                     _span(4, "host_read", 3, 20, 30)]}
    kept([rec])
    run = _run("c3-b4096", _trace([(0, 25), (40, 100)], 1))
    got = {m: reader(m)(run) for m in SPAN_METRICS}
    assert got["refine_self_ms"] is None and got["refine_rounds_per_field"] is None
    assert got["mg_setup_ms"] is None  # a host span: no device time
    assert got["host_syncs_per_batch"] == 5 and got["lane_use"] == 75.0
    assert got["sync_idle_ms"] == pytest.approx(0.015)
    kept([])
    assert all(reader(m)(run) is None for m in SPAN_METRICS)
    kept([rec])
    assert all(reader(m)(_run("c3-b4096", None)) is None for m in SPAN_METRICS)
    # fewer records than traced batches: not the trace's, nothing read
    assert all(reader(m)(_run("c3-b4096", _trace([(0, 25)], 2))) is None
               for m in SPAN_METRICS)


def test_a_port_without_records_gives_none(monkeypatch):
    """A tree of the port that keeps no records (as before the spans): each
    reader gives None and raises nothing."""
    from field_interpolation_tpu_torch.utils import observe
    monkeypatch.delattr(observe, "batch_records")
    assert records.program_records() is None
    run = _run(REFINED, _trace([(0, 25), (40, 100)], 1))
    assert all(reader(m)(run) is None for m in SPAN_METRICS)


@pytest.mark.parametrize("name", [REFINED, "c3-b4096"])
def test_readers_on_a_tiny_cpu_batch(name, tiny_cell):
    """Two batches of a tiny cell under a CPU profiler: the counters' readers
    find what the program recorded; the device ms are the card's alone."""
    from field_interpolation_tpu_torch.utils import observe
    from benchmark.cells import module
    from benchmark.traffic import make_pool
    cell = tiny_cell(name)
    if name == "c3-b4096":  # the cell's route at a tiny size: the Jacobi coarsest
        cell.solver["mg_coarse_solver"] = "jacobi"
    program = module("adapters", cell.traffic["adapter"]).Program(cell)
    pool = make_pool(cell.config, cell.traffic, 2**33 + 5, "cpu")
    observe.clear_records()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for pts, nrm in pool[:2]:
            program(pts, nrm)
    run = Run(cell=cell, spans={}, fields=0, iterations=0, trace=_trace([(0, 1)], 2))
    got = {m["name"]: reader(m["name"])(run) for m in cell.per_layer
           if m["name"] in SPAN_METRICS}
    observe.clear_records()
    assert set(got) == set(SPAN_METRICS) if name == REFINED else set(got) == {
        "mg_setup_ms", "lane_use", "host_syncs_per_batch", "sync_idle_ms"}
    assert got["host_syncs_per_batch"] >= 2 and 0 < got["lane_use"] <= 100
    assert got["mg_setup_ms"] is None
    if name == REFINED:
        assert got["refine_self_ms"] is None
        assert 1 <= got["refine_rounds_per_field"] <= cell.solver.get("refine_rounds", 6)
