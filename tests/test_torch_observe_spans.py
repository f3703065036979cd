"""The spans and counters inside the port's batched solve
(`field_interpolation_tpu_torch.utils.observe`: `span`, `count`,
`host_read`, `batch_records`), on the CPU at 32² × 4 lanes over the four
batched routes: the fused segment, the cycle (Jacobi coarsest), and the
refined solve on each.

Without a recording profiler nothing is kept. Under ``torch.profiler``
each entry call keeps one record whose spans nest as `batch.py` and
`solver.py` open them, whose counters agree with what the loops did, and
whose host times hold the profiler's own intervals of the ops run
inside them; the outputs are the same bits, and the profile's aten ops the
same list as with the recording calls patched to no-ops.

The device half (``gpu``: the CUDA timing events, the kernels launched)
skips without a card; on the GPU host:

    python -m pytest --noconftest -m gpu tests/test_torch_observe_spans.py
"""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch import batch as tb
from field_interpolation_tpu_torch import solver as tsolver
from field_interpolation_tpu_torch.utils import observe

SHAPE, LANES, POINTS = (32, 32), 4, 40
JACOBI = dict(mg_coarse_solver="jacobi")
ROUTES = {
    "fused": (tb.sdf_from_points_batch, dict(tol=1e-4), "fused"),
    "cycle": (tb.sdf_from_points_batch, dict(tol=1e-4, **JACOBI), "cycle"),
    "refined-fused": (tb.sdf_from_points_precise_batch, dict(tol=1e-6), "fused"),
    "refined-cycle": (tb.sdf_from_points_precise_batch, dict(tol=1e-6, **JACOBI), "cycle"),
}
# The span each span may open inside (None: the record's root).
PARENTS = {
    "batch": {None, "batch"},
    "assemble": {"batch"},
    "mg_setup": {"batch"},
    "refine_round": {"batch"},
    "inner_solve": {"refine_round"},
    "segment_round": {"batch", "inner_solve"},
    "host_read": {"batch", "inner_solve", "segment_round"},
}


def _cloud(device="cpu", seed=3):
    rng = np.random.default_rng(seed)
    center = (np.asarray(SHAPE) - 1.0) / 2.0
    theta = rng.uniform(0, 2 * np.pi, (LANES, POINTS))
    nrm = np.stack([np.cos(theta), np.sin(theta)], axis=-1)
    radii = rng.uniform(0.2, 0.4, (LANES, 1, 1)) * min(SHAPE)
    pts = center + radii * nrm
    return (torch.tensor(pts.astype(np.float32), device=device),
            torch.tensor(nrm.astype(np.float32), device=device))


def _call(route, device="cpu"):
    entry, cfg, _ = ROUTES[route]
    pts, nrm = _cloud(device)
    return entry(ft.Grid(SHAPE), ft.Weights(model_2=0.3), pts, nrm,
                 config=ft.SolverConfig(**cfg))


def _profiled(route, device="cpu"):
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device != "cpu" else [])
    with profile(activities=acts) as prof:
        out = _call(route, device)
    return out, list(prof.profiler.kineto_results.events())


def _aten(events):
    return [e.name() for e in sorted(events, key=lambda e: (e.start_ns(), -e.end_ns()))
            if e.name().startswith("aten::")]


def _no_ops(monkeypatch):
    monkeypatch.setattr(observe, "span", lambda name, device=None: observe._OFF)
    monkeypatch.setattr(observe, "count", lambda name, value, before=None: None)
    monkeypatch.setattr(observe, "host_read", bool)


@pytest.fixture(scope="module", params=list(ROUTES))
def runs(request):
    """Per route: the entry without a profiler, then under one with spies
    on the host reads and the refinement's inner solves (Python only: they
    keep references and run no op)."""
    route = request.param
    mp = pytest.MonkeyPatch()
    try:
        observe.clear_records()
        x0, info0 = _call(route)
        kept_without = observe.batch_records()
        reads, inner = [], []
        real_read = observe.host_read
        mp.setattr(observe, "host_read", lambda t: reads.append(1) or real_read(t))
        for name in ("_pcg_fused_batch", "pcg_batch"):
            real = getattr(tsolver, name)

            def spy(op, b, *a, _real=real, **k):
                inner.append(b)
                return _real(op, b, *a, **k)
            mp.setattr(tsolver, name, spy)
        (x1, info1), events = _profiled(route)
    finally:
        mp.undo()
    records = observe.batch_records()
    observe.clear_records()
    return dict(route=route, x0=x0, info0=info0, kept_without=kept_without, x1=x1,
                info1=info1, events=events, records=records, reads=len(reads),
                inner=inner)


def test_off_path_is_one_shared_object():
    assert not torch.autograd.profiler._is_profiler_enabled
    assert observe.span("batch") is observe.span("mg_setup", "cpu") is observe._OFF
    observe.clear_records()
    assert observe.count("host_syncs", 1) is None
    assert observe.host_read(torch.tensor(True)) is True
    assert observe.host_read(torch.tensor(False)) is False
    assert observe.batch_records() == []


def test_route_is_the_named_one():
    for route, (_, cfg, want) in ROUTES.items():
        pts, _ = _cloud()
        problems = tb.assemble_batch(ft.Grid(SHAPE), ft.Weights(model_2=0.3), pts,
                                     torch.zeros(pts.shape[:2]))
        config = tb._batch_config(problems.grid, ft.SolverConfig(**cfg), LANES)
        assert tb.solve_route(problems, config) == want, route


def test_no_profiler_no_record(runs):
    assert runs["kept_without"] == []


def test_same_bits_with_and_without_profiler(runs):
    assert torch.equal(runs["x0"], runs["x1"])
    for f in ("iterations", "rel_residual", "converged"):
        assert torch.equal(getattr(runs["info0"], f), getattr(runs["info1"], f)), f


def test_one_record_whose_spans_nest(runs):
    (rec,) = runs["records"]
    spans = rec["spans"]
    by_id = {s["id"]: s for s in spans}
    assert len(by_id) == len(spans)
    roots = [s for s in spans if s["parent"] is None]
    assert [s["name"] for s in roots] == ["batch"]
    names = collections.Counter(s["name"] for s in spans)
    assert names["batch"] == 3 and names["assemble"] == 1 and names["mg_setup"] == 1
    for s in spans:
        assert s["batch"] == rec["batch"]
        assert s["start_ns"] <= s["end_ns"]
        assert s["device_ms"] is None  # CPU tensors: no device time
        parent = by_id.get(s["parent"])
        assert (parent["name"] if parent else None) in PARENTS[s["name"]], s
        if parent:
            assert parent["start_ns"] <= s["start_ns"] and s["end_ns"] <= parent["end_ns"]
    refined = runs["route"].startswith("refined")
    assert (names["refine_round"] > 0) == refined
    assert names["inner_solve"] == names["refine_round"]
    assert names["segment_round"] >= max(1, names["inner_solve"])


def test_counters_agree_with_the_loops(runs):
    (rec,) = runs["records"]
    c, names = rec["counters"], collections.Counter(s["name"] for s in rec["spans"])
    assert c["host_syncs"] == runs["reads"] == names["host_read"] > 0
    assert 0 < c["lanes_working"] <= c["lanes_offered"]
    assert c["lanes_offered"] % LANES == 0
    if ROUTES[runs["route"]][2] == "fused":  # one offer of every lane a segment launch
        assert c["lanes_offered"] == LANES * names["segment_round"]
    if not runs["route"].startswith("refined"):
        assert "refine_rounds" not in c
        return
    # A round's inner solve sees a zero residual on every frozen lane.
    active = torch.stack([b.flatten(1).ne(0).any(1) for b in runs["inner"]])
    assert active.shape == (names["refine_round"], LANES) and bool(active[0].all())
    assert c["refine_rounds"] == int(active.sum())
    cfg = ft.SolverConfig(**ROUTES[runs["route"]][1])
    rounds = active.sum(0)
    assert bool((rounds <= cfg.refine_rounds).all())
    # a lane runs another round only while it has not met tol (SolveInfo)
    assert int(rounds.max()) == names["refine_round"]
    assert bool(runs["info1"].converged.all())


def test_data_run_counters_of_the_segment_launches(runs):
    """A fused route offers every lane's level-0 runs of 4 nodes at each
    segment launch and counts those that hold data; the cycle routes run no
    segment and count neither."""
    from field_interpolation_tpu_torch.ops.pcg import lane_runs
    (rec,) = runs["records"]
    c, names = rec["counters"], collections.Counter(s["name"] for s in rec["spans"])
    if ROUTES[runs["route"]][2] != "fused":
        assert "runs_offered" not in c and "data_runs" not in c
        return
    assert c["runs_offered"] == LANES * lane_runs(SHAPE) * names["segment_round"]
    assert 0 < c["data_runs"] < c["runs_offered"] // 2


def test_spans_hold_the_profiler_intervals_of_their_ops(runs):
    """Each span's host interval (the profiler's clock) holds its own
    ``fi.<name>`` range and every aten op run inside it."""
    (rec,) = runs["records"]
    events = runs["events"]
    ranges = collections.defaultdict(list)
    for e in events:
        if e.name().startswith("fi.") and e.is_user_annotation():
            ranges[e.name()[3:]].append((e.start_ns(), e.end_ns()))
    ops = [(e.start_ns(), e.end_ns()) for e in events if e.name().startswith("aten::")]
    spans = collections.defaultdict(list)
    for s in rec["spans"]:
        spans[s["name"]].append(s)
    inside_any = 0
    for name, group in spans.items():
        group.sort(key=lambda s: s["start_ns"])
        got = sorted(ranges[name])
        assert len(got) == len(group), name
        for s, (a, b) in zip(group, got):
            assert s["start_ns"] <= a <= b <= s["end_ns"], (name, s, a, b)
            inner = [(u, v) for u, v in ops if a <= u and v <= b]
            assert all(s["start_ns"] <= u and v <= s["end_ns"] for u, v in inner)
            inside_any += len(inner)
    assert inside_any > 0


@pytest.mark.parametrize("route", list(ROUTES))
def test_recording_adds_no_op(route, monkeypatch):
    """The profile's aten ops of a batch are the same list with the spans,
    counters and host reads live as with them patched to no-ops."""
    _, live = _profiled(route)
    assert observe.batch_records()
    observe.clear_records()
    _no_ops(monkeypatch)
    _, quiet = _profiled(route)
    assert observe.batch_records() == []
    assert _aten(live) == _aten(quiet) and len(_aten(live)) > 100


def test_records_are_bounded_and_cleared():
    observe.clear_records()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(observe.KEPT_BATCHES + 3):
            with observe.span("batch"):
                observe.count("host_syncs", 2)
                with observe.span("mg_setup"):
                    observe.count("lanes_working", torch.tensor([1, 0, 1]))
                    observe.count("lanes_working", torch.tensor([3, 1]),
                                  before=torch.tensor([2, 1]))
    recs = observe.batch_records()
    assert len(recs) == observe.KEPT_BATCHES
    assert [r["batch"] for r in recs] == sorted(r["batch"] for r in recs)
    assert recs[-1]["counters"] == {"host_syncs": 2, "lanes_working": 3}
    assert observe.batch_records() == recs  # reading twice reads the same
    observe.clear_records()
    assert observe.batch_records() == []


# ------------------------------------------------------------------ the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (and nvcc to build the kernels)")
    return torch.device("cuda", 0)


def _launches(events):
    return sorted(e.name() for e in events if e.device_type() == torch.autograd.DeviceType.CUDA
                  and not e.is_user_annotation())


@pytest.mark.gpu
@pytest.mark.parametrize("route", list(ROUTES))
def test_card_device_spans_and_no_extra_kernel(route, cuda, monkeypatch):
    """On the card: device spans carry their timing events' ms, and the
    device runs the same kernels and copies, to the same bits, with the
    recording live as with it patched to no-ops. One assembled problem is
    solved each time: the card's assembly adds with atomics, in no fixed
    order, so two assemblies need not give the same bits."""
    _, cfg, _ = ROUTES[route]
    refined = route.startswith("refined")
    assemble = tb.assemble_precise_batch if refined else tb.assemble_batch
    solve = tb.solve_refined_batch if refined else tb.solve_batch
    grid, weights, config = ft.Grid(SHAPE), ft.Weights(model_2=0.3), ft.SolverConfig(**cfg)
    pts, nrm = _cloud(cuda)
    values = torch.zeros(pts.shape[:2], device=cuda)
    problems = assemble(grid, weights, pts, values, gradients=nrm)
    solve(problems, config)  # builds and loads the kernels

    def profiled():
        observe.clear_records()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            x, _ = solve(problems, config)
            assemble(grid, weights, pts, values, gradients=nrm)
            torch.cuda.synchronize()
        recs = observe.batch_records()
        observe.clear_records()
        return x, recs, _launches(prof.profiler.kineto_results.events())

    x1, recs, live = profiled()
    assert len(recs) == 2
    names = {s["name"] for r in recs for s in r["spans"]}
    assert {"batch", "assemble", "mg_setup", "segment_round", "host_read"} <= names
    assert ("refine_round" in names) == refined
    for s in (s for r in recs for s in r["spans"]):
        device = s["name"] in ("assemble", "mg_setup", "refine_round", "inner_solve")
        assert (s["device_ms"] is not None) == device, s
        if device:
            assert s["device_ms"] > 0
    _no_ops(monkeypatch)
    x2, quiet_recs, quiet = profiled()
    assert quiet_recs == [] and torch.equal(x1, x2)
    assert live == quiet and live
