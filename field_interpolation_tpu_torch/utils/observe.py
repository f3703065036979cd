"""Observability: per-solve records, timing, roofline accounting.

Counterpart of ``field_interpolation_tpu.utils.observe``: structured
per-solve records (iterations, relative residual, wall time, achieved GB/s
against the card's memory rate) as Python objects and optional JSON lines,
the chained marginal timer, and per-phase cost tables. The reference's
``xla_cost`` reads XLA's compiled cost model, which torch has not; `op_cost`
takes its place by counting the aten ops of one run of the phase.

Inside the batched solve, `span`, `count` and `host_read` record each
batch's spans and counters while a torch profiler is recording, and cost
one attribute check otherwise (`batch_records`).

The rates are one NVIDIA H100's (SXM, NVIDIA's data sheet): 3.35 TB/s of
HBM and 67 TFLOP/s of float32 outside the tensor cores, at its full 700 W
power limit; a card set below it runs slower (``nvidia-smi
--query-gpu=name,power.limit``).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import json
import time
from typing import Optional, TextIO

import torch
from torch.autograd import profiler as _torch_profiler
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from ..grid import Grid

# HBM bytes per second (GB/s) and float32 peak (TFLOP/s) of the card.
HBM_GBPS = {"h100": 3350.0}
PEAK_TFLOPS = {"h100": 67.0}
CHIP = "h100"


def roofline_bytes_per_apply(grid: Grid, dtype_bytes: int = 4) -> int:
    """Minimum HBM traffic for one normal-operator apply: read x, read the
    3^D data-coefficient channels, write the result (smoothness taps are
    compile-time constants)."""
    n = grid.num_nodes
    channels = 3 ** grid.ndim
    return n * dtype_bytes * (1 + channels + 1)


def vcycle_applies_per_iteration(nu_pre: int = 3, nu_post: int = 3) -> float:
    """Fine-apply-equivalents per MG-PCG iteration for record_solve's traffic
    model: the from-zero first pre-smooth sweep performs no operator apply,
    so a V-cycle does (nu_pre − 1) smoothing applies down, one residual
    apply for the restriction and nu_post applies up, plus one CG apply;
    coarse levels add a geometric tail (≤ 1/3 of the fine work in 2D).
    Transfers are ignored, so this is a mild lower bound."""
    return (nu_pre + nu_post) * (4.0 / 3.0) + 1.0


@dataclasses.dataclass
class SolveRecord:
    """One solve's diagnostics (the structured version of the GUI readout)."""

    grid_shape: tuple[int, ...]
    iterations: int
    rel_residual: float
    converged: bool
    wall_ms: float
    solver: str = "pcg"
    preconditioner: str = "jacobi"
    achieved_gbps: Optional[float] = None
    roofline_frac: Optional[float] = None
    extra: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["grid_shape"] = list(self.grid_shape)
        return json.dumps(d)


@contextlib.contextmanager
def timed_block():
    """Context manager yielding a dict that receives {'ms': wall_ms} on exit
    (host clock: synchronize the card inside the block for device work)."""
    out = {}
    t0 = time.perf_counter()
    try:
        yield out
    finally:
        out["ms"] = (time.perf_counter() - t0) * 1e3


def _leaves(c) -> list:
    if isinstance(c, torch.Tensor):
        return [c]
    if isinstance(c, dict):
        c = list(c.values())
    if isinstance(c, (list, tuple)):
        return [leaf for v in c for leaf in _leaves(v)]
    return []


def _sync(carry) -> None:
    """Wait for the devices of the carry's CUDA tensors (CPU work is done
    when its ops return)."""
    for dev in {leaf.device for leaf in _leaves(carry) if leaf.is_cuda}:
        torch.cuda.synchronize(dev)


def measure_marginal(step, init, counts: tuple[int, int] = (32, 160)):
    """Marginal wall seconds per application of ``step``, by the chained
    K-difference method: time a chain of K1 and one of K2 steps (each after
    a warm-up run of the same chain, each ended by synchronizing the
    carry's device) and divide the difference by K2 − K1, so that a cost
    paid once per chain (the first launch, the final wait) cancels.

    step: carry → carry (tensors, or tuples / lists / dicts of them).
    init: initial carry.
    counts: the two chain lengths (K1 < K2).

    Returns ``(seconds_per_step, details)`` where details holds the raw
    chain timings and the final carry of the long chain."""
    K1, K2 = counts
    if not 0 <= K1 < K2:
        raise ValueError(f"counts must satisfy 0 <= K1 < K2, got {counts}")

    def run(K):
        c = init
        for _ in range(K):
            c = step(c)
        _sync(c)
        return c

    times = {}
    final = None
    for K in (K1, K2):
        run(K)                         # warm-up
        t0 = time.perf_counter()
        out = run(K)
        times[K] = time.perf_counter() - t0
        if K == K2:
            final = out
    per = (times[K2] - times[K1]) / (K2 - K1)
    return per, {"times_s": times, "counts": (K1, K2), "final_carry": final}


@dataclasses.dataclass(frozen=True)
class PhaseCost:
    """Counted cost of one phase (`op_cost`) and its roofline bound."""

    name: str
    flops: float
    bytes_accessed: float
    transcendentals: float
    temp_bytes: int            # peak device memory the phase allocated
    est_ms_bw: float           # bytes_accessed / HBM bandwidth
    est_ms_flops: float        # flops / float32 peak
    est_ms: float              # roofline lower bound: max of the two

    @property
    def arithmetic_intensity(self) -> float:
        return self.flops / self.bytes_accessed if self.bytes_accessed else 0.0


# Elementwise ops XLA's cost model counts as transcendental, one per element.
_TRANSCENDENTAL = {
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "sin", "cos", "tan",
    "asin", "acos", "atan", "atan2", "sinh", "cosh", "tanh", "asinh", "acosh",
    "atanh", "sigmoid", "erf", "erfc", "erfinv", "sqrt", "rsqrt", "pow",
}


class _ByteCounter(TorchDispatchMode):
    """Bytes of every aten op's tensor inputs and outputs (each read or
    written once) and the elements of its transcendental outputs."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.transcendentals = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = _leaves(list(args) + list((kwargs or {}).values()))
        outs = _leaves(out)
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        name = func.overloadpacket.__name__.rstrip("_")
        if name in _TRANSCENDENTAL:
            self.transcendentals += sum(t.numel() for t in outs)
        return out


def op_cost(fn, *example_args, name: str = "", chip: str = CHIP) -> PhaseCost:
    """Per-phase cost by counting one run of ``fn(*example_args)``: its
    floating-point operations (``torch.utils.flop_counter.FlopCounterMode``,
    2·m·n·k for a product of [m, k] by [k, n]), the bytes of every aten
    op's tensor inputs and outputs, and the elements of its transcendental
    ops. The hand-written kernels, launched through ctypes, are not aten
    ops and are not counted; count a phase that runs them with
    ``backend="xla"``, or from its shapes. ``temp_bytes``: the peak device
    memory the run allocated on a card, 0 on the CPU. Estimates use the
    ``chip`` rates; ``est_ms`` is the roofline lower bound max(bytes / rate,
    flops / peak)."""
    cuda = any(t.is_cuda for t in _leaves(list(example_args)))
    if cuda:
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    counter = _ByteCounter()
    with FlopCounterMode(display=False) as flops_mode, counter:
        fn(*example_args)
    temp = 0
    if cuda:
        torch.cuda.synchronize()
        temp = max(0, torch.cuda.max_memory_allocated() - base)
    flops = float(flops_mode.get_total_flops())
    byts = float(counter.bytes)
    bw = HBM_GBPS[chip] * 1e9
    pk = PEAK_TFLOPS[chip] * 1e12
    ms_bw = byts / bw * 1e3
    ms_fl = flops / pk * 1e3
    return PhaseCost(name=name, flops=flops, bytes_accessed=byts,
                     transcendentals=float(counter.transcendentals), temp_bytes=temp,
                     est_ms_bw=ms_bw, est_ms_flops=ms_fl, est_ms=max(ms_bw, ms_fl))


def cost_table(costs) -> str:
    """Fixed-width table of PhaseCosts (+ a TOTAL row) for human reading."""
    rows = list(costs)
    total = PhaseCost(
        name="TOTAL",
        flops=sum(c.flops for c in rows),
        bytes_accessed=sum(c.bytes_accessed for c in rows),
        transcendentals=sum(c.transcendentals for c in rows),
        temp_bytes=max((c.temp_bytes for c in rows), default=0),
        est_ms_bw=sum(c.est_ms_bw for c in rows),
        est_ms_flops=sum(c.est_ms_flops for c in rows),
        est_ms=sum(c.est_ms for c in rows),
    )
    hdr = (f"{'phase':<28} {'GFLOP':>9} {'MB moved':>10} "
           f"{'AI':>7} {'est ms (roofline)':>18}")
    lines = [hdr, "-" * len(hdr)]
    for c in rows + [total]:
        lines.append(
            f"{c.name:<28} {c.flops / 1e9:>9.3f} "
            f"{c.bytes_accessed / 1e6:>10.3f} "
            f"{c.arithmetic_intensity:>7.2f} {c.est_ms:>18.4f}")
    return "\n".join(lines)


def record_solve(grid: Grid, info, wall_ms: float, *,
                 preconditioner: str = "jacobi", solver: str = "pcg",
                 chip: str = CHIP, stream: Optional[TextIO] = None,
                 applies_per_iteration: float = 1.0,
                 **extra) -> SolveRecord:
    """Build (and optionally emit as a JSON line) a SolveRecord from a
    SolveInfo + measured wall time; estimates achieved bandwidth from the
    iteration count and the per-apply roofline bytes.

    The traffic model counts ``applies_per_iteration`` fine-grid operator
    applies per CG iteration and nothing else. The default (1.0) is only
    right for unpreconditioned/Jacobi CG; for a multigrid cycle pass e.g.
    `vcycle_applies_per_iteration`, or treat `achieved_gbps` /
    `roofline_frac` as lower bounds."""
    iters = int(info.iterations)
    gbps = None
    frac = None
    if wall_ms > 0 and iters > 0:
        moved = roofline_bytes_per_apply(grid) * iters * applies_per_iteration
        gbps = moved / (wall_ms * 1e-3) / 1e9
        peak = HBM_GBPS.get(chip)
        frac = gbps / peak if peak else None
    rec = SolveRecord(
        grid_shape=grid.shape,
        iterations=iters,
        rel_residual=float(info.rel_residual),
        converged=bool(info.converged),
        wall_ms=wall_ms,
        solver=solver,
        preconditioner=preconditioner,
        achieved_gbps=gbps,
        roofline_frac=frac,
        extra=extra,
    )
    if stream is not None:
        print(rec.to_json(), file=stream, flush=True)
    return rec


# ------------------------------------------------ spans inside the batched solve
#
# The switch is a torch profiler recording (`torch.profiler.profile`): with
# none, `span` returns one shared object that does nothing, `count` returns
# and `host_read` is `bool`, after one attribute check each. With one, the
# outermost span opens a record of its batch; spans and counters land in
# it, and it is kept when that span closes. Recording launches no kernel or
# copy and waits for nothing: a span's host times are the profiler's clock
# (Unix-epoch nanoseconds, `time.time_ns`), its device time a pair of CUDA
# timing events on the current stream, read only by `batch_records`, and a
# tensor counter is kept by reference and summed only there.

KEPT_BATCHES = 64


# The span of a run that no profiler records.
_OFF = contextlib.nullcontext()


class _Recorder:
    """The records of the last `KEPT_BATCHES` batches, and the one open now
    with its open spans (outermost first). One per process."""

    def __init__(self):
        self.records = collections.deque(maxlen=KEPT_BATCHES)
        self.record = None
        self.open = []
        self.span_ids = itertools.count(1)
        self.batch_ids = itertools.count(1)


_REC = _Recorder()


class _Span:
    __slots__ = ("name", "device", "entry", "stream", "events", "fn")

    def __init__(self, name: str, device):
        self.name, self.device = name, device

    def __enter__(self):
        rec = _REC
        if rec.record is None:
            rec.record = {"batch": next(rec.batch_ids), "spans": [], "counters": {},
                          "events": {}, "pending": []}
        e = self.entry = {"name": self.name, "id": next(rec.span_ids),
                          "parent": rec.open[-1]["id"] if rec.open else None,
                          "batch": rec.record["batch"], "start_ns": None, "end_ns": None,
                          "device_ms": None}
        rec.record["spans"].append(e)
        rec.open.append(e)
        cuda = self.device is not None and torch.device(self.device).type == "cuda"
        self.stream = torch.cuda.current_stream(self.device) if cuda else None
        self.events = None
        self.fn = torch.profiler.record_function(f"fi.{self.name}")
        e["start_ns"] = time.time_ns()
        self.fn.__enter__()
        if self.stream is not None:
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record(self.stream)
        return self

    def __exit__(self, *exc):
        rec, e = _REC, self.entry
        if self.events is not None:
            self.events[1].record(self.stream)
            rec.record["events"][e["id"]] = self.events
        self.fn.__exit__(*exc)
        e["end_ns"] = time.time_ns()
        rec.open.pop()
        if not rec.open:
            rec.records.append(rec.record)
            rec.record = None
        return False


def span(name: str, device=None):
    """A context manager recording span ``name`` of the open batch (its id,
    parent span and batch id, host start and end in ns on the profiler's
    clock) inside ``torch.profiler.record_function("fi.<name>")``; the
    outermost span opens the batch's record. With ``device`` a CUDA device,
    also the span's device ms between two timing events on its current
    stream. Without a recording profiler: one shared object doing
    nothing."""
    if not _torch_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, device)


def count(name: str, value, before: Optional[torch.Tensor] = None) -> None:
    """Add ``value`` to counter ``name`` of the open batch record: a Python
    int, or a tensor kept by reference and summed when read; with
    ``before``, the number of elements in which ``value`` exceeds it. Does
    nothing without a recording profiler or an open record."""
    if not _torch_profiler._is_profiler_enabled:
        return
    rec = _REC.record
    if rec is None:
        return
    counters = rec["counters"]
    if isinstance(value, int) and before is None:
        counters[name] = counters.get(name, 0) + value
    else:
        counters.setdefault(name, 0)
        rec["pending"].append((name, value, before))


def host_read(flag: torch.Tensor) -> bool:
    """``bool(flag)``: the one way the batched solve's loops block on a
    device flag. Recorded as a ``host_read`` span and counted in
    ``host_syncs`` while a profiler records a batch."""
    if not _torch_profiler._is_profiler_enabled or _REC.record is None:
        return bool(flag)
    with _Span("host_read", None):
        out = bool(flag)
    count("host_syncs", 1)
    return out


def _settle(record: dict) -> None:
    """Read a record's device times and sum its tensor counters, once."""
    spans = {s["id"]: s for s in record["spans"]}
    for sid, (start, end) in record["events"].items():
        end.synchronize()
        spans[sid]["device_ms"] = start.elapsed_time(end)
    record["events"] = {}
    counters = record["counters"]
    for name, value, before in record["pending"]:
        hits = value if before is None else value > before
        counters[name] += int(hits.sum())
    record["pending"] = []


def batch_records() -> list[dict]:
    """The records of the last `KEPT_BATCHES` batches that ran under a
    recording profiler, oldest first, as plain dicts: ``batch`` (its id),
    ``spans`` (each ``name``, ``id``, ``parent``, ``batch``, ``start_ns``,
    ``end_ns``, ``device_ms``: None for a host span) and ``counters`` (name
    → int)."""
    out = []
    for record in _REC.records:
        _settle(record)
        out.append({"batch": record["batch"],
                    "spans": [dict(s) for s in record["spans"]],
                    "counters": dict(record["counters"])})
    return out


def clear_records() -> None:
    """Forget every kept batch record."""
    _REC.records.clear()
