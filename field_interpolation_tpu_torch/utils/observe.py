"""Observability: per-solve records, timing, roofline accounting.

Counterpart of ``field_interpolation_tpu.utils.observe``: structured
per-solve records (iterations, relative residual, wall time, achieved GB/s
against the card's memory rate) as Python objects and optional JSON lines,
the chained marginal timer, and per-phase cost tables. The reference's
``xla_cost`` reads XLA's compiled cost model, which torch has not; `op_cost`
takes its place by counting the aten ops of one run of the phase.

The rates are one NVIDIA H100's (SXM, NVIDIA's data sheet): 3.35 TB/s of
HBM and 67 TFLOP/s of float32 outside the tensor cores, at its full 700 W
power limit; a card set below it runs slower (``nvidia-smi
--query-gpu=name,power.limit``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Optional, TextIO

import torch
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
