"""One run of one cell: set-up, warm-up, the measured window, the trace, the
check. `run.py` is the command; the tests drive `run_cell` on the CPU. The
cell's traffic names the adapter that calls the program
(``benchmark/adapters/<adapter>.py``); the configuration names the check.

The window is a closed loop: one caller sends the next batch when the last
one's fields are on the device and synchronised, cycling through a pool of
distinct batches made at set-up. The window holds whole batches only; it
closes after the batch that ends past ``seconds``.
"""

from __future__ import annotations

import dataclasses
import gc
import os
import statistics
import subprocess
import sys
import time

import torch

from . import check, trace
from .cells import Cell, module, reader
from .traffic import make_pool

SAMPLES = "clocks.sm,power.draw,temperature.gpu"


def process_age() -> float:
    """Seconds since this process started (Linux /proc), for ``setup_s``."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


class Sampler:
    """``nvidia-smi`` sampling the card's SM clock, power and temperature
    about twice a second beside the run; stopped and waited for by `stop`."""

    def __init__(self, device_index: int):
        self.proc = subprocess.Popen(
            ["nvidia-smi", f"--query-gpu={SAMPLES}", "--format=csv,noheader,nounits",
             "-lms", "500", "-i", str(device_index)],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        self.t0 = time.perf_counter()

    def stop(self) -> list:
        self.proc.terminate()
        try:
            out, _ = self.proc.communicate(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            out, _ = self.proc.communicate()
        rows = []
        for line in out.splitlines():
            try:
                rows.append([float(v) for v in line.split(",")])
            except ValueError:
                continue
        return rows


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


@dataclasses.dataclass
class Run:
    """What a run measured, for the per-layer readers."""
    cell: Cell
    spans: dict
    fields: int
    iterations: int
    trace: object = None
    trace_iterations: int = 0
    trace_lanes: int = 0


def _print_unconverged(flags, iters, pool_size):
    """Each field the program flagged unconverged in the window: its batch,
    pool index, lane and iterations (the check fails such a run)."""
    for k, (conv, it) in enumerate(zip(flags, iters)):
        for lane in (~conv).nonzero().flatten().tolist():
            print(f"unconverged: batch {k} (pool {k % pool_size}) lane {lane}, "
                  f"{int(it[lane])} iterations", file=sys.stderr)


def _summary(rows, col):
    vals = [r[col] for r in rows]
    return (f"{min(vals):g}/{statistics.median(vals):g}/{max(vals):g}" if vals else "none")


def run_cell(cell: Cell, seed: int, seconds: float, traced: bool, device) -> dict:
    """One run; returns the result line's object (the check's numbers last)."""
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    tr = cell.traffic
    program = module("adapters", tr["adapter"]).Program(cell)
    pool = make_pool(cell.config, tr, seed, device)
    P = len(pool)
    smi = Sampler(torch.device(device).index or 0) if cuda else None
    try:
        # Warm-up on the cell's own shapes and traffic, counted in set-up:
        # the first batch loads every kernel the route runs.
        for k in range(int(tr["warmup_batches"])):
            program(*pool[k % P])
            sync()
        keep = check.Reservoir(int(tr["check_batches"]), seed)
        flags, iters, times = [], [], []
        spans = {name: [] for name in program.spans}
        setup_s = process_age()
        # The set-up's objects leave the collector's view; the collector stays
        # on, since the cycle route leaves each batch's state in reference
        # cycles (with it off, a 16-lane 128^3 window ran out of memory).
        gc.collect()
        gc.freeze()
        sync()
        t0 = t = time.perf_counter()
        k = 0
        while True:
            pts, nrm = pool[k % P]
            x, conv, it = program.staged(pts, nrm, sync, spans) if traced else program(pts, nrm)
            sync()
            t1 = time.perf_counter()
            times.append(t1 - t)
            t = t1
            flags.append(conv)
            iters.append(it)
            keep.offer((k % P, x))
            k += 1
            if t1 - t0 >= seconds:
                break
        window_s = t - t0
        window_rows = ((t0 - smi.t0) * 2, (t - smi.t0) * 2) if smi else None
        gc.unfreeze()
        batches = k
        smi_rows = smi.stop() if smi else []
        smi = None
    finally:
        if smi is not None:
            smi.stop()

    B = cell.lanes
    run = Run(cell=cell, spans=spans, fields=batches * B,
              iterations=int(sum(int(i.sum()) for i in iters)))
    _print_unconverged(flags, iters, P)
    if traced:
        t_iters = []

        def traced_batch(i):
            if i == 0:  # a trace taken again counts its own batches only
                t_iters.clear()
            pts, nrm = pool[(batches + i) % P]
            t_iters.append(program(pts, nrm)[2])

        run.trace = trace.trace_batches(traced_batch, int(tr["trace_batches"]))
        run.trace_iterations = int(sum(int(i.sum()) for i in t_iters))
        run.trace_lanes = int(sum(int((i > 0).sum()) for i in t_iters))
    peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0

    # The program's state is freed; the check runs on what the window kept.
    kept = [(j, x) for j, x in keep.items]
    del keep, x, conv, it, program
    if cuda:
        torch.cuda.empty_cache()
    correct, numbers, lanes, failed = check.judge(cell, pool, kept, flags,
                                                  block=int(tr["check_block"]))
    attempted = batches * B

    if smi_rows:
        win = smi_rows[int(window_rows[0]):int(window_rows[1]) + 1]
        print(f"card {card_line()}; samples (sm MHz, W, C) every 0.5 s from set-up on, the "
              f"window from sample {int(window_rows[0])}: {smi_rows}", file=sys.stderr)
        print(f"card in the window: sm clock min/median/max {_summary(win, 0)} MHz, power "
              f"{_summary(win, 1)} W, temperature {_summary(win, 2)} C", file=sys.stderr)
    print(f"window: {batches} batches of {B} lanes in {window_s:.6f} s, pool {P}, "
          f"batch ms min/median/max {1e3 * min(times):.4f}/"
          f"{1e3 * statistics.median(times):.4f}/{1e3 * max(times):.4f}", file=sys.stderr)

    metrics = {}
    if not traced:
        values = {"fields_per_s": attempted / window_s,
                  "batch_ms_p95": 1e3 * statistics.quantiles(times, n=20)[-1]
                  if len(times) >= 2 else 1e3 * times[0],
                  "setup_s": setup_s}
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = reader(m["name"])(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = {"device_ops": run.trace.top_device_ops(),
                               "idle_gaps": run.trace.idle_gaps()}
    result["checks"] = check.as_json(numbers)
    check.print_numbers(numbers, lanes)
    return result
