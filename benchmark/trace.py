"""A device trace over a sub-window of whole batches (``torch.profiler``).

Reads the raw events of the profile: device operations, the host's launch
calls, and what the host was doing while the device sat idle. A trace that
lost its device events (fewer kernels than ``KEPT`` of the launch calls, seen
on short windows in this repository before) is taken again, up to ``TRIES``
times; each try prints its kept share on standard error.
"""

from __future__ import annotations

import re
import sys
import time

import torch

KEPT = 0.5
TRIES = 3
LAUNCH = re.compile(r"^cu(da)?Launch(Cooperative)?Kernel(ExC|Ex)?(_v\d+)?$")
COPY = re.compile(r"Memcpy|Memset")
WINDOW = "benchmark_window"


def _events(prof):
    """(is_device, name, start µs, end µs) of the profile's raw events
    (building ``prof.events()``' tree takes minutes for large traces), and
    apart from them the user annotations (is_device, name, start, end)."""
    from torch.autograd import DeviceType
    out, marks = [], []
    for e in prof.profiler.kineto_results.events():
        dtype, name, t0, t1 = e.device_type(), e.name(), e.start_ns() / 1e3, e.end_ns() / 1e3
        if e.is_user_annotation():
            marks.append((dtype == DeviceType.CUDA, name, t0, t1))
        else:
            out.append((dtype == DeviceType.CUDA, name, t0, t1))
    return out, marks


def _merge(intervals):
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


class Trace:
    """What one traced sub-window of ``batches`` batches holds."""

    def __init__(self, events, window, batches):
        lo, hi = window
        self.batches = batches
        self.window_s = (hi - lo) / 1e6
        self.device = [(n, max(a, lo), min(b, hi)) for d, n, a, b in events
                       if d and b > lo and a < hi]
        self.host = [(n, a, b) for d, n, a, b in events
                     if not d and b > lo and a < hi and n != WINDOW]
        self.kernels = [e for e in self.device if not COPY.search(e[0])]
        self.launch_calls = sum(bool(LAUNCH.match(n)) for n, _, _ in self.host)
        self.kept = len(self.kernels) / max(1, self.launch_calls)
        self.busy_intervals = _merge((a, b) for _, a, b in self.device)
        self.busy_s = sum(b - a for a, b in self.busy_intervals) / 1e6
        self._lo, self._hi = lo, hi

    def device_seconds(self, pattern=None, exclude=None):
        """Device time of the operations whose name matches ``pattern`` (all
        if None) and not ``exclude``."""
        return sum(b - a for n, a, b in self.device
                   if (pattern is None or re.search(pattern, n))
                   and (exclude is None or not re.search(exclude, n))) / 1e6

    def top_device_ops(self, k=10):
        tot = {}
        for n, a, b in self.device:
            tot[n] = tot.get(n, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()), key=lambda e: -e[1])[:k]

    def idle_gaps(self, k=10):
        """The device's idle time in the window, summed by the innermost
        host operation running at each gap's middle."""
        gaps, t = [], self._lo
        for a, b in self.busy_intervals:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self._hi > t:
            gaps.append((t, self._hi))
        tot = {}
        for a, b in gaps:
            mid = (a + b) / 2
            inner = [(s, n) for n, s, e in self.host if s <= mid <= e]
            name = max(inner)[1] if inner else "host between recorded ops"
            tot[name] = tot.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in tot.items()), key=lambda e: -e[1])[:k]


def trace_batches(run_batch, batches):
    """Run ``run_batch(i)`` for i < ``batches`` under the profiler, after one
    warm-up step of the profiler, until a trace keeps its device events."""
    from torch.profiler import ProfilerActivity, profile, record_function, schedule
    for attempt in range(1, TRIES + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     schedule=schedule(wait=0, warmup=1, active=1, repeat=1)) as prof:
            torch.ones(1, device="cuda").add_(1)
            torch.cuda.synchronize()
            prof.step()
            t0 = time.perf_counter()
            with record_function(WINDOW):
                for i in range(batches):
                    run_batch(i)
                torch.cuda.synchronize()
            host_s = time.perf_counter() - t0
            prof.step()
        events, marks = _events(prof)
        window = [(a, b) for d, n, a, b in marks + events if n == WINDOW and not d]
        if not window:
            raise RuntimeError("the trace holds no window annotation")
        trace = Trace(events, window[0], batches)
        print(f"trace try {attempt}: kept share {trace.kept:.4f} ({len(trace.kernels)} kernels "
              f"for {trace.launch_calls} launch calls), window {trace.window_s:.6f} s "
              f"(host clock {host_s:.6f} s), busy {trace.busy_s:.6f} s", file=sys.stderr)
        if trace.kept >= KEPT and trace.busy_s > 0:
            return trace
    raise RuntimeError(f"the device trace lost its events in {TRIES} tries")
