"""Device ms a batch of the smoothing kernels (the per-sweep
``smooth_phase_kernel`` and the multi-sweep ``multisweep2d_kernel``, lane
forms included), from the trace's sub-window; nothing where they did not
run."""

from benchmark.kernels import SMOOTHING


def read(run):
    t = run.trace
    if not t:
        return None
    s = t.device_seconds(SMOOTHING)
    return 1e3 * s / t.batches if s > 0 else None
