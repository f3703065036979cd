"""Device ms a batch of operations that are not the port's own kernels
(assembly, multigrid set-up, transfers, CG glue, float64 refinement, copies),
from the trace's sub-window."""

from benchmark.kernels import OWN


def read(run):
    t = run.trace
    if not t:
        return None
    s = t.device_seconds(exclude=OWN)
    return 1e3 * s / t.batches if s > 0 else None
