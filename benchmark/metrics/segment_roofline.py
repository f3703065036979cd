"""The batched CG segment's share of its roofline, in %: the least time the
traced batches' segment work needs on the card (`benchmark.work`, counted
from the configuration's level shapes and the lanes' iterations, never from
the program's operands; the bytes once a batch for each lane that iterates)
over the device time of ``pcg_segment*`` kernels in the trace. Nothing
where no segment kernel ran."""

from benchmark import work
from benchmark.kernels import SEGMENT


def read(run):
    t = run.trace
    if not t or not run.trace_iterations:
        return None
    kernel_s = t.device_seconds(SEGMENT)
    if kernel_s <= 0:
        return None
    cfg, solver = run.cell.config, run.cell.solver
    shapes = work.level_shapes(cfg["grid"], solver.get("mg_min_size", 16))
    orders = [k for k in range(4) if cfg["weights"].get(f"model_{k}", 0.0)]
    nu = solver.get("mg_pre_smooth", 3)
    flops = run.trace_iterations * work.lane_iteration_flops(shapes, orders, nu)
    nbytes = run.trace_lanes * work.lane_bytes(shapes)
    least, _ = work.least_seconds(nbytes, flops)
    return 100.0 * least / kernel_s
