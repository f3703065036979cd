"""Float64 refinement rounds a field (the ``refine_rounds`` counter: each
lane's rounds at the exit of `solver.solve_refined_lanes`), over the traced
batches' fields; nothing where no refinement ran."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    rounds = records.counter(recs, "refine_rounds") if recs else None
    return rounds / (len(recs) * run.cell.lanes) if rounds is not None else None
