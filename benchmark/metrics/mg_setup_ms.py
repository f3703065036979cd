"""Device ms a batch of the multigrid set-up (``mg_setup`` spans in
`solver.solve_lanes` / `solve_refined_lanes`: the fused operands with the
coarsest levels' float64 Cholesky, or the cycle's `prepare_mg`), between
each span's two CUDA timing events, over the traced batches."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    ms = records.device_ms(records.spans(recs, "mg_setup")) if recs else None
    return sum(ms) / len(recs) if ms else None
