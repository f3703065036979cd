"""Device ms a batch of the refinement rounds' own work (``refine_round``
spans less their ``inner_solve`` children: the float64 residual,
``apply64_delta``, the casts and the lane masks), over the traced batches;
nothing where no refinement ran."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    if not recs:
        return None
    rounds = records.spans(recs, "refine_round")
    ids = {s["id"] for s in rounds}
    outer = records.device_ms(rounds)
    inner = [s for s in records.spans(recs, "inner_solve") if s["parent"] in ids]
    inner_ms = records.device_ms(inner) if inner else []
    if outer is None or inner_ms is None:
        return None
    return (sum(outer) - sum(inner_ms)) / len(recs)
