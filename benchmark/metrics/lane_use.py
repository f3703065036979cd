"""The share of lanes that work in the solver loop's lane-wide launches, in
%: 100 · Σ ``lanes_working`` / Σ ``lanes_offered`` over the traced batches
(per batched segment launch, the lanes whose iteration count grew of all
B; per `pcg_batch` iteration, the lanes still iterating of all B)."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    if not recs:
        return None
    offered = records.counter(recs, "lanes_offered")
    working = records.counter(recs, "lanes_working")
    return 100.0 * working / offered if offered and working is not None else None
