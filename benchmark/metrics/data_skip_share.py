"""The share of level 0's runs of four nodes whose nine data planes the
batched segment's applies do not load, in %: 100 · (1 − Σ ``data_runs`` /
Σ ``runs_offered``) over the traced batches (per segment launch, the runs
whose data is not all zero in the lanes that iterate, against B times a
lane's runs). Nothing where the program keeps no such counters."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    if not recs:
        return None
    offered = records.counter(recs, "runs_offered")
    data = records.counter(recs, "data_runs")
    return 100.0 * (1.0 - data / offered) if offered and data is not None else None
