"""Device idle ms a batch that the solver loop's flag reads cost the card:
the gaps between the trace's busy intervals that open while the host is
inside a ``host_read`` span (the span's host times and the trace share the
profiler's clock), over the traced batches."""

from bisect import bisect_right

from benchmark import records


def read(run):
    recs = records.traced(run)
    reads = sorted((s["start_ns"] / 1e3, s["end_ns"] / 1e3)
                   for s in records.spans(recs, "host_read")) if recs else []
    if not reads:
        return None
    starts = [a for a, _ in reads]
    busy = run.trace.busy_intervals
    idle_us = 0.0
    for (_, end), (nxt, _) in zip(busy, busy[1:]):
        i = bisect_right(starts, end) - 1  # reads never overlap: the last one begun
        if i >= 0 and end <= reads[i][1]:
            idle_us += nxt - end
    return idle_us / 1e3 / len(recs)
