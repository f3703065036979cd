"""The solver loop's blocking flag reads a batch (the ``host_syncs``
counter of `utils.observe.host_read`), over the traced batches."""

from benchmark import records


def read(run):
    recs = records.traced(run)
    syncs = records.counter(recs, "host_syncs") if recs else None
    return syncs / len(recs) if syncs is not None else None
