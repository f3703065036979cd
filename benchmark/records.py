"""The program's own records of the traced batches.

The port keeps a record of every batch that runs under a recording torch
profiler (`field_interpolation_tpu_torch.utils.observe.batch_records`: its
spans with host times on the profiler's clock and device ms, and its
counters), so the last ``trace.batches`` records are the batches of the
trace's last try. A tree of the port that keeps none gives None, and the
metrics that read them are left out of its line.
"""

from __future__ import annotations


def program_records():
    """The port's batch records, oldest first, or None where it keeps none."""
    from field_interpolation_tpu_torch.utils import observe
    read = getattr(observe, "batch_records", None)
    return read() if read is not None else None


def traced(run):
    """The records of the run's traced batches, or None."""
    t = run.trace
    if not t:
        return None
    recs = program_records()
    if not recs or len(recs) < t.batches:
        return None
    return recs[-t.batches:]


def spans(records, name):
    """Every span called ``name`` in ``records``."""
    return [s for r in records for s in r["spans"] if s["name"] == name]


def device_ms(spans_):
    """The spans' device ms, or None where any has none (host spans, CPU)."""
    ms = [s["device_ms"] for s in spans_]
    return None if not ms or None in ms else ms


def counter(records, name):
    """The sum of counter ``name`` over ``records``, or None where no record
    has it."""
    vals = [r["counters"][name] for r in records if name in r["counters"]]
    return sum(vals) if vals else None
