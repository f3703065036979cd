"""Host-clock ms a batch in the assembly stage (``assemble_*_batch``, after
a device sync), mean over every batch of a traced run's window."""


def read(run):
    spans = run.spans.get("assemble")
    return 1e3 * sum(spans) / len(spans) if spans else None
