"""The share of the traced sub-window in which no operation ran on the
device, in %: 100·(1 − busy / window). A trace that lost its device events
is taken again before it gets here (`trace.KEPT`)."""


def read(run):
    t = run.trace
    return 100.0 * (1.0 - t.busy_s / t.window_s) if t and t.busy_s > 0 else None
