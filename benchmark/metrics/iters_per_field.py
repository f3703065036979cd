"""CG iterations a field (``SolveInfo.iterations``: every inner iteration
of every round), mean over every field of a traced run's window."""


def read(run):
    return run.iterations / run.fields if run.fields else None
