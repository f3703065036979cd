"""Host-clock ms a batch in the solve stage (``solve_batch`` /
``solve_refined_batch``, multigrid set-up included, ending synchronised),
mean over every batch of a traced run's window."""


def read(run):
    spans = run.spans.get("solve")
    return 1e3 * sum(spans) / len(spans) if spans else None
