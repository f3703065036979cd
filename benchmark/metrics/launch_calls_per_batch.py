"""The host's kernel launch calls a batch (``cudaLaunchKernel``,
``cudaLaunchCooperativeKernel`` and ``cuLaunchKernel*``) in
the trace's sub-window."""


def read(run):
    t = run.trace
    return t.launch_calls / t.batches if t and t.launch_calls else None
