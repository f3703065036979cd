"""The benchmark of the PyTorch and CUDA port (``field_interpolation_tpu_torch``)
on one H100. The command is ``python3 benchmark/run.py``; see PERF.md."""
