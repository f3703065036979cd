"""The port's own kernels, by the names they carry in a device trace
(``field_interpolation_tpu_torch/csrc``). Every other device operation is
a plain torch op (or a library's kernel that plain torch calls)."""

SEGMENT = r"pcg_segment"
SMOOTHING = r"smooth_phase_kernel|multisweep2d"
OWN = r"pcg_segment|mg_cycle2d|multisweep2d|smooth_phase_kernel|normal_apply|ext_level"
