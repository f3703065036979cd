"""Weight and solver configuration: the port's copy of
``field_interpolation_tpu.weights``.

Same fields, same defaults (tests/test_torch_config.py holds them equal), so
one configuration drives either package. The reference's comments explain
how each default was chosen; the port documents only what each field does
here. Every multigrid option runs on the port's kernels; ``debug=True``
runs the checked pipeline of `sdf_from_points` and `interpolate`
(debugging.py).
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Weights:
    data_pos: float = 1.0
    data_gradient: float = 1.0
    model_0: float = 0.0
    model_1: float = 0.0
    model_2: float = 1.0
    model_3: float = 0.0

    def active_orders(self) -> tuple[int, ...]:
        """Smoothness orders with nonzero weight."""
        ws = (self.model_0, self.model_1, self.model_2, self.model_3)
        return tuple(k for k, w in enumerate(ws) if w != 0.0)

    def model_weight(self, order: int) -> float:
        return (self.model_0, self.model_1, self.model_2, self.model_3)[order]

    def scaled_model(self, factors: tuple[float, float, float, float]) -> "Weights":
        return dataclasses.replace(
            self,
            model_0=self.model_0 * factors[0],
            model_1=self.model_1 * factors[1],
            model_2=self.model_2 * factors[2],
            model_3=self.model_3 * factors[3],
        )


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """PCG configuration, field for field the reference's."""

    tol: float = 1e-6          # relative residual target: ||b - Ax|| <= tol * ||b||
    maxiter: int = 2000
    preconditioner: str = "multigrid"   # "none" | "jacobi" | "multigrid"
    # "auto": the hand-written kernels on CUDA tensors, their plain versions
    # on CPU tensors; "xla": plain torch ops everywhere (a user's choice, the
    # name kept from the reference); "pallas": the same as "auto" here.
    backend: str = "auto"
    mg_pre_smooth: int = 3
    mg_post_smooth: int = 3
    mg_smoother: str = "jacobi"      # "jacobi" | "chebyshev" | "chebyshev4"
    mg_cheb_ratio: float = 20.0
    mg_coarse_data: str = "lumped"   # "lumped" | "galerkin"
    mg_cycle: str = "auto"           # "auto" | "v" | "w"
    mg_wcycle_depth: int = 99        # transitions that double (mg_cycle="w")
    pcg_chunk: int = 1               # read by the reference's TPU kernel only
    mg_coarse_solver: str = "dense"  # "dense" | "jacobi"
    mg_coarse_iters: int = 32        # used when mg_coarse_solver == "jacobi"
    mg_omega: float = 0.95     # Jacobi damping: step τ = 2·mg_omega/ρ̂(D⁻¹A)
    mg_fine_operator: str = "auto"   # "auto" | "exact" | "lumped"
    mg_min_size: int = 16      # stop coarsening when min(shape) <= this
    # Recompute the true residual every k iterations inside `pcg` (0 = off;
    # every exit is verified against a fresh true residual either way).
    recompute_every: int = 0
    max_restarts: int = 8      # CG segments of the safeguarded stopping rule
    refine_rounds: int = 6     # outer f64 rounds of solve_refined
    # Checked inputs, field and problem in sdf_from_points / interpolate
    # (debugging.py; solved with backend="xla"); ignored elsewhere.
    debug: bool = False
