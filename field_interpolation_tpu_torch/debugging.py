"""Debug-mode checks: ``SolverConfig(debug=True)``.

Counterpart of ``field_interpolation_tpu.debugging``. The reference runs
its assemble + solve under JAX's ``checkify``: user checks on the inputs and
automatic float checks on every primitive, raised as one Python exception.
The port runs eagerly, so each check here is a plain test that raises
``ValueError`` with the reference's message the moment it fails. JAX's
float checks (NaN or Inf produced by any primitive) have no eager
counterpart; the debug pipeline (`sdf._debug_pipeline`) covers what they
catch at the pipeline's edges instead: the inputs before assembly
(`check_sample_inputs`), the assembled problem (``validate_problem`` tests
the data coefficients and ``b`` for finiteness) and the solved field
(`check_solution`).

Debug mode solves with ``backend="xla"`` (plain torch ops, no hand-written
kernel), as the reference does; production solves keep the flag off.
"""

from __future__ import annotations

from typing import Optional

import torch

from .grid import Grid


def _check(ok: torch.Tensor, message: str) -> None:
    if not bool(ok):
        raise ValueError(message)


def check_sample_inputs(
    grid: Grid,
    positions: torch.Tensor,
    values: Optional[torch.Tensor] = None,
    gradients: Optional[torch.Tensor] = None,
    point_weights: Optional[torch.Tensor] = None,
) -> None:
    """Argument checks, in the reference's order: everything finite,
    positions inside the lattice domain, point weights non-negative."""
    _check(torch.isfinite(positions).all(), "debug: non-finite sample position")
    shape = torch.as_tensor(grid.shape, dtype=positions.dtype, device=positions.device)
    _check(((positions >= 0.0) & (positions <= shape - 1.0)).all(),
           "debug: sample position outside the lattice "
           "(production mode zero-weights these rows)")
    if values is not None:
        _check(torch.isfinite(values).all(), "debug: non-finite sample value")
    if gradients is not None:
        _check(torch.isfinite(gradients).all(), "debug: non-finite sample gradient")
    if point_weights is not None:
        _check(torch.isfinite(point_weights).all(), "debug: non-finite point weight")
        _check((point_weights >= 0.0).all(),
               "debug: negative point weight (operator loses "
               "positive-semidefiniteness)")


def check_solution(x: torch.Tensor) -> None:
    _check(torch.isfinite(x).all(), "debug: solver produced a non-finite field")


def checked_call(fn, *args):
    """``fn(*args)``: the counterpart of the reference's checkified call, for
    code written against it. Eager checks inside ``fn`` raise ``ValueError``
    where they fail, so there is nothing to collect and throw."""
    return fn(*args)
