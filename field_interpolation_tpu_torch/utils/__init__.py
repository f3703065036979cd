"""Observability of the port's solves (see `observe`)."""

from .observe import (
    PhaseCost,
    SolveRecord,
    cost_table,
    measure_marginal,
    op_cost,
    record_solve,
    roofline_bytes_per_apply,
    timed_block,
    vcycle_applies_per_iteration,
)

__all__ = [
    "PhaseCost",
    "SolveRecord",
    "cost_table",
    "measure_marginal",
    "op_cost",
    "record_solve",
    "roofline_bytes_per_apply",
    "timed_block",
    "vcycle_applies_per_iteration",
]
