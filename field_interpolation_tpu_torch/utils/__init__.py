"""Observability of the port's solves (see `observe`)."""

from .observe import (
    PhaseCost,
    SolveRecord,
    batch_records,
    clear_records,
    cost_table,
    count,
    host_read,
    measure_marginal,
    op_cost,
    record_solve,
    roofline_bytes_per_apply,
    span,
    timed_block,
    vcycle_applies_per_iteration,
)

__all__ = [
    "PhaseCost",
    "SolveRecord",
    "batch_records",
    "clear_records",
    "cost_table",
    "count",
    "host_read",
    "measure_marginal",
    "op_cost",
    "record_solve",
    "roofline_bytes_per_apply",
    "span",
    "timed_block",
    "vcycle_applies_per_iteration",
]
