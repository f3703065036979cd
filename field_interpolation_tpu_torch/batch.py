"""Batched solves: many independent fields at once (torch).

Counterpart of ``field_interpolation_tpu.batch`` (BASELINE config 3:
"Batched 2D: 1024 independent 128² fields solved via vmap"). The reference
maps the whole assemble + solve pipeline over a leading batch axis with
``vmap``; here the axis is written out. Every input and output leads with
B, `SolveInfo` fields are [B] tensors, and the semantics are those of
``vmap`` over the single-field function: each lane converges, stops and is
frozen on its own, and other lanes running longer never change a finished
lane's result.

Which way a batch goes is decided from the grid and config before anything
is built (`solve_route`):

* ``"fused"`` — where a single field takes the fused 2-D segment (2-D,
  multigrid, dense coarsest, ν_pre = ν_post, float32, inside `fits_vmem`
  and the fused-operand budget) and the batch is large enough (config 3
  is here): the multigrid setup is
  built for all lanes in one pass (per-lane Gershgorin bounds, steps,
  schedules and a batched float64 Cholesky of the coarsest levels), and
  each outer round is ONE `ops.pcg.fused_pcg_solve_batch` launch for all
  lanes, one block per lane, plus one `fused_normal_apply_batch`;
* ``"pcg"`` — ``preconditioner="jacobi"`` or ``"none"``: `solver.pcg_batch`
  with per-lane scalars and masks through `fused_normal_apply_batch`;
* ``"cycle"`` — every other multigrid config (3-D grids, 2-D grids past the
  gate or the fused-operand budget, ν_pre ≠ ν_post, the Jacobi coarsest
  solve, ``backend="xla"``): `solver.pcg_batch` with the batched apply and
  the multigrid cycle of all lanes at once, the reference's cycle under
  ``vmap`` (`multigrid.make_vcycle_preconditioner` on lanes): each
  smoothing phase ONE `fused_smooth` / `fused_smooth_2d` call, or each
  whole cycle ONE `fused_wcycle_2d` / `fused_vcycle_2d` call, for every
  lane, transfers and the dense coarsest solve batched plain ops;
* ``"lanes"`` — where one single-field solve per lane was measured faster
  (`_cycle_wins`, `_batch_wins`): a fused-path batch of fewer than 2 lanes,
  or than one lane per 16384 nodes of a field, and a single lane of any
  other multigrid config: lane by lane through the single-field solve and
  its kernels.

Assembly is batched in every route: one scatter for all lanes.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from .grid import Grid
from .multigrid import _fused_gate, fused_levels_ok, level_shapes
from .operators import Problem, assemble_lanes
from .sdf import PreciseProblem, assemble_precise_lanes
from .solver import (SolveInfo, _downcast_problem, solve, solve_lanes,
                     solve_refined, solve_refined_lanes)
from .weights import SolverConfig, Weights


def _dense_coarsest_ok(grid: Grid, config: SolverConfig, B: int) -> bool:
    """The reference's rule (batch.py:24-40; a TPU memory policy, kept for
    parity): keep the dense-inverse coarsest level for B lanes while the
    per-lane float32 inverses [B, n_c, n_c] stay ≤ 768 MiB, else the batch
    falls back to the iterative (Jacobi) coarsest solve. An empty hierarchy
    makes the fine grid the coarsest level."""
    shapes = level_shapes(grid.shape, config.mg_min_size, config.mg_coarse_solver)
    n_c = math.prod(shapes[-1] if shapes else grid.shape)
    return B * n_c * n_c * 4 <= 768 * 1024 * 1024


def _batch_config(grid: Grid, config: SolverConfig, B: int) -> SolverConfig:
    """``config`` with the coarsest solve swapped to Jacobi exactly where
    the reference swaps it (batch.py:82-86, 121-126)."""
    if (config.preconditioner == "multigrid" and config.mg_coarse_solver == "dense"
            and not _dense_coarsest_ok(grid, config, B)):
        return dataclasses.replace(config, mg_coarse_solver="jacobi")
    return config


# The batched segment runs a lane in one block, so its time grows with a
# lane's nodes, while a single-field solve spreads its lane over the card
# and costs the host ~3.6-5.9 ms a field at 32²-256². On the H100 the batch
# was faster from B = 2 at 32², 64² and 128² and from B = 4 at 256²
# (batch_probe.py --crossover): it takes B ≥ 2 lanes and ≥ 1 lane per
# _NODES_PER_LANE nodes of a field.
_NODES_PER_LANE = 16384


def _batch_wins(grid: Grid, B: int) -> bool:
    """Whether B lanes of ``grid`` go faster through the batched segment
    than one single-field solve each."""
    return B >= 2 and B * _NODES_PER_LANE >= math.prod(grid.shape)


# The batched cycle against one single-field solve per lane (NVIDIA H100
# 80GB HBM3 at 700 W; batch_probe.py --crossover cycle, B = 1-16 at 32³,
# 64³, 128³ and 496²): faster from B = 2 on every grid (0.63-0.68× the time
# there), slower at B = 1 (1.16-1.80×: pcg_batch's per-lane bookkeeping).
# So the rule needs B alone.
def _cycle_wins(B: int) -> bool:
    """Whether B lanes go faster through the batched cycle than one
    single-field solve each."""
    return B >= 2


def solve_route(problems: Problem, config: SolverConfig) -> str:
    """The route ("fused", "cycle", "pcg" or "lanes") a batch of ``problems``
    takes under ``config`` (after `_batch_config`), from the grid, dtype,
    config and number of lanes alone: the batched fused segment where a
    single field takes the fused segment (`solver._fused_solver_ops`:
    `multigrid._fused_gate` and `multigrid.fused_levels_ok`) and the batch
    is large enough to beat a single-field solve per lane (`_batch_wins`);
    the batched cycle for every other multigrid config where it beats one
    (`_cycle_wins`)."""
    if config.preconditioner != "multigrid":
        return "pcg"
    B = _lanes(problems)
    if (config.backend != "xla" and _fused_gate(problems, config)
            and fused_levels_ok(problems.grid.shape, config)):
        return "fused" if _batch_wins(problems.grid, B) else "lanes"
    return "cycle" if _cycle_wins(B) else "lanes"


def _lanes(problems) -> int:
    return (problems.b64 if hasattr(problems, "b64") else problems.b).shape[0]


def lane(problems, i: int):
    """Lane ``i`` of a batched Problem or PreciseProblem, as one field's."""
    def cut(obj):
        return dataclasses.replace(obj, **{
            f.name: getattr(obj, f.name)[i] for f in dataclasses.fields(obj)
            if isinstance(getattr(obj, f.name), torch.Tensor)})
    if isinstance(problems, PreciseProblem):
        return dataclasses.replace(cut(problems), p32=cut(problems.p32))
    return cut(problems)


def _by_lane(solve_fn, problems, config: SolverConfig,
             x0: Optional[torch.Tensor]) -> tuple[torch.Tensor, SolveInfo]:
    """The single-field ``solve_fn`` on each lane in turn, stacked."""
    outs = [solve_fn(lane(problems, i), config, None if x0 is None else x0[i])
            for i in range(_lanes(problems))]
    infos = [info for _, info in outs]
    return torch.stack([x for x, _ in outs]), SolveInfo(
        iterations=torch.stack([i.iterations.to(torch.int32) for i in infos]),
        rel_residual=torch.stack([i.rel_residual for i in infos]),
        converged=torch.stack([i.converged for i in infos]))


def _check_lanes(grid: Grid, positions, values, gradients, point_weights) -> None:
    if positions.ndim != 3 or positions.shape[-1] != grid.ndim:
        raise ValueError(f"positions must be [B, n, {grid.ndim}] for grid {grid.shape}, "
                         f"got {tuple(positions.shape)}")
    B, n = positions.shape[:2]
    want = {"values": (values, (B, n)),
            "gradients": (gradients, (B, n, grid.ndim)),
            "point_weights": (point_weights, (B, n))}
    for name, (t, shape) in want.items():
        if t is not None and tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got {tuple(t.shape)}")


def assemble_batch(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                       # [B, n, D]
    values: torch.Tensor,                          # [B, n]
    gradients: Optional[torch.Tensor] = None,      # [B, n, D]
    point_weights: Optional[torch.Tensor] = None,  # [B, n]
    with_gradient: bool = True,
) -> Problem:
    """Assemble B independent problems in one pass (one scatter for all
    lanes); the returned Problem's leaves lead with B."""
    if gradients is None or not with_gradient:
        gradients = None
    _check_lanes(grid, positions, values, gradients, point_weights)
    return assemble_lanes(grid, weights, positions, values, gradients, point_weights)


def solve_batch(
    problems: Problem,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,             # [B, *grid]
) -> tuple[torch.Tensor, SolveInfo]:
    """Solve B problems (BASELINE config 3); ``x0`` warm-starts every lane.
    The dense coarsest level stays while the per-lane inverses fit
    (`_dense_coarsest_ok`). Returns (x [B, *grid], SolveInfo of [B])."""
    config = _batch_config(problems.grid, config, _lanes(problems))
    route = solve_route(problems, config)
    if route == "lanes":
        return _by_lane(solve, problems, config, x0)
    return solve_lanes(problems, config, x0, fused=route == "fused")


def solve_refined_batch(
    problems64,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,             # [B, *grid]
) -> tuple[torch.Tensor, SolveInfo]:
    """Batched mixed-precision solves to a TRUE ≤ tol residual per lane:
    `solver.solve_refined` over a PreciseProblem from
    `assemble_precise_batch` or a Problem assembled in float64, each lane
    with its own inner tolerance, rounds and exit. ``x0`` warm-starts every
    lane (the outer float64 loop starts from its true residual, so a good
    start skips whole refinement rounds)."""
    p32 = problems64.p32 if hasattr(problems64, "p32") else _downcast_problem(problems64)
    config = _batch_config(p32.grid, config, _lanes(problems64))
    route = solve_route(p32, config)
    if route == "lanes":
        return _by_lane(solve_refined, problems64, config, x0)
    return solve_refined_lanes(problems64, config, x0, fused=route == "fused")


def assemble_precise_batch(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                       # [B, n, D]
    values: torch.Tensor,                          # [B, n]
    gradients: Optional[torch.Tensor] = None,      # [B, n, D]
    point_weights: Optional[torch.Tensor] = None,  # [B, n]
) -> PreciseProblem:
    """Batched mixed-precision assembly: a PreciseProblem whose leaves lead
    with B (`sdf.assemble_precise` on every lane, one float32 and one
    float64 scatter for all lanes)."""
    _check_lanes(grid, positions, values, gradients, point_weights)
    return assemble_precise_lanes(grid, weights, positions, values, gradients,
                                  point_weights)


def sdf_from_points_precise_batch(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                       # [B, n, D]
    normals: torch.Tensor,                         # [B, n, D]
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,             # [B, *grid]
) -> tuple[torch.Tensor, SolveInfo]:
    """B SDF reconstructions, each to a TRUE ≤ tol relative residual against
    its float64 normal equations (batched `sdf.sdf_from_points_precise`).
    Returns (fields [B, *grid] float64, SolveInfo of [B])."""
    values = torch.zeros(positions.shape[:2], dtype=torch.float32,
                         device=positions.device)
    pp = assemble_precise_batch(grid, weights, positions, values, gradients=normals,
                                point_weights=point_weights)
    return solve_refined_batch(pp, config, x0)


def sdf_from_points_batch(
    grid: Grid,
    weights: Weights,
    positions: torch.Tensor,                       # [B, n, D]
    normals: torch.Tensor,                         # [B, n, D]
    point_weights: Optional[torch.Tensor] = None,
    config: SolverConfig = SolverConfig(),
    x0: Optional[torch.Tensor] = None,             # [B, *grid]
) -> tuple[torch.Tensor, SolveInfo]:
    """B SDF reconstructions in float32 (batched `sdf.sdf_from_points`).
    Returns (fields [B, *grid] float32, SolveInfo of [B])."""
    f32 = torch.float32
    values = torch.zeros(positions.shape[:2], dtype=f32, device=positions.device)
    problems = assemble_batch(grid, weights, positions.to(f32), values,
                              gradients=normals.to(f32),
                              point_weights=None if point_weights is None
                              else point_weights.to(f32))
    return solve_batch(problems, config, x0)
