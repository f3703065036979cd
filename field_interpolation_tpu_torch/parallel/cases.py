"""Rank-side runs of the sharded entry points, for `launch.run_ranks`.

Each ``sharded_*`` function runs on every rank: it assembles the problem of
a `Cloud` on the rank's device, takes the rank's blocks over
``Mesh(mesh_shape)``, runs one entry point and returns the rank's part: its
``block`` (slices of the global grid), its block of the output, and the
run's scalars (the same on every rank). `stitch` puts the blocks together in
the caller. `run_cases` runs a list of them in one start of the ranks. The
ranks import only the port, never JAX.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..grid import Grid
from ..operators import assemble
from ..ops.smooth import fused_smooth
from ..ops.stencil import fused_normal_apply
from ..ops.stencil_ext import fused_normal_apply_ext, fused_normal_apply_ext_striped
from ..sdf import assemble_precise
from ..weights import SolverConfig, Weights
from . import sharded
from .contour import marching_squares_sharded, marching_tetrahedra_sharded
from .mesh import Mesh

COUNTED = (fused_normal_apply_ext, fused_normal_apply_ext_striped, fused_normal_apply,
           fused_smooth)
# Counted per mode too (``ops.stencil_ext.MODES``), as "name.mode".
BY_MODE = (fused_normal_apply_ext, fused_normal_apply_ext_striped)


@dataclasses.dataclass(frozen=True)
class Cloud:
    """Scattered samples as numpy arrays: value rows at ``positions`` (zeros
    when ``values`` is None, as an SDF's) and gradient rows when
    ``gradients`` is given."""

    shape: tuple
    weights: Weights
    positions: np.ndarray
    values: Optional[np.ndarray] = None
    gradients: Optional[np.ndarray] = None

    def _inputs(self, device, dtype):
        t = lambda a: torch.as_tensor(a, device=device).to(dtype)  # noqa: E731
        n = len(self.positions)
        vals = torch.zeros(n, dtype=dtype, device=device) if self.values is None \
            else t(self.values)
        grads = None if self.gradients is None else t(self.gradients)
        return Grid(tuple(self.shape)), t(self.positions), vals, grads

    def problem(self, device, dtype=torch.float32):
        grid, pos, vals, grads = self._inputs(device, dtype)
        return assemble(grid, self.weights, pos, vals, gradients=grads)

    def precise(self, device):
        grid, pos, vals, grads = self._inputs(device, torch.float32)
        return assemble_precise(grid, self.weights, pos, vals, gradients=grads)


def stitch(parts: list, key: str) -> torch.Tensor:
    """The whole field from the ranks' parts (``part["block"]``, ``part[key]``)."""
    shape = tuple(sl.stop for sl in parts[0]["block"])
    for p in parts:
        shape = tuple(max(n, sl.stop) for n, sl in zip(shape, p["block"]))
    out = torch.zeros(shape, dtype=parts[0][key].dtype)
    for p in parts:
        out[p["block"]] = p[key]
    return out


def _counts() -> dict:
    out = {c.__name__: c.launches for c in COUNTED}
    for c in BY_MODE:
        out.update({f"{c.__name__}.{mode}": n for mode, n in c.modes.items()})
    return out


def _zero_counts() -> None:
    for c in COUNTED:
        c.launches = 0
    for c in BY_MODE:
        c.modes = dict.fromkeys(c.modes, 0)


def _timed(fn, device):
    """(fn(), ms) after a barrier: CUDA events on a card, the host clock on
    the CPU."""
    dist.barrier()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, 1e3 * (time.perf_counter() - t0)


def _info(info) -> dict:
    return dict(iterations=int(info.iterations), rel_residual=float(info.rel_residual),
                converged=bool(info.converged))


def sharded_apply(cloud: Cloud, mesh_shape, x: np.ndarray, backend="xla", *, device):
    """One sharded operator apply of the whole-grid ``x``."""
    mesh = Mesh(mesh_shape)
    p = sharded.shard_problem(cloud.problem(device), mesh)
    blk = sharded._block(p.grid.shape, mesh)
    f = sharded.make_sharded_apply(p.grid.shape, p.weights, mesh, p.coeff, backend=backend)
    xl = torch.as_tensor(np.ascontiguousarray(x[blk]), device=device)
    return dict(block=blk, y=f(xl), route=f.route, stripe=f.stripe)


def sharded_precond(cloud: Cloud, mesh_shape, config: SolverConfig, r: np.ndarray, *,
                    device):
    """One application of the distributed multigrid preconditioner."""
    mesh = Mesh(mesh_shape)
    p = sharded.shard_problem(cloud.problem(device), mesh)
    blk = sharded._block(p.grid.shape, mesh)
    plan, ops = sharded._make_mg_plan(p, mesh, config)
    apply_fn = sharded.make_sharded_apply(p.grid.shape, p.weights, mesh, p.coeff,
                                          backend=config.backend)
    pc = sharded._make_mg_precond(plan, ops, apply_fn, p.diag, mesh, config)
    z = pc(torch.as_tensor(np.ascontiguousarray(r[blk]), device=device))
    return dict(block=blk, z=z, level_routes=pc.level_routes, n_sh=plan.n_sh,
                trans=plan.trans, shapes=plan.shapes)


def sharded_solve(cloud: Cloud, mesh_shape, config: SolverConfig, *, device):
    """`solve_sharded`, timed after a barrier, the launch counts zeroed
    just before it."""
    mesh = Mesh(mesh_shape)
    (p, blk), setup_ms = _timed(lambda: (sharded.shard_problem(cloud.problem(device),
                                                               mesh),
                                         sharded._block(tuple(cloud.shape), mesh)), device)
    _zero_counts()
    (x, info), ms = _timed(lambda: sharded.solve_sharded(p, mesh, config), device)
    return dict(block=blk, x=x, ms=ms, setup_ms=setup_ms, launches=_counts(), **_info(info))


def sharded_refined(cloud: Cloud, mesh_shape, config: SolverConfig, precise: bool = True,
                    warm: bool = False, *, device):
    """`solve_refined_sharded` on the cloud's PreciseProblem (``precise``) or
    its float64 Problem, timed; with ``warm``, again from its own float32
    result."""
    mesh = Mesh(mesh_shape)
    prob = (cloud.precise(device) if precise
            else sharded.shard_problem(cloud.problem(device, torch.float64), mesh))
    blk = sharded._block(tuple(cloud.shape), mesh)
    _zero_counts()
    (x, info), ms = _timed(lambda: sharded.solve_refined_sharded(prob, mesh, config),
                           device)
    out = dict(block=blk, x=x, ms=ms, launches=_counts(), **_info(info))
    if warm:
        _, info_w = sharded.solve_refined_sharded(prob, mesh, config,
                                                  x0=x.to(torch.float32))
        out["warm"] = _info(info_w)
    return out


def sharded_contour(field, mesh_shape, level: float = 0.0, caps=(None,), *, device):
    """`marching_squares_sharded` (2-D) or `marching_tetrahedra_sharded`
    (3-D) on this rank's block of ``field`` (a whole-grid numpy array, cut
    here, or a tensor that is already the rank's block), once per cap of
    ``caps`` (None: the default cap), each timed after a barrier. Returns
    the rank's ``block`` and per cap its live ``items`` (rows ``[:count]``),
    ``count``, ``overflowed``, whether the rows past ``count`` are zero and
    the ms."""
    mesh = Mesh(mesh_shape)
    if isinstance(field, torch.Tensor):
        x = field.to(device)
        blk = sharded._block(tuple(n * s for n, s in zip(x.shape, mesh.shards(x.ndim))),
                             mesh)
    else:
        blk = sharded._block(field.shape, mesh)
        x = torch.as_tensor(np.ascontiguousarray(field[blk]), device=device)
    fn = marching_squares_sharded if x.ndim == 2 else marching_tetrahedra_sharded
    runs = []
    for cap in caps:
        (items, count, ovf), ms = _timed(lambda: fn(x, mesh, level, cap), device)
        n = int(count)
        runs.append(dict(items=items[:n], count=n, overflowed=bool(ovf),
                         zeros_past_count=bool((items[n:] == 0).all()), ms=ms))
    return dict(block=blk, runs=runs)


def run_cases(cases: list, *, device) -> list:
    """Run ``cases`` [(name of a ``sharded_*`` function, kwargs)] in order.
    A `sharded_contour` case whose ``field`` is an int k contours this
    rank's block of case k's field (its ``x``)."""
    out = []
    for name, kwargs in cases:
        if name == "sharded_contour" and isinstance(kwargs["field"], int):
            kwargs = dict(kwargs, field=out[kwargs["field"]]["x"])
        out.append(globals()[name](**kwargs, device=device))
    return out
