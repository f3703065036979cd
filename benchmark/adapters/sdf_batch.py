"""The adapter of the port's batched SDF entry points.

The traffic file names the entry and its two stages as ``module:function``
(``field_interpolation_tpu_torch.batch:sdf_from_points_batch`` with
``assemble_batch`` and ``solve_batch``, or the ``_precise`` forms). Each is
called as the entry calls it: (grid, weights, positions [B, n, D], normals
[B, n, D], config=...) on the configuration's grid, weights and solver
settings. A batch returns (fields [B, *grid], converged [B], iterations [B]).
"""

from __future__ import annotations

import importlib
import time

import torch


def resolve(spec: str):
    """The function ``module:function`` names."""
    mod, _, name = spec.partition(":")
    return getattr(importlib.import_module(mod), name)


class Program:
    """The system under test, on one cell's grid, weights and solver."""

    spans = ("assemble", "solve")

    def __init__(self, cell):
        import field_interpolation_tpu_torch as ft
        self.grid = ft.Grid(cell.shape)
        self.weights = ft.Weights(**cell.config["weights"])
        self.config = ft.SolverConfig(**cell.solver)
        self.entry = resolve(cell.traffic["entry"])
        self.assemble, self.solve = (resolve(s) for s in cell.traffic["stages"])

    def __call__(self, pts, nrm):
        x, info = self.entry(self.grid, self.weights, pts, nrm, config=self.config)
        return x, info.converged, info.iterations

    def staged(self, pts, nrm, sync, spans):
        """The entry's two stages, as the entry runs them, each in a span."""
        t0 = time.perf_counter()
        values = torch.zeros(pts.shape[:2], dtype=torch.float32, device=pts.device)
        problems = self.assemble(self.grid, self.weights, pts, values, gradients=nrm)
        sync()
        t1 = time.perf_counter()
        x, info = self.solve(problems, self.config)
        sync()
        t2 = time.perf_counter()
        spans["assemble"].append(t1 - t0)
        spans["solve"].append(t2 - t1)
        return x, info.converged, info.iterations
