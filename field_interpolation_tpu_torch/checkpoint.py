"""Checkpoint / resume of a solver iterate: counterpart of
``field_interpolation_tpu.checkpoint``.

A `.npz` of the iterate plus grid/weights metadata, in the reference's
format, so a file written by either package loads in the other. Restart =
load + pass as ``x0`` (a CG restart from the last iterate is a warm start).
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from .grid import Grid
from .weights import Weights


def save_state(path: str, x, grid: Grid, weights: Weights, **extra) -> None:
    """Persist a solver iterate or final field (tensor or array) with problem
    metadata."""
    meta = dict(grid_shape=list(grid.shape),
                weights=dataclasses.asdict(weights), **extra)
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.savez(path, x=np.asarray(x), meta=json.dumps(meta))


def load_state(path: str):
    """Returns (x, grid, weights, extra), x a CPU tensor."""
    data = np.load(path, allow_pickle=False)
    meta = json.loads(str(data["meta"]))
    grid = Grid(tuple(meta.pop("grid_shape")))
    weights = Weights(**meta.pop("weights"))
    return torch.from_numpy(data["x"]), grid, weights, meta
