"""bench.py:166-171's clouds: ``points`` oriented points a lane on a circle
about the grid's center, the normals the circle's, the radius a share of
the width in ``radius_frac``. Every seed gets the same radii, the evenly
spaced quantiles of that range over the pool's lanes, in its own order, so
a seed changes where the points lie, not how large the shapes are."""

from __future__ import annotations

import math

import torch


def make(cloud: dict, shape: tuple, count: int, g: torch.Generator, device):
    """(positions [count, n, 2], normals [count, n, 2]) float32."""
    n = int(cloud["points"])
    lo, hi = cloud["radius_frac"]
    theta = torch.rand((count, n), generator=g, device=device) * (2 * math.pi)
    nrm = torch.stack([torch.cos(theta), torch.sin(theta)], -1)
    q = (torch.arange(count, device=device, dtype=torch.float32) + 0.5) / count
    radii = (lo + (hi - lo) * q)[torch.randperm(count, generator=g, device=device)]
    center = (torch.tensor(shape, dtype=torch.float32, device=device) - 1) / 2
    pts = center + (radii * shape[0])[:, None, None] * nrm
    return pts, nrm
