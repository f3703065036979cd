"""Iso-contours of a sharded field, extracted where its blocks live.

Counterpart of ``field_interpolation_tpu.parallel.contour``, over
``torch.distributed`` with one process per shard: every rank calls the
extractor on its own block of the field (grid dim d on mesh axis d, as
`solve_sharded` gives it). A rank takes a one-node halo from its +1
neighbour along each axis, corners included, through the sharded solve's
halo exchange (`sharded._extend`), and marches the cells whose first node
it owns, so a cell on a seam is extracted once, by its owner. That exchange
gives the ranks at the grid's far edges zeros, a live field value, so cells
outside the global grid are masked by their global index. Output
coordinates are global lattice coordinates, with the slot conventions of
`contour.marching_squares_device` / `marching_tetrahedra_device`.
"""

from __future__ import annotations

import torch

from ..contour import _live_prefix, _ms_slots, _mt_slots, _shifted
from .mesh import Mesh
from .sharded import _all_sum, _extend, _global_start


def _sharded_slots(block: torch.Tensor, mesh: Mesh, level: float, slots, per_cell: int,
                   cap: int):
    """This rank's live slots of ``slots`` (`_ms_slots` / `_mt_slots`) on
    its halo-extended block, the first ``cap`` in slot order (zeros past
    the count)."""
    shards = mesh.shards(block.ndim)
    local = tuple(block.shape)
    start = _global_start(local, mesh)
    glob = tuple(n * s for n, s in zip(local, shards))
    ext = _extend(block, 1, mesh)[(slice(1, None),) * block.ndim]    # [n + 1 per axis]
    items, valid = slots(_shifted(ext, level), *(float(s) for s in start))
    # Cell (global index g per axis) exists iff g < n_global − 1 on every axis.
    inside = torch.ones(local, dtype=torch.bool, device=block.device)
    for d, (s, n) in enumerate(zip(start, glob)):
        idx = torch.arange(local[d], device=block.device) + s
        shape = [1] * block.ndim
        shape[d] = local[d]
        inside = inside & (idx < n - 1).reshape(shape)
    valid = valid & inside.reshape(-1).repeat_interleave(per_cell)
    rows, count = _live_prefix(items[None], valid[None], cap)
    take = torch.clamp(count, max=cap)
    out = torch.where((torch.arange(cap, device=block.device) < take)[
        (..., None, None)], rows, 0.0)[0]
    overflowed = _all_sum((count - take).reshape(1)) > 0
    return out, take[0, 0], overflowed[0]


def marching_squares_sharded(block: torch.Tensor, mesh: Mesh, level: float = 0.0,
                             max_segments_per_shard: int | None = None):
    """Marching squares on a sharded 2-D field; every rank of ``mesh``
    calls it with its own block [h, w] (grid dim d on mesh axis d).

    Returns this rank's ``(segments [cap, 2, 2], count, overflowed)`` in
    global (row, col) lattice coordinates: rows ``[:count]`` are the live
    segments of the cells whose first node the rank owns, in slot order
    (zeros beyond); ``overflowed`` (the same on every rank) is True iff some
    rank cut more than ``cap`` slots. ``cap`` is
    ``max_segments_per_shard``, by default ``8·max(h, w)``. The union over
    ranks is the unsharded device extraction's live set.
    """
    h, w = block.shape
    cap = (max_segments_per_shard if max_segments_per_shard is not None
           else 8 * max(h, w))
    return _sharded_slots(block, mesh, level, _ms_slots, 2, cap)


def marching_tetrahedra_sharded(block: torch.Tensor, mesh: Mesh, level: float = 0.0,
                                max_triangles_per_shard: int | None = None):
    """Marching tetrahedra on a sharded 3-D field; every rank calls it with
    its own block [h, w, d] (grid dim d on mesh axis d; a 2-axis mesh
    leaves dim 2 whole). The halo is three faces, three edges and the far
    corner node of the +1 neighbours.

    Returns this rank's ``(triangles [cap, 3, 3], count, overflowed)`` in
    global (i, j, k) lattice coordinates, as `marching_squares_sharded`;
    ``cap`` is ``max_triangles_per_shard``, by default ``48·max(h·w, h·d,
    w·d)``.
    """
    h, w, dd = block.shape
    cap = (max_triangles_per_shard if max_triangles_per_shard is not None
           else 48 * max(h * w, h * dd, w * dd))
    return _sharded_slots(block, mesh, level, _mt_slots, 12, cap)
