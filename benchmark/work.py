"""The least work of a multigrid-preconditioned CG iteration, counted from
a configuration's shapes: the yardstick of the ``*_roofline`` metrics.

Nothing here reads the program. The level shapes follow the configuration's
multigrid rule (coarsen by ``(n + 1) // 2`` per axis while the smallest side
exceeds ``mg_min_size``, and, with the dense coarsest solve, while the level
holds more than 1024 nodes). The operations are float32 operations, a
multiply-add counted as two, of the algorithm as written:

* an operator apply on a level: one multiply-add a node for each point of
  the smoothness normal stencil (a cross of radius = the highest active
  order: ``1 + 2·order·ndim`` points) and for each data channel (``3^ndim``
  on the fine level, the lumped diagonal's one on coarse levels);
* a damped-Jacobi sweep: an apply and 3 more a node (r − A z, the scale, the
  add); the first pre-sweep starts from zero and is 1 a node;
* the residual passed down: an apply and 1 a node;
* restriction (full weighting) and prolongation (multilinear), one axis at
  a time: 3 and 2 multiply-adds for each node a pass writes, and the
  correction's add on the finer level;
* the dense coarsest solve: one product with the level's inverse, 2·n²;
* the CG iteration around the cycle: one fine apply, three dot products and
  three vector updates, 12 a node.

The bytes are counted once a batch for each lane that iterates: each of
its inputs read once and each output written once (x and r in, x out, the
fine data planes, each level's diagonal, each intermediate level's lumped
data, the coarsest level's inverse, and the lane's iteration count out; 4
bytes each). That is the least any implementation must move, whatever it
reads again and however many launches serve the lane. It is not counted
per launch: a lane that sits out a launch (the batched segment passes it a
budget of 0) needs none of its planes read, and which lanes iterate in
which launch is not visible outside the program. A lane that iterates in
several launches (a restart, each refinement round) is counted once, so
the bytes bound is a floor and a share read from it never passes 100%.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet, 700 W
FP32_FLOPS_PER_S = 67e12    # float32 outside the tensor cores, same sheet


def level_shapes(shape, mg_min_size=16, dense_coarsest=True):
    """The fine shape and every coarser level's, the coarsest last."""
    out = [tuple(shape)]
    while min(out[-1]) > mg_min_size or (dense_coarsest and math.prod(out[-1]) > 1024):
        coarse = tuple(max(2, (n + 1) // 2) for n in out[-1])
        if coarse == out[-1]:
            break
        out.append(coarse)
    return out


def _stencil_points(orders, ndim):
    top = max([k for k in orders if k > 0], default=0)
    return 1 + 2 * top * ndim


def _transfer_ops(fine, coarse, taps):
    """Operations of a separable transfer between two levels, one axis at a
    time in axis order (restriction writes coarse extents, prolongation
    fine ones): 2·taps for each node a pass writes."""
    total, cur = 0, list(fine if taps == 3 else coarse)
    target = coarse if taps == 3 else fine
    for a in range(len(fine)):
        cur[a] = target[a]
        total += 2 * taps * math.prod(cur)
    return total


def lane_iteration_flops(shapes, orders, nu):
    """Float32 operations of one CG iteration of one lane, V-cycle with ``nu``
    pre- and post-sweeps (nu ≥ 1) over ``shapes`` (dense coarsest last)."""
    ndim = len(shapes[0])
    pts = _stencil_points(orders, ndim)
    n = [math.prod(s) for s in shapes]

    def apply(l):
        return 2 * (pts + (3 ** ndim if l == 0 else 1)) * n[l]

    def cycle(l):
        if l == len(shapes) - 1:
            return 2 * n[l] * n[l]
        sweep = apply(l) + 3 * n[l]
        ops = n[l] + (nu - 1) * sweep                          # pre-smoothing
        ops += apply(l) + n[l]                                 # residual
        ops += _transfer_ops(shapes[l], shapes[l + 1], 3)      # restriction
        ops += cycle(l + 1)
        ops += _transfer_ops(shapes[l], shapes[l + 1], 2) + n[l]   # prolongation
        return ops + nu * sweep                                # post-smoothing

    return cycle(0) + apply(0) + 12 * n[0]


def lane_bytes(shapes):
    """Bytes a batch must move for one lane that iterates (see the module)."""
    ndim = len(shapes[0])
    n = [math.prod(s) for s in shapes]
    floats = 3 * n[0] + 3 ** ndim * n[0] + n[0]               # x, r, x out; data; diagonal
    floats += sum(2 * m for m in n[1:-1])                     # diagonal and lumped data
    floats += n[-1] * n[-1]                                   # coarsest inverse
    return 4 * floats + 4                                     # + the iteration count


def least_seconds(nbytes, flops):
    """(seconds, "bytes" or "operations"): the larger of the two bounds."""
    t_b, t_f = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")
