"""The check of an SDF or interpolation cell: the fields the timed path
produced, judged by the plain reference (`benchmark.reference`), which
works each lane's normal equations out again from the same points.

Two numbers, each with the limit the cell's traffic file gives it:

* ``true_rel_residual_max`` — the largest TRUE relative residual, in
  float64 against the reference's normal equations, over every lane of the
  batches kept for the check (a sample of the window's batches drawn from
  the seed);
* ``unconverged_fields`` — the window's fields whose own ``converged`` flag
  is false (the run's ``failed``): a field the program could not bring to
  the configuration's tolerance.
"""

from __future__ import annotations

import torch

from benchmark import reference


def judge(cell, pool, kept, flags, block: int) -> tuple[bool, dict, int, int]:
    """(correct, {name: (value, limit)}, lanes compared, unconverged fields).
    ``kept``: [(pool index, fields [B, *grid])]; ``flags``: every batch's
    converged [B]."""
    limits = cell.traffic["limits"]
    weights = cell.config["weights"]
    unconverged = int(sum(int((~f).sum()) for f in flags))
    worst, lanes = 0.0, 0
    for j, x in kept:
        pts, nrm = pool[j]
        rel = reference.true_rel_residual(cell.shape, weights, pts, nrm, x, block=block)
        worst = max(worst, float(rel.max()))
        lanes += rel.numel()
    numbers = {"true_rel_residual_max": (worst, float(limits["true_rel_residual_max"])),
               "unconverged_fields": (unconverged, int(limits["unconverged_fields"]))}
    correct = lanes > 0 and all(v <= lim for v, lim in numbers.values())
    return correct, numbers, lanes, unconverged


def reference_solve(cell, pts, nrm, precision: str, block: int):
    """The reference in the program's place (the control): every lane of one
    batch solved by `reference.solve` in ``precision``, in blocks of lanes.
    Returns (fields [B, *grid], converged [B])."""
    tol = float(cell.solver["tol"])
    maxiter = int(cell.solver.get("maxiter", 2000))
    xs, flags = [], []
    for s in range(0, pts.shape[0], block):
        lanes = reference.Lanes(cell.shape, cell.config["weights"], pts[s:s + block],
                                nrm[s:s + block], precision)
        x, conv = reference.solve(lanes, tol, maxiter)
        xs.append(x)
        flags.append(conv)
    return torch.cat(xs), torch.cat(flags)
