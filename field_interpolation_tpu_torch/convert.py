"""Carry the JAX package's assembled state across into the port's tensors.

Each function takes the reference's arrays as numpy (``np.asarray`` of its
``Problem``, ``PreciseProblem`` or ``build_fused_solver_operands`` result,
single or batched) and returns the port's objects on ``device``, so the
same operands can be fed to both packages. Nothing here imports JAX.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import Grid
from .operators import Problem
from .ops._build import ensure_full_fp32
from .sdf import PreciseProblem
from .weights import Weights


def _t(a, device, dtype) -> torch.Tensor:
    return torch.as_tensor(np.array(a, copy=True, order="C"), device=device).to(dtype)


def problem_from_numpy(coeff, b, diag, grid: Grid, weights: Weights,
                       device: torch.device | str = "cpu") -> Problem:
    """``Problem.coeff/b/diag`` as float32 tensors on ``device``."""
    ensure_full_fp32(device)
    f32 = torch.float32
    return Problem(coeff=_t(coeff, device, f32), b=_t(b, device, f32),
                   diag=_t(diag, device, f32), grid=grid, weights=weights)


def precise_problem_from_numpy(p32: Problem, b64, corner_idx, rows64, tw64,
                               grid: Grid, weights: Weights,
                               device: torch.device | str = "cpu") -> PreciseProblem:
    """``PreciseProblem.b64/corner_idx/rows64/tw64`` (float64 and int64)
    around a port `Problem` (see `problem_from_numpy`)."""
    ensure_full_fp32(device)
    f64 = torch.float64
    return PreciseProblem(p32=p32, b64=_t(b64, device, f64),
                          corner_idx=_t(corner_idx, device, torch.int64),
                          rows64=_t(rows64, device, f64), tw64=_t(tw64, device, f64),
                          grid=grid, weights=weights)


def fused_operands_from_numpy(coeffs, sids, Rs, inv32, level_weights,
                              device: torch.device | str = "cpu"):
    """``(coeffs, sids, Rs, inv32)`` of the reference's
    ``build_fused_solver_operands`` as the port's operand tuple
    ``(coeffs, sids, Rs, inv32, level_weights, None)``."""
    ensure_full_fp32(device)
    f32 = torch.float32
    return ([_t(c, device, f32) for c in coeffs], [_t(s, device, f32) for s in sids],
            [_t(R, device, f32) for R in Rs], _t(inv32, device, f32),
            list(level_weights), None)


def problems_from_numpy(ref, grid: Grid, weights: Weights,
                        device: torch.device | str = "cpu"):
    """A reference batched ``Problem`` or ``PreciseProblem`` (its leaves
    numpy arrays, or anything ``np.asarray`` reads, with a leading lane
    axis) as the port's batched object (``batch``): float32 problem leaves,
    float64 and int64 precise leaves, each keeping its lane axis."""
    if hasattr(ref, "b64"):
        p32 = problems_from_numpy(ref.p32, grid, weights, device)
        return precise_problem_from_numpy(p32, ref.b64, ref.corner_idx, ref.rows64,
                                          ref.tw64, grid, weights, device)
    return problem_from_numpy(ref.coeff, ref.b, ref.diag, grid, weights, device)
