"""Demo: reconstruct the SDF of a noisy circle from oriented points — the
reference's flagship GUI scenario (`examples/sdf_circle.py`) through the
PyTorch/CUDA port. Prints the solve diagnostics and the RMSE against the
analytic SDF (the reference GUI's metric).

    python examples/torch_sdf_circle.py [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

# Runnable as `python examples/torch_sdf_circle.py` from anywhere: the
# package lives one directory up from this file.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import field_interpolation_tpu_torch as ft  # noqa: E402
from field_interpolation_tpu_torch.rows import resolve_device  # noqa: E402


def make_circle_samples(n, center, radius, noise, seed=0):
    rng = np.random.default_rng(seed)
    theta = rng.uniform(0, 2 * np.pi, n)
    normals = np.stack([np.cos(theta), np.sin(theta)], axis=1)
    pts = center + radius * normals + noise * rng.standard_normal((n, 2))
    return pts.astype(np.float32), normals.astype(np.float32)


def solve_circle(device):
    """(field as float64 NumPy, SolveInfo, the analytic SDF) of the demo's
    circle, solved to a TRUE 1e-6 on ``device``."""
    grid = ft.Grid((64, 64))
    center = np.array([31.5, 31.5])
    radius = 20.0
    pts, normals = make_circle_samples(200, center, radius, noise=0.3)

    weights = ft.Weights(model_1=0.0, model_2=0.3, data_pos=1.0, data_gradient=1.0)
    cfg = ft.SolverConfig(tol=1e-6, preconditioner="multigrid")
    field, info = ft.sdf_from_points_precise(grid, weights,
                                             torch.as_tensor(pts, device=device),
                                             torch.as_tensor(normals, device=device),
                                             config=cfg)
    yy, xx = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    analytic = np.sqrt((yy - center[0]) ** 2 + (xx - center[1]) ** 2) - radius
    return field.cpu().numpy(), info, analytic


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device, build=True)
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s on {device}")

    field, info, analytic = solve_circle(device)
    mask = np.abs(analytic) < 5  # compare near the surface like the GUI does
    rmse = float(np.sqrt(np.mean((field - analytic)[mask] ** 2)))

    print(f"converged={bool(info.converged)} iters={int(info.iterations)} "
          f"rel_residual={float(info.rel_residual):.2e}")
    print(f"RMSE vs analytic SDF (|d|<5 band): {rmse:.3f} lattice units")
    # Zero-level-set sanity: sign changes across the circle boundary.
    row = field[32]
    crossings = np.sum(np.diff(np.sign(row)) != 0)
    print(f"zero crossings on center row: {crossings} (expect 2)")
    assert bool(info.converged)
    assert rmse < 0.6, rmse
    assert crossings == 2, crossings
    print("OK")


if __name__ == "__main__":
    main()
