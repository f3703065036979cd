"""Demo: 3D SDF reconstruction from an oriented point cloud on a sphere
(BASELINE.md config 4 at demo scale) through the PyTorch/CUDA port, then
the surface: device compact extraction, a host cross-check and an OBJ file.

    python examples/torch_sdf_sphere_3d.py [--device cpu] [--obj PATH]

Runs on the CUDA card unless ``--device cpu`` is given.
"""

import argparse
import os
import tempfile

import numpy as np
import torch

import field_interpolation_tpu_torch as ft
from field_interpolation_tpu_torch.contour import (
    marching_tetrahedra, marching_tetrahedra_device_compact, write_obj)


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--obj", default=None, help="OBJ path (default: a temporary file)")
    args = ap.parse_args()
    device = torch.device(args.device)

    grid = ft.Grid((48, 48, 48))
    center = np.array([23.5, 23.5, 23.5])
    radius = 15.0
    rng = np.random.default_rng(0)
    u = rng.standard_normal((1500, 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    pts = (center + radius * u + 0.2 * rng.standard_normal((1500, 3))
           ).astype(np.float32)

    cfg = ft.SolverConfig(tol=1e-5, preconditioner="multigrid")
    field, info = ft.sdf_from_points(grid, ft.Weights(model_2=0.3),
                                     torch.as_tensor(pts, device=device),
                                     torch.as_tensor(u.astype(np.float32), device=device),
                                     config=cfg)
    print(f"device={field.device} converged={bool(info.converged)} "
          f"iters={int(info.iterations)} rel_residual={float(info.rel_residual):.2e}")

    g = np.arange(48)
    ii, jj, kk = np.meshgrid(g, g, g, indexing="ij")
    analytic = np.sqrt((ii - center[0]) ** 2 + (jj - center[1]) ** 2
                       + (kk - center[2]) ** 2) - radius
    band = np.abs(analytic) < 4
    rmse = float(np.sqrt(np.mean((field.cpu().numpy() - analytic)[band] ** 2)))
    print(f"RMSE vs analytic sphere SDF (|d|<4 band): {rmse:.3f}")

    # On the field's device, into a bounded buffer: tiles of cells stream
    # their live triangles instead of 12 slots per cell.
    dtris, count, ovf = marching_tetrahedra_device_compact(field)
    n = int(count)
    print(f"device compact extraction: {n} triangles "
          f"(buffer {dtris.shape[0]} rows, overflowed={bool(ovf)})")
    tris = dtris[:n].cpu().numpy().astype(np.float64)
    verts = tris.reshape(-1, 3)
    r = np.sqrt(((verts - center) ** 2).sum(1))
    print(f"surface radius {r.mean():.2f}±{r.std():.2f} (target {radius})")

    # Host cross-check: the float64 NumPy extractor finds the same surface.
    host = marching_tetrahedra(field)
    print(f"host extraction: {len(host)} triangles")

    with tempfile.TemporaryDirectory() as tmp:
        path = args.obj or os.path.join(tmp, "sphere.obj")
        nv, nf = write_obj(path, tris)
        print(f"OBJ {path}: {nv} vertices, {nf} faces")

    assert bool(info.converged) and not bool(ovf) and len(host) == n
    assert rmse < 0.8 and abs(r.mean() - radius) < 0.5
    print("OK")


if __name__ == "__main__":
    main()
