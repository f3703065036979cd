"""Interactive re-solve loop with reusable setup + warm starts
(`examples/interactive_warmstart.py`), through the PyTorch/CUDA port.

The reference GUI re-solves every frame while the user edits the cloud.
This example plays N "frames" of a slowly rotating normal field on a FIXED
point cloud three ways and prints per-frame wall time + iterations:

  cold   — full `sdf_from_points` per frame (assembly + MG setup + solve)
  prep   — `Solver`: geometry + multigrid setup built once,
           each frame rebuilds only the right-hand side
  warm   — prep + warm start from the previous frame's field

    python examples/torch_interactive_warmstart.py [--frames 20] [--size 256] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given; the kernels are
built before the first frame, and a frame's time ends at a device fence.
"""

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import field_interpolation_tpu_torch as ft  # noqa: E402
from field_interpolation_tpu_torch.rows import resolve_device  # noqa: E402

MODES = ("cold", "prep", "warm")


class Frames:
    """The example's fixed cloud and its rotating normals on ``device``."""

    def __init__(self, size, points, precise, device):
        shape = (size, size)
        self.device = device
        self.precise = precise
        self.grid = ft.Grid(shape)
        self.w = ft.Weights(model_2=0.3)
        tol = 1e-6 if precise else 1e-4
        self.cfg = ft.SolverConfig(tol=tol, preconditioner="multigrid")

        rng = np.random.default_rng(0)
        center = (np.asarray(shape) - 1) / 2
        theta0 = rng.uniform(0, 2 * np.pi, points)
        self.base_n = np.stack([np.cos(theta0), np.sin(theta0)], 1)
        self.pts = torch.as_tensor((center + 0.35 * size * self.base_n
                                    + 0.2 * rng.standard_normal((points, 2))
                                    ).astype(np.float32), device=device)
        self.zeros = torch.zeros(points, device=device)
        self.solver = ft.Solver(self.grid, self.w, self.pts, config=self.cfg,
                                precise=precise)

    def normals(self, k):
        a = 0.03 * k  # slow rotation per frame
        rot = np.array([[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]])
        return torch.as_tensor((self.base_n @ rot.T).astype(np.float32),
                               device=self.device)

    def fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def run(self, mode, frames):
        """``frames`` frames in ``mode``: per frame (ms, x, SolveInfo)."""
        x_prev = None
        out = []
        for k in range(frames):
            nrm = self.normals(k)
            self.fence()
            t0 = time.perf_counter()
            if mode == "cold":
                solve = ft.sdf_from_points_precise if self.precise else ft.sdf_from_points
                x, info = solve(self.grid, self.w, self.pts, nrm, config=self.cfg)
            else:
                x0 = x_prev if mode == "warm" else None
                x, info = self.solver.solve(self.zeros, gradients=nrm, x0=x0)
            self.fence()
            out.append(((time.perf_counter() - t0) * 1e3, x, info))
            x_prev = x
        return out


def report(mode, runs):
    """The reference's line: frame 0 pays the first call, the rest are timed."""
    f = len(runs) - 1
    total = sum(ms for ms, _, _ in runs[1:])
    iters = sum(int(info.iterations) for _, _, info in runs[1:])
    print(f"{mode:5s}: {total / f:7.2f} ms/frame  "
          f"{iters / f:5.1f} iters/frame  (over {f} timed frames)")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--size", type=int, default=128)
    ap.add_argument("--points", type=int, default=500)
    ap.add_argument("--precise", action="store_true",
                    help="solve each frame to a TRUE 1e-6 residual")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device, build=True)
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s on {device}")

    frames = Frames(args.size, args.points, args.precise, device)
    out = {}
    for mode in MODES:
        out[mode] = frames.run(mode, args.frames)
        report(mode, out[mode])
    return out


if __name__ == "__main__":
    main()
