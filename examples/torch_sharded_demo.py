"""Distributed-solve demo: one grid block-decomposed over a mesh of ranks
(`examples/sharded_demo.py`), through the PyTorch/CUDA port.

The unsharded solve runs in this process; then the same problem is solved
over a 2 x 4 mesh as eight ranks (`parallel.launch.run_ranks`, one process
per shard): halo exchange between neighbour ranks, summed inner products
and the distributed multigrid, with ``backend="xla"`` as the reference
sets it, so the applies are plain torch ops. On one card
the eight ranks share it and their halos go through host memory (gloo);
with ``--device cpu`` they run on the CPU.

    python examples/torch_sharded_demo.py [--grid 128] [--n 400] [--device cpu]
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
from field_interpolation_tpu_torch.parallel.cases import Cloud, run_cases, stitch  # noqa: E402
from field_interpolation_tpu_torch.parallel.launch import run_ranks  # noqa: E402

MESH = (2, 4)


def make_cloud(g, n):
    """Oriented points on a noisy circle of the g x g grid, as NumPy."""
    rng = np.random.default_rng(0)
    theta = rng.uniform(0, 2 * np.pi, n)
    normals = np.stack([np.cos(theta), np.sin(theta)], -1).astype(np.float32)
    pts = ((g - 1) / 2.0 + 0.3125 * g * normals
           + 0.2 * rng.standard_normal((n, 2))).astype(np.float32)
    return pts, normals


def run_demo(g, n, device):
    """The unsharded solve here, then the sharded and the sharded refined
    solve on the ranks of `MESH`. Returns (x_ref, info_ref, sharded parts,
    refined parts, ms of the unsharded solve, ms from spawn to join)."""
    grid = ft.Grid((g, g))
    weights = ft.Weights(model_2=0.3)
    pts, normals = make_cloud(g, n)
    problem = ft.assemble_sdf(grid, weights, torch.as_tensor(pts, device=device),
                              torch.as_tensor(normals, device=device))
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="xla")
    t0 = time.perf_counter()
    x_ref, info_ref = ft.solve(problem, cfg)
    x_ref = x_ref.cpu()
    ms_ref = (time.perf_counter() - t0) * 1e3
    # Mixed-precision sharded refinement to a TRUE <= 1e-6 residual against
    # the float64 system, float32 sharded inner solves; the PreciseProblem's
    # protocol (owner-sharded float64 sample rows, one exact residual,
    # incremental updates), as the single-card sdf_from_points_precise.
    cfg_r = ft.SolverConfig(tol=1e-6, preconditioner="multigrid", maxiter=2000,
                            backend="xla")
    cloud = Cloud((g, g), weights, pts, None, normals)
    t0 = time.perf_counter()
    sh, ref = zip(*run_ranks(run_cases, int(np.prod(MESH)), [
        ("sharded_solve", dict(cloud=cloud, mesh_shape=MESH, config=cfg)),
        ("sharded_refined", dict(cloud=cloud, mesh_shape=MESH, config=cfg_r))],
        device=device.type))
    return x_ref, info_ref, list(sh), list(ref), ms_ref, (time.perf_counter() - t0) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=256,
                    help="square grid edge (default 256; the tests pass 128)")
    ap.add_argument("--n", type=int, default=800, help="number of points")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device, build=True)
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s on {device}")

    x_ref, info_ref, sh, ref, ms_ref, ms_ranks = run_demo(args.grid, args.n, device)
    print(f"unsharded: iters={int(info_ref.iterations)} "
          f"rel={float(info_ref.rel_residual):.1e} ({ms_ref:.0f} ms)")
    print(f"sharded {MESH}: iters={sh[0]['iterations']} rel={sh[0]['rel_residual']:.1e} "
          f"({max(p['ms'] for p in sh):.0f} ms, slowest rank; ranks {ms_ranks:.0f} ms from "
          f"spawn to join)")
    x_sh = stitch(sh, "x")
    err = float((x_sh - x_ref).abs().max() / x_ref.abs().max())
    print(f"sharded vs unsharded max rel diff: {err:.1e}")
    print(f"sharded refined: rel={ref[0]['rel_residual']:.1e} conv={ref[0]['converged']} "
          f"(TRUE f64-measured residual)")
    assert all(p["converged"] for p in sh) and all(p["converged"] for p in ref)
    assert abs(sh[0]["iterations"] - int(info_ref.iterations)) <= 2
    print("OK")
    return x_ref, info_ref, sh, ref


if __name__ == "__main__":
    main()
