"""1D interpolation demo — the reference GUI's 1D mode
(`examples/demo_1d.py`) as a terminal harness, through the PyTorch/CUDA port.

Scattered (x, value) samples on a 1D lattice, interpolated under the
per-order smoothness priors (Weights.model_0..model_3). The 1D demo exists
to make the effect of each model order VISIBLE: order-1 pulls toward
piecewise-constant, order-2 toward piecewise-linear ("stiff rod"), order-3
toward smooth splines. This script renders an ASCII plot of the
interpolated curve + sample markers, one panel per weight preset (or a
single custom one), with the solver ms / iteration readout of the demo
app. A 1-D grid runs plain torch ops on the device (no kernel takes a 1-D
grid, as no TPU kernel does in the reference).

Usage:
  python examples/torch_demo_1d.py                    # preset comparison
  python examples/torch_demo_1d.py --w1 1.0 --n 12    # custom weights
  python examples/torch_demo_1d.py --gradients        # oriented samples: slopes
  python examples/torch_demo_1d.py --device cpu       # without a card
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import field_interpolation_tpu_torch as ft  # noqa: E402
from field_interpolation_tpu_torch.rows import resolve_device  # noqa: E402
from field_interpolation_tpu_torch.weights import SolverConfig, Weights  # noqa: E402


def make_samples(n, size, seed=0):
    """Scattered samples of a bumpy underlying function."""
    rng = np.random.default_rng(seed)
    xs = np.sort(rng.uniform(2.0, size - 3.0, n))
    t = xs / (size - 1)
    vals = np.sin(2 * np.pi * 1.5 * t) + 0.4 * np.cos(2 * np.pi * 4.0 * t)
    slopes = (2 * np.pi * 1.5 * np.cos(2 * np.pi * 1.5 * t)
              - 0.4 * 2 * np.pi * 4.0 * np.sin(2 * np.pi * 4.0 * t)) / (size - 1)
    return xs, vals, slopes


def ascii_plot(field, xs, vals, width=None, height=15):
    """Render the curve as ASCII: '*' curve, 'o' samples."""
    size = field.shape[0]
    width = width or min(size, 100)
    cols = np.linspace(0, size - 1, width)
    curve = np.interp(cols, np.arange(size), field)
    lo = min(curve.min(), vals.min())
    hi = max(curve.max(), vals.max())
    span = max(hi - lo, 1e-9)
    rows = [[" "] * width for _ in range(height)]
    for c, v in enumerate(curve):
        r = int(round((hi - v) / span * (height - 1)))
        rows[r][c] = "*"
    for x, v in zip(xs, vals):
        c = int(round(x / (size - 1) * (width - 1)))
        r = int(round((hi - np.clip(v, lo, hi)) / span * (height - 1)))
        rows[r][c] = "o"
    return "\n".join("".join(r) for r in rows)


def presets(args):
    """[(panel name, Weights)]: the custom panel or the three presets."""
    custom = {o: getattr(args, f"w{o}") for o in range(4)
              if getattr(args, f"w{o}") is not None}
    if custom:
        return [("custom " + " ".join(f"w{o}={w}" for o, w in custom.items()),
                 Weights(**{f"model_{o}": w for o, w in custom.items()},
                         data_pos=1.0,
                         data_gradient=1.0 if args.gradients else 0.0))]
    return [
        ("order-1 (flat pull)      w1=0.5",
         Weights(model_1=0.5, data_pos=1.0)),
        ("order-2 (stiff rod)      w2=0.5",
         Weights(model_2=0.5, data_pos=1.0)),
        ("order-3 (smooth spline)  w3=0.5",
         Weights(model_3=0.5, data_pos=1.0)),
    ]


def run_panels(args, device):
    """Each panel solved on ``device`` and printed: [(name, weights, field,
    info, ms)]."""
    grid = ft.Grid((args.size,))
    xs, vals, slopes = make_samples(args.n, args.size, args.seed)
    pos = torch.as_tensor(xs, device=device)[:, None]
    val = torch.as_tensor(vals, device=device)
    config = SolverConfig(tol=1e-6, preconditioner="multigrid")
    out = []
    for name, w in presets(args):
        if args.gradients and w.data_gradient == 0.0:
            w = Weights(model_0=w.model_0, model_1=w.model_1,
                        model_2=w.model_2, model_3=w.model_3,
                        data_pos=w.data_pos, data_gradient=1.0)
        t0 = time.perf_counter()
        if args.gradients:
            problem = ft.assemble(grid, w, pos, val,
                                  gradients=torch.as_tensor(slopes, device=device)[:, None])
            field, info = ft.solve(problem, config)
        else:
            field, info = ft.interpolate(grid, w, pos, val, config=config)
        field = field.cpu().numpy()  # the device fence
        ms = (time.perf_counter() - t0) * 1e3
        rmse = float(np.sqrt(np.mean(
            (np.interp(xs, np.arange(args.size), field) - vals) ** 2)))
        print(f"\n── {name} ── {ms:.1f} ms  iters={int(info.iterations)}  "
              f"rel_res={float(info.rel_residual):.2e}  "
              f"sample RMSE={rmse:.3g}")
        print(ascii_plot(field, xs, vals))
        out.append((name, w, field, info, ms))
    return out


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=192, help="lattice nodes")
    ap.add_argument("--n", type=int, default=9, help="sample count")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--gradients", action="store_true",
                    help="also constrain slopes at samples (oriented 1D)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    for o in range(4):
        ap.add_argument(f"--w{o}", type=float, default=None,
                        help=f"model_{o} weight (custom panel)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device, build=True)
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s on {device}")
    return run_panels(args, device)


if __name__ == "__main__":
    main()
