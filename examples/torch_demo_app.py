"""Interactive SDF-reconstruction demo app — the reference GUI as a terminal
harness (`examples/demo_app.py`), through the PyTorch/CUDA port.

The reference's ImGui demo is: pick a synthetic shape, drag sliders (sample
count / noise / per-order smoothness weights), and watch the reconstruction
re-solve at interactive rates with an on-screen heatmap + zero contour +
wall-time/RMSE readout. This app reproduces that workflow in three modes:

* one-shot     — solve once for the current flags, render, report.
* sweep        — the GUI's "drag a slider" loop as a script: N frames varying
                 a chosen parameter, each frame warm-started from the last
                 solution, per-frame ms / iters / residual / RMSE readout.
                 This is the interactive-rate benchmark.
* interactive  — a REPL: `noise 0.5`, `n 2000`, `w2 0.1`, `shape star`,
                 `precise` … re-solves (warm-started) and re-renders after
                 every command, like dragging the GUI slider.

Rendering is ANSI truecolor in the terminal (heatmap via visualize.sdf_colormap
+ marching-squares contour overlay); `--ppm out.ppm` also writes an image
file. Runs on the CUDA card unless ``--device cpu`` is given; the kernels
are built before the first frame, so frame 0 is a cold frame, not a build.

    python examples/torch_demo_app.py [--mode one-shot|sweep|interactive] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

# Runnable as `python examples/torch_demo_app.py` from anywhere: the package
# lives one directory up from this file.
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import field_interpolation_tpu_torch as ft  # noqa: E402
from field_interpolation_tpu_torch.contour import marching_squares  # noqa: E402
from field_interpolation_tpu_torch.rows import resolve_device  # noqa: E402
from field_interpolation_tpu_torch.utils import (  # noqa: E402
    record_solve, vcycle_applies_per_iteration)
from field_interpolation_tpu_torch.visualize import (  # noqa: E402
    draw_arrows, draw_contour, sdf_colormap, write_ppm)


# ---------------------------------------------------------------------------
# Synthetic oriented-point shape generators (the reference demo's scenarios)
# plus their analytic SDFs for the RMSE readout.
# ---------------------------------------------------------------------------

def _circle(n, center, radius, rng):
    theta = rng.uniform(0, 2 * np.pi, n)
    nrm = np.stack([np.cos(theta), np.sin(theta)], 1)
    return center + radius * nrm, nrm


def make_shape(shape, n, grid_shape, noise, rng):
    """Returns (positions [n,2], normals [n,2], analytic_sdf(points)->d)."""
    c = (np.asarray(grid_shape, np.float64) - 1) / 2
    r = 0.35 * min(grid_shape)
    if shape == "circle":
        pts, nrm = _circle(n, c, r, rng)

        def sdf(p):
            return np.hypot(*(p - c).T) - r
    elif shape == "two-circles":
        c0, c1 = c - [0, 0.3 * r * 1.6], c + [0, 0.3 * r * 1.6]
        r2 = 0.62 * r
        p0, n0 = _circle(n // 2, c0, r2, rng)
        p1, n1 = _circle(n - n // 2, c1, r2, rng)
        pts, nrm = np.concatenate([p0, p1]), np.concatenate([n0, n1])

        def sdf(p):
            return np.minimum(np.hypot(*(p - c0).T) - r2,
                              np.hypot(*(p - c1).T) - r2)
    elif shape == "star":
        theta = rng.uniform(0, 2 * np.pi, n)
        rad = r * (0.75 + 0.25 * np.cos(5 * theta))
        drad = r * (-1.25 * np.sin(5 * theta))
        pts = c + np.stack([rad * np.cos(theta), rad * np.sin(theta)], 1)
        # outward normal of r(θ) curve
        tx = drad * np.cos(theta) - rad * np.sin(theta)
        ty = drad * np.sin(theta) + rad * np.cos(theta)
        nrm = np.stack([ty, -tx], 1)
        nrm /= np.linalg.norm(nrm, axis=1, keepdims=True)
        sdf = None  # no closed form: RMSE readout skipped
    elif shape == "square":
        k = n // 4
        side = 0.7 * r
        ts = rng.uniform(-side, side, k)
        pts, nrm = [], []
        for d, sgn in (((1, 0), 1), ((1, 0), -1), ((0, 1), 1), ((0, 1), -1)):
            e = np.array(d, np.float64)
            o = np.array([1 - d[0], 1 - d[1]], np.float64)
            pts.append(c + sgn * side * e + ts[:, None] * o)
            nrm.append(np.tile(sgn * e, (k, 1)))
        pts, nrm = np.concatenate(pts), np.concatenate(nrm)

        def sdf(p):
            q = np.abs(p - c) - side
            return (np.hypot(*np.maximum(q, 0).T)
                    + np.minimum(np.max(q, axis=-1), 0))
    else:
        raise SystemExit(f"unknown shape {shape!r}")
    pts = pts + noise * rng.standard_normal(pts.shape)
    return pts.astype(np.float32), nrm.astype(np.float32), sdf


# ---------------------------------------------------------------------------
# Terminal rendering: ANSI truecolor half-blocks, two grid rows per text row.
# ---------------------------------------------------------------------------

def render_ansi(field, segments, out=sys.stdout, max_cols=100):
    img = sdf_colormap(field)
    img = draw_contour(img, segments, color=(0, 0, 0))
    h, w = img.shape[:2]
    step = max(1, int(np.ceil(w / max_cols)))
    img = img[::step, ::step]
    h, w = img.shape[:2]
    if h % 2:
        img = img[:-1]
    lines = []
    for r in range(0, img.shape[0], 2):
        row = []
        for cidx in range(w):
            tr, tg, tb = img[r, cidx]
            br, bg, bb = img[r + 1, cidx]
            row.append(f"\x1b[38;2;{tr};{tg};{tb}m\x1b[48;2;{br};{bg};{bb}m▀")
        lines.append("".join(row) + "\x1b[0m")
    out.write("\n".join(lines) + "\n")


# ---------------------------------------------------------------------------
# Solve + report (the GUI frame)
# ---------------------------------------------------------------------------

class App:
    def __init__(self, args, device):
        self.ft = ft
        self.args = args
        self.device = device
        self.rng = np.random.default_rng(args.seed)
        self.x0 = None
        self.frame = 0

    @property
    def grid(self):
        return self.ft.Grid((self.args.grid, self.args.grid))

    def weights(self):
        a = self.args
        return self.ft.Weights(model_0=a.w0, model_1=a.w1, model_2=a.w2,
                               model_3=a.w3, data_pos=a.wp, data_gradient=a.wg)

    def config(self):
        a = self.args
        return self.ft.SolverConfig(tol=a.tol, preconditioner=a.precond,
                                    maxiter=a.maxiter, debug=a.debug)

    def fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def solve_frame(self, render=True):
        a = self.args
        pkg = self.ft
        pts, nrm, sdf = make_shape(a.shape, a.n, self.grid.shape, a.noise,
                                   self.rng)
        cfg = self.config()
        p = torch.as_tensor(pts, device=self.device)
        nm = torch.as_tensor(nrm, device=self.device)
        x0 = self.x0
        self.fence()
        t0 = time.perf_counter()
        if a.precise:
            x, info = pkg.sdf_from_points_precise(
                self.grid, self.weights(), p, nm, config=cfg, x0=x0, fmg_start=a.fmg)
        else:
            x, info = pkg.sdf_from_points(
                self.grid, self.weights(), p, nm, config=cfg, x0=x0, fmg_start=a.fmg)
        self.fence()
        ms = (time.perf_counter() - t0) * 1e3
        self.x0 = x.detach().to(torch.float32)
        field = x.detach().cpu().numpy().astype(np.float64)

        rmse = None
        if sdf is not None:
            ii, jj = np.meshgrid(*[np.arange(s) for s in self.grid.shape],
                                 indexing="ij")
            d = sdf(np.stack([ii.ravel(), jj.ravel()], 1)).reshape(field.shape)
            band = np.abs(d) < 0.1 * min(self.grid.shape)
            rmse = float(np.sqrt(np.mean((field - d)[band] ** 2)))

        segs = marching_squares(field)
        warm = self.frame > 0
        print(f"[frame {self.frame}] {a.shape} n={a.n} noise={a.noise:g} "
              f"w2={a.w2:g} | {ms:.1f} ms ({'warm' if warm else 'cold'}) "
              f"iters={int(info.iterations)} rel={float(info.rel_residual):.1e} "
              f"conv={bool(info.converged)}"
              + (f" RMSE={rmse:.3f}" if rmse is not None else ""))
        if self.args.records:
            # Observability through the GUI harness too: one structured JSON
            # line per frame, V-cycle traffic factor.
            record_solve(
                self.grid, info, ms, preconditioner=cfg.preconditioner,
                solver="refined-pcg" if a.precise else "pcg",
                stream=sys.stderr,
                applies_per_iteration=vcycle_applies_per_iteration(
                    cfg.mg_pre_smooth, cfg.mg_post_smooth),
                frame=self.frame, warm=warm,
                rmse=rmse if rmse is not None else -1.0)
        if self.args.probe:
            # the GUI's value-under-the-cursor readout: multilinear field
            # value + gradient at a continuous position (sample_field API)
            r, _, c = self.args.probe.partition(",")
            pos = torch.tensor([[float(r), float(c)]], device=self.device)
            v = float(pkg.sample_field(self.grid, x, pos)[0])
            gx, gy = pkg.sample_field_gradient(self.grid, x, pos)[0].tolist()
            print(f"  probe ({float(r):g},{float(c):g}): value={v:+.4f} "
                  f"grad=({gx:+.3f},{gy:+.3f}) |grad|={np.hypot(gx, gy):.3f}")
        if render and not self.args.no_render:
            render_ansi(field, segs)
        if self.args.ppm:
            img = draw_contour(sdf_colormap(field), segs, (0, 0, 0))
            if self.args.arrows:
                # the GUI's normal-arrow overlay at the oriented samples
                img = draw_arrows(img, pts, nrm,
                                  length=0.03 * min(self.grid.shape))
            write_ppm(self.args.ppm, img)
        self.frame += 1
        return ms


def run_sweep(app, args):
    """The GUI's slider drag as a loop: vary ``--sweep param=a:b`` over
    ``--frames`` frames, warm-starting each re-solve."""
    param, _, span = args.sweep.partition("=")
    lo, _, hi = span.partition(":")
    lo, hi = float(lo), float(hi)
    times = []
    for i in range(args.frames):
        v = lo + (hi - lo) * i / max(1, args.frames - 1)
        if param == "n":
            setattr(app.args, "n", int(v))
            app.x0 = None if i == 0 else app.x0  # n changes keep x0 valid
        else:
            setattr(app.args, param, v)
        times.append(app.solve_frame(render=(i == args.frames - 1)))
    steady = times[1:] or times
    print(f"sweep '{args.sweep}': {len(times)} frames, "
          f"steady-state {np.mean(steady):.1f} ms/frame "
          f"({1e3 / np.mean(steady):.1f} fps)")
    return times


def run_interactive(app, args, lines=None):
    """The REPL on ``lines`` (stdin by default)."""
    params = ("n", "noise", "w0", "w1", "w2", "w3", "wp", "wg", "tol", "grid")
    print("commands: <param> <value> | shape <name> | precise | fast | "
          "resolve | quit    params:", ", ".join(params))
    app.solve_frame()
    for line in (sys.stdin if lines is None else lines):
        toks = line.split()
        if not toks:
            continue
        cmd = toks[0]
        if cmd in ("q", "quit", "exit"):
            break
        elif cmd == "shape" and len(toks) > 1:
            args.shape = toks[1]
            app.x0 = None
        elif cmd == "precise":
            args.precise = True
        elif cmd == "fast":
            args.precise = False
        elif cmd in params and len(toks) > 1:
            val = float(toks[1])
            if cmd in ("n", "grid"):
                val = int(val)
                app.x0 = None if cmd == "grid" else app.x0
            setattr(args, cmd, val)
        elif cmd != "resolve":
            print(f"? unknown command {cmd!r}")
            continue
        app.solve_frame()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mode", choices=("one-shot", "sweep", "interactive"),
                    default="one-shot")
    ap.add_argument("--shape", default="circle",
                    choices=("circle", "two-circles", "star", "square"))
    ap.add_argument("--grid", type=int, default=128)
    ap.add_argument("--n", type=int, default=800)
    ap.add_argument("--noise", type=float, default=0.3)
    ap.add_argument("--w0", type=float, default=0.0)
    ap.add_argument("--w1", type=float, default=0.0)
    ap.add_argument("--w2", type=float, default=0.3)
    ap.add_argument("--w3", type=float, default=0.0)
    ap.add_argument("--wp", type=float, default=1.0)
    ap.add_argument("--wg", type=float, default=1.0)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--precond", default="multigrid",
                    choices=("none", "jacobi", "multigrid"))
    ap.add_argument("--maxiter", type=int, default=2000)
    ap.add_argument("--fmg", nargs="?", const=1, default=0, type=int,
                    help="nested-iteration initial guess on cold frames "
                         "(fmg_start; worthwhile at bandwidth-bound sizes). "
                         "Optional int = recursion depth (full-FMG): "
                         "--fmg 2 warm-starts the coarse solve too")
    ap.add_argument("--precise", action="store_true",
                    help="mixed-precision solve to a TRUE <= tol residual")
    ap.add_argument("--debug", action="store_true",
                    help="checked inputs, field and problem (SolverConfig.debug)")
    ap.add_argument("--sweep", default="noise=0.0:1.5",
                    help="sweep mode: param=lo:hi (e.g. w2=0.05:1.0)")
    ap.add_argument("--frames", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--no-render", action="store_true")
    ap.add_argument("--records", action="store_true",
                    help="emit one structured SolveRecord JSON line per "
                         "frame to stderr (utils.observe)")
    ap.add_argument("--ppm", default="", help="also write a PPM image here")
    ap.add_argument("--arrows", action="store_true",
                    help="overlay sample-normal arrows on the PPM image")
    ap.add_argument("--probe", default="",
                    help="print the field value+gradient at a continuous "
                         "position 'row,col' each frame (the GUI's "
                         "under-the-cursor readout)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    t0 = time.perf_counter()
    device = resolve_device(args.device, build=True)
    print(f"kernels ready in {time.perf_counter() - t0:.1f} s on {device}")
    app = App(args, device)
    if args.mode == "one-shot":
        app.solve_frame()
    elif args.mode == "sweep":
        run_sweep(app, args)
    else:
        run_interactive(app, args)
    print("OK")
    return app


if __name__ == "__main__":
    main()
