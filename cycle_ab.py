#!/usr/bin/env python3
"""Time the 2-D cycle kernels of two trees of this repository, in turn, on one card.

    python3 cycle_ab.py --ab DIR    # DIR, this tree, this tree, DIR; then a table
    python3 cycle_ab.py --tree DIR  # one tree (default: this one); one JSON line

Run from the repository root on a machine with one CUDA card and nvcc. DIR
is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Each run is a
process of its own that builds its tree's ``csrc`` into that tree's
``build/`` and imports that tree's package. ``--ab`` runs the trees in the
order A B B A, so that a drift of the card or the host during the call falls
on both sides, prints each run's record, and then per measurement the median
of each side and their ratio.

Measured in each run (CUDA events; single: median of 20 calls after a
warm-up; b2b: 20 calls back to back):

- the segment kernel (``ops.pcg.fused_pcg_solve``) on the headline's
  operands (256², 1000 points, ``Weights(model_2=0.3)``) at tol 1e-4 from
  zero, ν = 3: with the V-cycle, the W-cycle, kind-4 Chebyshev, and
  Chebyshev with Galerkin coarse data; single, b2b and iterations;
- the whole-cycle kernel (``ops.cycle``) on field A's operands (496², 2000
  points, the default config), W and V, ν = 3, on a standard-normal r;
- ms/field of the headline (``sdf_from_points_precise``, tol 1e-6, seeds
  0..3, each twice) and of field A (``sdf_from_points``, tol 1e-4, seed 0,
  three calls), after a warm-up field;
- the ptxas registers of the two kernels (from the run that built them).

Only what both designs share is used: the wrappers' signatures and the
operand builders of ``multigrid``.
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("pcg_segment", "mg_cycle2d")
TIMES = ("segment_v", "segment_w", "segment_cheb", "segment_cheb_gal", "cycle_w", "cycle_v")


def helpers():
    """chip_smoke.py of this tree, for its inputs and timers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(log):
    """{kernel: ptxas registers} of the segment and cycle kernels."""
    out, name = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line:
            for key in KERNELS:
                if key in name:
                    out[key] = int(line.split("Used")[1].split()[0])
    return out


def measure(tree):
    import numpy as np
    import torch
    sys.path.insert(0, str(tree))
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops import _build
    from field_interpolation_tpu_torch.ops.cycle import fused_vcycle_2d, fused_wcycle_2d
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve
    h = helpers()
    h.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    h.require(Path(ft.__file__).resolve().is_relative_to(tree),
              f"imported {ft.__file__}, not the package of {tree}")
    device = torch.device("cuda", 0)
    _, build_s, log = _build.build()
    _build.library()
    rec = dict(tree=str(tree), card=h.card_line(), build_s=build_s, registers=registers(log))

    w = ft.Weights(model_2=0.3)
    p256 = ft.assemble_sdf(ft.Grid(h.SHAPE), w, *h.headline_inputs(0, device))
    b = p256.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b)).reshape(1, 1)
    budget = torch.full((1, 1), 2000, dtype=torch.int32, device=device)
    for name, change, wdepth in [("segment_v", {}, 0), ("segment_w", {}, 99),
                                 ("segment_cheb", h.CHEB, 0),
                                 ("segment_cheb_gal", {**h.CHEB, **h.GALERKIN}, 0)]:
        ops = tmg.build_fused_solver_operands(p256, ft.SolverConfig(tol=h.TOL, **change))
        args = (torch.zeros_like(b), b, tol2, budget, *ops[:5], 3, ops[5])

        def call(args=args, wdepth=wdepth):
            return fused_pcg_solve(*args, wdepth=wdepth)

        it = int(call()[1].item())
        rec[name] = dict(iterations=it, ms=h.cuda_ms(call), b2b_ms=h.batch_ms(call))

    pa = ft.assemble_sdf(ft.Grid(h.SHAPE_A), w, *h.field_a_inputs(0, device))
    r = torch.as_tensor(np.random.default_rng(9).standard_normal(h.SHAPE_A)
                        .astype(np.float32), device=device)
    for name, kw, wdepth in [("cycle_w", {}, 99), ("cycle_v", dict(mg_cycle="v"), 0)]:
        ops = tmg.whole_cycle_operands(pa, ft.SolverConfig(tol=1e-4, **kw))[0]

        def call(ops=ops, wdepth=wdepth):
            if wdepth:
                return fused_wcycle_2d(r, *ops, 3, wdepth=wdepth)
            return fused_vcycle_2d(r, *ops, 3, 3)

        rec[name] = dict(ms=h.cuda_ms(call), b2b_ms=h.batch_ms(call))

    grid = ft.Grid(h.SHAPE)
    cfg = ft.SolverConfig(tol=h.TOL, preconditioner="multigrid", maxiter=2000)
    inputs = [h.headline_inputs(s, device) for s in h.SEEDS]
    ft.sdf_from_points_precise(grid, w, *inputs[0], config=cfg)  # warm-up
    rec["headline_ms"] = [h.timed(lambda i=i: ft.sdf_from_points_precise(
        grid, w, *i, config=cfg))[1] for _ in range(2) for i in inputs]
    grid_a, cfg_a = ft.Grid(h.SHAPE_A), ft.SolverConfig(tol=1e-4)
    ina = h.field_a_inputs(0, device)
    ft.sdf_from_points(grid_a, w, *ina, config=cfg_a)  # warm-up
    rec["field_a_ms"] = [h.timed(lambda: ft.sdf_from_points(
        grid_a, w, *ina, config=cfg_a))[1] for _ in range(3)]
    rec["launches"] = dict(fused_pcg_solve=fused_pcg_solve.launches,
                           fused_wcycle_2d=fused_wcycle_2d.launches,
                           fused_vcycle_2d=fused_vcycle_2d.launches)
    h.require(fused_pcg_solve.launches > 0 and fused_wcycle_2d.launches > 0,
              f"the kernels did not launch: {rec['launches']}")
    return rec


def ab(other):
    """Run ``other`` (A) and this tree (B) as A B B A; print each run and the table."""
    runs = []
    for side, tree in [("A", other), ("B", HERE), ("B", HERE), ("A", other)]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree",
                               str(tree)], capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"cycle_ab FAILED: the run of {tree} exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}")
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]), side=side)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    print(f"A = {other}, B = {HERE}; card {runs[0]['card']}")
    for side in "AB":
        regs = [r["registers"] for r in runs if r["side"] == side and r["registers"]]
        print(f"{side} ptxas registers: {regs[0] if regs else 'not built in these runs'}")

    def med(side, key, sub=None):
        vals = [v for r in runs if r["side"] == side
                for v in (r[key] if sub is None else [r[key][sub]])]
        return statistics.median(vals)

    rows = [(f"{k} {s}", k, s) for k in TIMES for s in ("b2b_ms", "ms")]
    rows += [("headline ms/field", "headline_ms", None), ("field A ms/field", "field_a_ms", None)]
    for label, key, sub in rows:
        a, b = med("A", key, sub), med("B", key, sub)
        print(f"{label}: A {a:.4f}  B {b:.4f}  B/A {b / a:.3f}")
    for key in TIMES[:4]:
        print(f"{key} iterations: A {[r[key]['iterations'] for r in runs if r['side'] == 'A']} "
              f"B {[r[key]['iterations'] for r in runs if r['side'] == 'B']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE, help="the tree to measure alone")
    ap.add_argument("--ab", type=Path, help="the other tree (A), measured beside this one (B)")
    opts = ap.parse_args()
    if opts.ab:
        ab(opts.ab.resolve())
    else:
        print(json.dumps(measure(opts.tree.resolve())))


if __name__ == "__main__":
    main()
