#!/usr/bin/env python3
"""Time the cycle and smoothing kernels of two trees of this repository, in turn, on one card.

    python3 cycle_ab.py --ab DIR    # DIR and this tree in turn, eight runs; then a table
    python3 cycle_ab.py --tree DIR  # one tree (default: this one); one JSON line

Run from the repository root on a machine with one CUDA card and nvcc. DIR
is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Each run is a
process of its own that builds its tree's ``csrc`` into that tree's
``build/`` and imports that tree's package. ``--ab`` runs the trees in the
order A B B A B A A B, so that a drift of the card or the host during the
call falls on both sides (a slow spell of the host can last a whole run,
and moves every field of it, changed or not), prints each run's record, and
then per measurement the median of each side and their ratio, and for the
main-path fields each run's median.

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
- the smoothing phases of the plain-cycle path as its cycle runs them, the
  pre-smoothing call (ν = 3) and the residual r − A z it restricts next: on
  config 4's lumped 128³ fine level from zero and from z (Jacobi), on its
  64³ Galerkin level (kind-4 Chebyshev, 27 channels) and on config 5's
  2048² and 512² diagonal levels from zero. A tree whose ``fused_smooth``
  writes the residual (``residual=True``) is timed in that call; another
  tree in its ``fused_smooth`` call and the plain residual its cycle
  computes after it;
- ms/field (``sdf_from_points``, after a warm-up field) and, from
  ``torch.profiler`` over one more field, kernels and launch calls per
  field and the device's idle share: config 4 (128³, 4000 points, tol 1e-4,
  seeds 0..1, each twice), config 4-cg (kind-4 Chebyshev and Galerkin coarse
  data, seed 0, twice), config 5's proxy (4096², 100 000 points,
  ``fmg_start=1``, seed 0, twice) and field C (992², 4000 points,
  ``fmg_start=1``, seed 0, twice);
- the ptxas registers of the segment, cycle and smoothing kernels (from the
  run that built them).

Only what both designs share is used: the wrappers' signatures and the
operand builders of ``multigrid``. ``--ab`` ends with the keep-or-drop rule
for the smoothing design: config 4's and config 5's median ms/field below
A's, and no main-path field's median more than 3% above A's.
"""

import argparse
import importlib.util
import inspect
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("pcg_segment", "mg_cycle2d", "jacobi_sweep_kernel", "smooth_phase_kernel")
TIMES = ("segment_v", "segment_w", "segment_cheb", "segment_cheb_gal", "cycle_w", "cycle_v")
PHASES = ("smooth_128_lumped_from_zero", "smooth_128_lumped_from_z",
          "smooth_64_galerkin_cheb_from_zero", "smooth_2048_diag_from_zero",
          "smooth_512_diag_from_zero")
FIELDS = ("config4", "config4cg", "config5", "field_c")
MAIN_PATH = ("headline_ms", "field_a_ms") + FIELDS
ORDER = "ABBABAAB"


def helpers():
    """chip_smoke.py of this tree, for its inputs and timers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def registers(log):
    """{kernel: ptxas registers of each instantiation} of the segment,
    cycle and smoothing kernels."""
    out, name = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif "Used" in line and "registers" in line:
            for key in KERNELS:
                if key in name:
                    out.setdefault(key, []).append(int(line.split("Used")[1].split()[0]))
    return out


def smoothing_phases(h, ft, device):
    """{phase: dict(ms, b2b_ms)} of the smoothing phases (module doc)."""
    import numpy as np
    import torch
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply_plain
    writes_residual = "residual" in inspect.signature(fused_smooth).parameters
    rng = np.random.default_rng(21)

    def phase_call(lv, fz, cheb, nd):
        coeff, inv, sid_j, cf, w = lv
        sid, cf = (inv, cf) if cheb else (sid_j, None)
        r, z = (torch.as_tensor(rng.standard_normal(tuple(inv.shape)).astype(np.float32),
                                device=device) for _ in range(2))
        if writes_residual:
            return lambda: fused_smooth(r, z, coeff, sid, w, nd, 3, fz, cheb_coefs=cf,
                                        residual=True)

        def parent():
            out = fused_smooth(r, z, coeff, sid, w, nd, 3, fz, cheb_coefs=cf)
            return out, r - fused_normal_apply_plain(out, coeff, w, nd)
        return parent

    w = ft.Weights(model_2=0.3)
    p128 = ft.assemble_sdf(ft.Grid(h.SHAPE3), w, *h.sphere_inputs(0, device))
    lv4 = h.smoothing_levels(p128, ft.SolverConfig(tol=1e-4), 3)
    lv4cg = h.smoothing_levels(p128, ft.SolverConfig(tol=1e-4, **h.CHEB, **h.GALERKIN), 3)
    del p128
    p5 = ft.assemble_sdf(ft.Grid(h.SHAPE5), w, *h.circle5_inputs(0, device))
    lv5 = h.smoothing_levels(p5, ft.SolverConfig(**h.CFG5), 3)
    del p5
    calls = dict(smooth_128_lumped_from_zero=phase_call(lv4[0], True, False, 3),
                 smooth_128_lumped_from_z=phase_call(lv4[0], False, False, 3),
                 smooth_64_galerkin_cheb_from_zero=phase_call(lv4cg[1], True, True, 3),
                 smooth_2048_diag_from_zero=phase_call(lv5[1], True, False, 2),
                 smooth_512_diag_from_zero=phase_call(lv5[3], True, False, 2))
    return {name: dict(ms=h.cuda_ms(call), b2b_ms=h.batch_ms(call))
            for name, call in calls.items()}


def fields(h, ft, device):
    """{field: dict(ms=[...], kernels, launch_calls, idle)} (module doc)."""
    w = ft.Weights(model_2=0.3)
    g4, g5, gc = ft.Grid(h.SHAPE3), ft.Grid(h.SHAPE5), ft.Grid(h.SHAPE_C)
    cfg4 = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="auto")
    cfg4cg = ft.SolverConfig(tol=1e-4, **h.CHEB, **h.GALERKIN)
    cfg5 = ft.SolverConfig(**h.CFG5)
    in4 = [h.sphere_inputs(s, device) for s in h.SEEDS3]
    in5 = h.circle5_inputs(0, device)
    inc = h.field_a_inputs(0, device, h.SHAPE_C, h.N_POINTS_C)
    runs = dict(
        config4=[lambda i=i: ft.sdf_from_points(g4, w, *i, config=cfg4)
                 for _ in range(2) for i in in4],
        config4cg=[lambda: ft.sdf_from_points(g4, w, *in4[0], config=cfg4cg)] * 2,
        config5=[lambda: ft.sdf_from_points(g5, w, *in5, config=cfg5,
                                            fmg_start=h.FMG5)] * 2,
        field_c=[lambda: ft.sdf_from_points(gc, w, *inc, config=ft.SolverConfig(tol=1e-4),
                                            fmg_start=1)] * 2)
    out = {}
    for name, calls in runs.items():
        calls[0]()  # warm-up
        ms = [h.timed(call)[1] for call in calls]
        out[name] = dict(ms=ms, **h.profile_fields(name, calls[:1], ()))
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
    rec["phases"] = smoothing_phases(h, ft, device)
    rec["fields"] = fields(h, ft, device)
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth
    rec["launches"] = dict(fused_pcg_solve=fused_pcg_solve.launches,
                           fused_wcycle_2d=fused_wcycle_2d.launches,
                           fused_vcycle_2d=fused_vcycle_2d.launches,
                           fused_smooth=fused_smooth.launches)
    h.require(all(rec["launches"].values()), f"a kernel did not launch: {rec['launches']}")
    return rec


def ab(other):
    """Run ``other`` (A) and this tree (B) as A B B A B A A B; print each run and the table."""
    runs = []
    for side in ORDER:
        tree = other if side == "A" else HERE
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

    def values(rec, key, sub=None):
        if key in FIELDS:  # a field: its ms/field, or its profile's `sub`
            v = rec["fields"][key]
            return v["ms"] if sub is None else [v[sub]]
        if key in PHASES:
            return [rec["phases"][key][sub]]
        return rec[key] if sub is None else [rec[key][sub]]

    def med(side, key, sub=None):
        return statistics.median(v for r in runs if r["side"] == side
                                 for v in values(r, key, sub))

    rows = [(f"{k} {s}", k, s) for k in TIMES + PHASES for s in ("b2b_ms", "ms")]
    rows += [("headline ms/field", "headline_ms", None), ("field A ms/field", "field_a_ms", None)]
    rows += [(f"{k} {s}", k, s) for k in FIELDS
             for s in (None, "kernels", "launch_calls", "idle")]
    for label, key, sub in rows:
        a, b = med("A", key, sub), med("B", key, sub)
        print(f"{label.replace(' None', ' ms/field')}: A {a:.4f}  B {b:.4f}  B/A {b / a:.3f}")
    for key in TIMES[:4]:
        print(f"{key} iterations: A {[r[key]['iterations'] for r in runs if r['side'] == 'A']} "
              f"B {[r[key]['iterations'] for r in runs if r['side'] == 'B']}")
    for key in MAIN_PATH:
        per_run = {side: [round(statistics.median(values(r, key)), 1) for r in runs
                          if r["side"] == side] for side in "AB"}
        print(f"{key} per-run medians: A {per_run['A']} B {per_run['B']}")
    ratios = {key: med("B", key) / med("A", key) for key in MAIN_PATH}
    keep = (ratios["config4"] < 1 and ratios["config5"] < 1
            and all(v <= 1.03 for v in ratios.values()))
    print(f"keep-or-drop rule (config 4 and 5 below A, no main-path field above 1.03x A): "
          f"{'keep' if keep else 'drop'} B; B/A {json.dumps(ratios)}")


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
