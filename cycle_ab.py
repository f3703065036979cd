#!/usr/bin/env python3
"""Time the cycle and smoothing kernels of two trees of this repository, in turn, on one card.

    python3 cycle_ab.py --ab DIR    # DIR and this tree in turn, eight runs; then a table
    python3 cycle_ab.py --tree DIR  # one tree (default: this one); one JSON line
    python3 cycle_ab.py --ab DIR --kernels  # only the segment and whole-cycle kernels

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
  three calls), after a warm-up field, and the device-busy ms of one more
  field of each from ``torch.profiler``;
- the smoothing phases of the plain-cycle path as its cycle runs them, the
  pre-smoothing call (ν = 3) and the residual r − A z it restricts next: on
  config 4's lumped 128³ fine level from zero and from z (Jacobi), on its
  64³ Galerkin level (kind-4 Chebyshev, 27 channels) and on config 5's
  2048² and 512² diagonal levels from zero. A tree whose ``fused_smooth``
  writes the residual (``residual=True``) is timed in that call; another
  tree in its ``fused_smooth`` call and the plain residual its cycle
  computes after it;
- the 9-channel phases of the multi-sweep kernel (``fused_smooth_2d``), ν =
  3: config 5's 4096² fine level from zero with the residual (the
  pre-smoothing) and from z (the post-smoothing), the fmg grid's 2048² fine
  level from zero with the residual, the 4096² pre-smoothing under kind-4
  Chebyshev; on a 1000×1030 grid (rows not 16-byte aligned; 20 000 circle
  points) the pre-smoothing with config 5's weights (ρ = 2) and with
  radius-3 weights, and the radius-3 Chebyshev phase from z. A tree whose
  ``fused_smooth_2d`` writes no residual is timed with its apply kernel and
  a subtraction after the call, as its cycle computes the residual;
- ms/field (``sdf_from_points``, after a warm-up field) and, from
  ``torch.profiler`` over one more field, kernels, launch calls and
  device-busy ms per field and the device's idle share: config 4 (128³,
  4000 points, tol 1e-4, seeds 0..1, each twice), config 4-cg (kind-4 Chebyshev and Galerkin coarse
  data, seed 0, twice), config 5's proxy (4096², 100 000 points,
  ``fmg_start=1``, seed 0, twice), config 5-cheb (the same under kind-4
  Chebyshev) and field C (992², 4000 points, ``fmg_start=1``, seed 0,
  twice); and in the warm-up field the launches of the apply, per-sweep and
  multi-sweep wrappers;
- the ptxas registers of the segment, cycle and smoothing kernels (from the
  run that built them).

With ``--kernels`` a run stops after the segment and whole-cycle kernels,
and the table has their rows and the registers alone (~1 min a run).
``--ab`` also says whether the single-field segment kernel and the
whole-cycle kernel compile to the same machine code in the two trees
(``cuobjdump -sass`` of each tree's library, the anonymous-namespace tags
taken out).

Only what both designs share is used: the wrappers' signatures and the
operand builders of ``multigrid``. ``--ab`` ends with every 9-channel
phase's ratio (naming those where B is not below A) and the keep-or-drop
rule for the multi-sweep design twice: each 4096² 9-channel phase below A's
back to back, config 5's and field C's fields not above A's, and no
main-path field more than 3% above A's, once on the median ms/field and
once on the device-busy ms per field from ``torch.profiler`` (with the
launch calls per field not above A's). The second decides: a field's host
time moves ±20% between runs of the same tree, which no eight runs
resolve to 3%, while its device-busy time moves under 1% (PERF.md).
"""

import argparse
import importlib.util
import inspect
import json
import re
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("pcg_segment", "mg_cycle2d", "jacobi_sweep_kernel", "smooth_phase_kernel",
           "multisweep2d_kernel")
TIMES = ("segment_v", "segment_w", "segment_cheb", "segment_cheb_gal", "cycle_w", "cycle_v")
PHASES = ("smooth_128_lumped_from_zero", "smooth_128_lumped_from_z",
          "smooth_64_galerkin_cheb_from_zero", "smooth_2048_diag_from_zero",
          "smooth_512_diag_from_zero")
# The 9-channel phases of the multi-sweep kernel, as the cycle runs them.
PHASES_9CH = ("smooth_4096_9ch_from_zero", "smooth_4096_9ch_from_z",
              "smooth_2048_9ch_from_zero", "smooth_4096_9ch_cheb_from_zero",
              "smooth_1000x1030_9ch_from_zero", "smooth_1000x1030_r3_from_zero",
              "smooth_1000x1030_r3_cheb_from_z")
FIELDS = ("config4", "config4cg", "config5", "config5cheb", "field_c")
COUNTED = ("fused_normal_apply", "fused_smooth", "fused_smooth_2d")
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
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_2d
    from field_interpolation_tpu_torch.ops.stencil import (fused_normal_apply,
                                                           fused_normal_apply_plain)
    writes_residual = "residual" in inspect.signature(fused_smooth).parameters
    writes_residual_9ch = "residual" in inspect.signature(fused_smooth_2d).parameters
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

    def phase_9ch(lv, fz, cheb):
        # The pre-smoothing (from zero) with the residual the cycle
        # restricts; the post-smoothing (from z) without; through the
        # kernel the tree's cycle sends the phase to (its
        # multigrid._kernel_smoother). A tree whose fused_smooth_2d writes
        # no residual: its call, then the apply kernel and a subtraction,
        # as its cycle computes it.
        coeff, inv, sid_j, cf, w = lv
        sid, cf = (inv, cf) if cheb else (sid_j, None)
        r, z = (torch.as_tensor(rng.standard_normal(tuple(inv.shape)).astype(np.float32),
                                device=device) for _ in range(2))
        if writes_residual_9ch:
            smooth = tmg._kernel_smoother(coeff, sid, w, 2, (lambda n: cf) if cheb else None)
            return lambda: smooth(r, z, 3, fz, fz)
        if not fz:
            return lambda: fused_smooth_2d(r, z, coeff, sid, w, 3, fz, cheb_coefs=cf)

        def parent():
            out = fused_smooth_2d(r, z, coeff, sid, w, 3, fz, cheb_coefs=cf)
            return out, r - fused_normal_apply(out, coeff, w, 2)
        return parent

    w = ft.Weights(model_2=0.3)
    p128 = ft.assemble_sdf(ft.Grid(h.SHAPE3), w, *h.sphere_inputs(0, device))
    lv4 = h.smoothing_levels(p128, ft.SolverConfig(tol=1e-4), 3)
    lv4cg = h.smoothing_levels(p128, ft.SolverConfig(tol=1e-4, **h.CHEB, **h.GALERKIN), 3)
    del p128
    pts, nrm = h.circle5_inputs(0, device)
    p5 = ft.assemble_sdf(ft.Grid(h.SHAPE5), w, pts, nrm)
    lv5 = h.smoothing_levels(p5, ft.SolverConfig(**h.CFG5), 3)
    lv5c = h.smoothing_levels(p5, ft.SolverConfig(**h.CFG5, **h.CHEB), 3)
    del p5
    # The fmg guess's problem: the same cloud on the (n+1)//2 grid.
    cshape = tuple((n + 1) // 2 for n in h.SHAPE5)
    scale = (np.asarray(cshape) - 1.0) / (np.asarray(h.SHAPE5) - 1.0)
    p2 = ft.assemble_sdf(ft.Grid(cshape), w, pts * torch.as_tensor(
        scale, dtype=torch.float32, device=device), nrm)
    lv2 = h.smoothing_levels(p2, ft.SolverConfig(**h.CFG5), 3)
    del p2
    # A grid whose rows are not 16-byte aligned (1030 % 4 = 2), with config
    # 5's weights (ρ = 2) and with radius-3 weights.
    odd = (1000, 1030)
    odd_in = h.circle5_inputs(0, device, odd, 20_000)
    po = ft.assemble_sdf(ft.Grid(odd), w, *odd_in)
    lvo = h.smoothing_levels(po, ft.SolverConfig(**h.CFG5), 3)
    po3 = ft.assemble_sdf(ft.Grid(odd), ft.Weights(**h.RADIUS3_WEIGHTS), *odd_in)
    lvo3 = h.smoothing_levels(po3, ft.SolverConfig(**h.CFG5), 3)
    lvo3c = h.smoothing_levels(po3, ft.SolverConfig(**h.CFG5, **h.CHEB), 3)
    del po, po3
    calls = dict(smooth_128_lumped_from_zero=phase_call(lv4[0], True, False, 3),
                 smooth_128_lumped_from_z=phase_call(lv4[0], False, False, 3),
                 smooth_64_galerkin_cheb_from_zero=phase_call(lv4cg[1], True, True, 3),
                 smooth_2048_diag_from_zero=phase_call(lv5[1], True, False, 2),
                 smooth_512_diag_from_zero=phase_call(lv5[3], True, False, 2),
                 smooth_4096_9ch_from_zero=phase_9ch(lv5[0], True, False),
                 smooth_4096_9ch_from_z=phase_9ch(lv5[0], False, False),
                 smooth_2048_9ch_from_zero=phase_9ch(lv2[0], True, False),
                 smooth_4096_9ch_cheb_from_zero=phase_9ch(lv5c[0], True, True),
                 smooth_1000x1030_9ch_from_zero=phase_9ch(lvo[0], True, False),
                 smooth_1000x1030_r3_from_zero=phase_9ch(lvo3[0], True, False),
                 smooth_1000x1030_r3_cheb_from_z=phase_9ch(lvo3c[0], False, True))
    return {name: dict(ms=h.cuda_ms(call), b2b_ms=h.batch_ms(call))
            for name, call in calls.items()}


def fields(h, ft, device):
    """{field: dict(ms=[...], kernels, launch_calls, idle, counted)} (module
    doc); ``counted``: the launches each kernel wrapper of COUNTED made in
    the warm-up field."""
    from field_interpolation_tpu_torch.ops import smooth, stencil
    wrappers = [getattr(stencil if n == "fused_normal_apply" else smooth, n) for n in COUNTED]
    w = ft.Weights(model_2=0.3)
    g4, g5, gc = ft.Grid(h.SHAPE3), ft.Grid(h.SHAPE5), ft.Grid(h.SHAPE_C)
    cfg4 = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", backend="auto")
    cfg4cg = ft.SolverConfig(tol=1e-4, **h.CHEB, **h.GALERKIN)
    cfg5 = ft.SolverConfig(**h.CFG5)
    cfg5cheb = ft.SolverConfig(**h.CFG5, **h.CHEB)
    in4 = [h.sphere_inputs(s, device) for s in h.SEEDS3]
    in5 = h.circle5_inputs(0, device)
    inc = h.field_a_inputs(0, device, h.SHAPE_C, h.N_POINTS_C)
    runs = dict(
        config4=[lambda i=i: ft.sdf_from_points(g4, w, *i, config=cfg4)
                 for _ in range(2) for i in in4],
        config4cg=[lambda: ft.sdf_from_points(g4, w, *in4[0], config=cfg4cg)] * 2,
        config5=[lambda: ft.sdf_from_points(g5, w, *in5, config=cfg5,
                                            fmg_start=h.FMG5)] * 2,
        config5cheb=[lambda: ft.sdf_from_points(g5, w, *in5, config=cfg5cheb,
                                                fmg_start=h.FMG5)] * 2,
        field_c=[lambda: ft.sdf_from_points(gc, w, *inc, config=ft.SolverConfig(tol=1e-4),
                                            fmg_start=1)] * 2)
    out = {}
    for name, calls in runs.items():
        before = [f.launches for f in wrappers]
        calls[0]()  # warm-up
        counted = {n: f.launches - b for n, f, b in zip(COUNTED, wrappers, before)}
        ms = [h.timed(call)[1] for call in calls]
        out[name] = dict(ms=ms, counted=counted, **h.profile_fields(name, calls[:1], ()))
    return out


def measure(tree, kernels_only=False):
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
    if kernels_only:
        return rec

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
    rec["headline_busy_ms"] = h.profile_fields("headline", [lambda: ft.sdf_from_points_precise(
        grid, w, *inputs[0], config=cfg)], ())["busy_ms"]
    rec["field_a_busy_ms"] = h.profile_fields("field A", [lambda: ft.sdf_from_points(
        grid_a, w, *ina, config=cfg_a)], ())["busy_ms"]
    rec["phases"] = smoothing_phases(h, ft, device)
    rec["fields"] = fields(h, ft, device)
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth, fused_smooth_2d
    rec["launches"] = dict(fused_pcg_solve=fused_pcg_solve.launches,
                           fused_wcycle_2d=fused_wcycle_2d.launches,
                           fused_vcycle_2d=fused_vcycle_2d.launches,
                           fused_smooth=fused_smooth.launches,
                           fused_smooth_2d=fused_smooth_2d.launches)
    h.require(all(rec["launches"].values()), f"a kernel did not launch: {rec['launches']}")
    return rec


# An anonymous namespace's mangled name (its length, then _GLOBAL__N__, a
# hash, the source's name and a hash of its contents): it differs between
# trees whose source differs, whatever the code.
_ANON = re.compile(r"\d*_GLOBAL__N__[0-9a-f]{8}_\d+_\w+?_cu_[0-9a-f]{8}")

# Template arguments of the smoothing kernels before their lane forms took a
# last one (the lane index, false for one field).
_SMOOTH_ARGS = {"smooth_phase_kernel": 3, "multisweep2d_kernel": 2}


def _single_field_kernel(name):
    """The key under which ``name`` (a mangled kernel name, namespace tags
    taken out) is compared across trees, or None: the single-field segment
    and whole-cycle kernels, and each single-field instantiation of the
    smoothing kernels (their lane forms' lane argument dropped when false;
    the lane forms themselves are not compared)."""
    if "18pcg_segment_kernel" in name:
        return "pcg_segment_kernel"
    if "mg_cycle2d_kernel" in name:
        return None if "LaneSync" in name else "mg_cycle2d_kernel"
    m = re.search(r"(smooth_phase_kernel|multisweep2d_kernel)I((?:L[ib]\d+E)+)E", name)
    if not m:
        return None
    args = re.findall(r"L[ib]\d+E", m.group(2))
    n = _SMOOTH_ARGS[m.group(1)]
    if len(args) > n:
        if args[n] != "Lb0E":
            return None
        args = args[:n]
    return m.group(1) + "".join(args)


def same_sass(trees):
    """{kernel: whether its SASS is the same in every tree's library} of
    the single-field segment, whole-cycle and smoothing kernels; None
    without cuobjdump."""
    import glob
    import hashlib
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return None
    seen = {}
    for tree in trees:
        lib = max(glob.glob(str(Path(tree) / "build" / "torch_kernels" / "*.so")),
                  key=lambda f: Path(f).stat().st_mtime)
        sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                              check=True).stdout
        for func in re.split(r"\n\s*Function : ", sass)[1:]:
            name = _ANON.sub("", func.split("\n", 1)[0].strip())
            key = _single_field_kernel(name)
            if key:
                seen.setdefault(key, set()).add(
                    hashlib.sha256(sass_code(func).encode()).hexdigest())
    return {k: len(v) == 1 for k, v in seen.items()}


def sass_code(func):
    """A function's instructions from ``cuobjdump -sass`` (after its
    "Function : " line), with what differs between trees whose code is the
    same taken out: the column padding and encodings, namespace tags, and
    the file-wide numbers of branch labels, renumbered in order of first
    use."""
    code = "\n".join(" ".join(l.split("*/", 1)[-1].split(";", 1)[0].split())
                     for l in func.split("\n")[1:] if "/*" in l)
    labels = {}
    return re.sub(r"\.L_x_\d+", lambda m: labels.setdefault(m.group(0), f"L{len(labels)}"),
                  _ANON.sub("", code))


def ab(other, kernels_only=False):
    """Run ``other`` (A) and this tree (B) as A B B A B A A B; print each run and the table."""
    runs = []
    for side in ORDER:
        tree = other if side == "A" else HERE
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree",
                               str(tree)] + (["--kernels"] if kernels_only else []),
                              capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"cycle_ab FAILED: the run of {tree} exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}")
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]), side=side)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    print(f"A = {other}, B = {HERE}; card {runs[0]['card']}")
    print(f"same SASS in A and B: {same_sass([other, HERE])}")
    for side in "AB":
        regs = [r["registers"] for r in runs if r["side"] == side and r["registers"]]
        print(f"{side} ptxas registers: {regs[0] if regs else 'not built in these runs'}")

    def values(rec, key, sub=None):
        if key in FIELDS:  # a field: its ms/field, or its profile's `sub`
            v = rec["fields"][key]
            return v["ms"] if sub is None else [v[sub]]
        if sub == "busy_ms":  # the headline's or field A's device-busy ms
            return [rec[key.replace("_ms", "_busy_ms")]]
        if key in PHASES + PHASES_9CH:
            return [rec["phases"][key][sub]]
        return rec[key] if sub is None else [rec[key][sub]]

    def med(side, key, sub=None):
        return statistics.median(v for r in runs if r["side"] == side
                                 for v in values(r, key, sub))

    if kernels_only:
        for key in TIMES:
            for sub in ("b2b_ms", "ms"):
                a, b = med("A", key, sub), med("B", key, sub)
                print(f"{key} {sub}: A {a:.4f}  B {b:.4f}  B/A {b / a:.3f}")
        for key in TIMES[:4]:
            print(f"{key} iterations: A {[r[key]['iterations'] for r in runs if r['side'] == 'A']}"
                  f" B {[r[key]['iterations'] for r in runs if r['side'] == 'B']}")
        return
    rows = [(f"{k} {s}", k, s) for k in TIMES + PHASES + PHASES_9CH for s in ("b2b_ms", "ms")]
    rows += [("headline ms/field", "headline_ms", None), ("field A ms/field", "field_a_ms", None),
             ("headline busy_ms", "headline_ms", "busy_ms"),
             ("field A busy_ms", "field_a_ms", "busy_ms")]
    rows += [(f"{k} {s}", k, s) for k in FIELDS
             for s in (None, "kernels", "launch_calls", "idle", "busy_ms")]
    for label, key, sub in rows:
        a, b = med("A", key, sub), med("B", key, sub)
        print(f"{label.replace(' None', ' ms/field')}: A {a:.4f}  B {b:.4f}  B/A {b / a:.3f}")
    for key in TIMES[:4]:
        print(f"{key} iterations: A {[r[key]['iterations'] for r in runs if r['side'] == 'A']} "
              f"B {[r[key]['iterations'] for r in runs if r['side'] == 'B']}")
    for key in FIELDS:
        for side in "AB":
            counted = [r["fields"][key]["counted"] for r in runs if r["side"] == side]
            print(f"{key} {side} wrapper launches per field: {counted[0]}")
    for key in MAIN_PATH:
        per_run = {side: [round(statistics.median(values(r, key)), 1) for r in runs
                          if r["side"] == side] for side in "AB"}
        print(f"{key} per-run medians: A {per_run['A']} B {per_run['B']}")
    phases = {key: med("B", key, "b2b_ms") / med("A", key, "b2b_ms") for key in PHASES_9CH}
    slower = sorted(k for k, v in phases.items() if v >= 1)
    print(f"9-channel phases B/A (b2b) {json.dumps(phases)}; B not below A on "
          f"{slower or 'none'}")
    phases_ok = all(v < 1 for k, v in phases.items() if k.startswith("smooth_4096"))
    launches_ok = all(med("B", k, "launch_calls") <= med("A", k, "launch_calls") for k in FIELDS)
    for sub, metric in ((None, "median ms/field"), ("busy_ms", "device-busy ms per field")):
        ratios = {key: med("B", key, sub) / med("A", key, sub) for key in MAIN_PATH}
        keep = (phases_ok and ratios["config5"] <= 1 and ratios["field_c"] <= 1
                and all(v <= 1.03 for v in ratios.values())
                and (sub is None or launches_ok))
        print(f"keep-or-drop rule on {metric} (each 4096² 9-channel phase below A back to "
              f"back, config 5 and field C not above A, no main-path field above 1.03x A"
              f"{', launch calls per field not above A' if sub else ''}): "
              f"{'keep' if keep else 'drop'} B; fields B/A {json.dumps(ratios)}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE, help="the tree to measure alone")
    ap.add_argument("--ab", type=Path, help="the other tree (A), measured beside this one (B)")
    ap.add_argument("--kernels", action="store_true",
                    help="only the segment and whole-cycle kernels")
    opts = ap.parse_args()
    if opts.ab:
        ab(opts.ab.resolve(), opts.kernels)
    else:
        print(json.dumps(measure(opts.tree.resolve(), opts.kernels)))


if __name__ == "__main__":
    main()
