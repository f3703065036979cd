#!/usr/bin/env python3
"""Time the multi-sweep kernel's smoothing phases beside variants of its body, on one card.

    python3 multisweep_probe.py [--parent DIR]

Run from the repository root on a machine with one CUDA card and nvcc.
Every phase (ν sweeps of ``fused_smooth_2d``, Jacobi or Chebyshev, from zero
with the residual or from z) is timed back to back (median of three batches
of 20 calls, CUDA events) through:

- ``kernel``: ``csrc/jacobi_multisweep2d.cu`` as it is;
- ``rows64``: the same with at least 64 output rows per block (kMinRows);
- ``no_copies``: the copying warp copies nothing (the sweeps' time alone);
- ``no_sweeps``: the stages do nothing (the copies' and barriers' time);
- ``no_edges``: the interior form at every node (what the edge windows cost);
- ``per_sweep``: the same phase through the per-sweep kernel
  (``fused_smooth``, ``csrc/jacobi_sweep.cu``);
- with ``--parent DIR``, another checkout's ``fused_smooth_2d``, in a
  process of its own (a tree whose ``fused_smooth_2d`` writes no residual
  with its apply kernel and a subtraction after the call).

Each variant is the kernel's source with one line replaced, built with nvcc
into ``build/multisweep_probe/``; the variants' values are wrong where they
skip work, and only ``kernel`` is held to the plain version (2e-5 of its
largest value). Prints the card, each variant's ptxas registers, one JSON
line per phase and a table of the times in ms.
"""

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
CSRC = HERE / "field_interpolation_tpu_torch" / "csrc"
OUT = HERE / "build" / "multisweep_probe"
STAGE_ROW = "        const int x = y0 + u;\n        if (x < 0 || x >= n0) continue;"
VARIANTS = {
    "rows64": ("constexpr int kMinRows = 32;", "constexpr int kMinRows = 64;"),
    "no_copies": ("if (!producer || y < 0 || y >= n0) return;", "return;"),
    "no_sweeps": (STAGE_ROW, "        continue;\n" + STAGE_ROW),
    "no_edges": ("if (x >= kRho && x < n0 - kRho && j >= kRho && j + kCols <= n1 - kRho) {",
                 "if (true) {"),
}
# (name, shape, radius, ν, from zero, residual, Chebyshev)
PHASES = [
    ("4096_r2_from_zero_res", (4096, 4096), 2, 3, True, True, False),
    ("4096_r2_from_z", (4096, 4096), 2, 3, False, False, False),
    ("2048_r2_from_z", (2048, 2048), 2, 3, False, False, False),
    ("992_r2_from_zero_res", (992, 992), 2, 3, True, True, False),
    ("992_r2_from_z", (992, 992), 2, 3, False, False, False),
    ("1000x1030_r2_from_zero_res", (1000, 1030), 2, 3, True, True, False),
    ("1000x1032_r2_from_zero_res", (1000, 1032), 2, 3, True, True, False),
    ("1000x1030_r3_nu2_from_z", (1000, 1030), 3, 2, False, False, False),
    ("1000x1032_r3_nu2_from_z", (1000, 1032), 3, 2, False, False, False),
    ("1000x1030_r3_from_z_res", (1000, 1030), 3, 3, False, True, False),
    ("1000x1030_r3_cheb_from_z", (1000, 1030), 3, 3, False, False, True),
    ("4096_r3_from_zero_res", (4096, 4096), 3, 3, True, True, False),
]


def helpers():
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_variants(_build):
    """{variant: loaded library}: the kernel source and its one-line
    substitutions, each compiled alone, side by side."""
    src = (CSRC / "jacobi_multisweep2d.cu").read_text()
    sources = {"kernel": src}
    for name, (old, new) in VARIANTS.items():
        if src.count(old) != 1:
            raise SystemExit(f"multisweep_probe: variant {name}: the line to replace is not "
                             f"in the kernel once: {old!r}")
        sources[name] = src.replace(old, new)
    procs = {}
    for name, text in sources.items():
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        (d / "k.cu").write_text(text + '\nextern "C" const char* fi_error_string(int c) '
                                       '{ return cudaGetErrorString((cudaError_t)c); }\n')
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I", str(CSRC), "-o",
             str(d / "k.so"), str(d / "k.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"multisweep_probe: nvcc failed on {name}:\n{log}")
        regs = [ln.split("Used")[1].split(",")[0].strip() for ln in log.splitlines()
                if "Used" in ln and "registers" in ln]
        print(f"{name}: ptxas {regs}", flush=True)
        lib = ctypes.CDLL(str(OUT / name / "k.so"))
        for fn, args in [("fi_multisweep2d_phase", _build._SIGNATURES["fi_multisweep2d_phase"]),
                         ("fi_error_string", (ctypes.c_int,))]:
            getattr(lib, fn).argtypes = list(args)
        lib.fi_multisweep2d_phase.restype = ctypes.c_int
        lib.fi_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def operands(h, ft, device):
    """{phase: (r, z, coeff, sid, weights, ν, from zero, residual, schedule)}."""
    import numpy as np
    import torch
    rng = np.random.default_rng(3)
    weights = {2: ft.Weights(model_2=0.3), 3: ft.Weights(**h.RADIUS3_WEIGHTS)}
    out = {}
    for name, shape, radius, nu, fz, res, cheb in PHASES:
        n = 100_000 if shape[0] >= 4096 else 50_000 if shape[0] >= 2048 else 20_000
        p = ft.assemble_sdf(ft.Grid(shape), weights[radius],
                            *h.circle5_inputs(0, device, shape, n))
        cfg = ft.SolverConfig(**h.CFG5, **(h.CHEB if cheb else {}))
        coeff, inv, sid, cf, w = h.smoothing_levels(p, cfg, nu)[0]
        r, z = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)
                for _ in range(2))
        out[name] = (r, z, coeff, inv if cheb else sid, w, nu, fz, res, cf if cheb else None)
    return out


def b2b(h, call):
    return sorted(h.batch_ms(call) for _ in range(3))[1]


def parent_times(h):
    """Run in the other tree's process: {phase: b2b ms} of its fused_smooth_2d."""
    import inspect
    import torch
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops.smooth import fused_smooth_2d
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    has_res = "residual" in inspect.signature(fused_smooth_2d).parameters
    out = {}
    for name, (r, z, coeff, sid, w, nu, fz, res, cf) in operands(
            h, ft, torch.device("cuda", 0)).items():
        def call():
            if res and has_res:
                return fused_smooth_2d(r, z, coeff, sid, w, nu, fz, cheb_coefs=cf, residual=True)
            got = fused_smooth_2d(r, z, coeff, sid, w, nu, fz, cheb_coefs=cf)
            return (got, r - fused_normal_apply(got, coeff, w, 2)) if res else got
        out[name] = b2b(h, call)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="another checkout, timed in its own process")
    ap.add_argument("--tree", type=Path, help=argparse.SUPPRESS)
    opts = ap.parse_args()
    if opts.tree:  # the other tree's side of --parent
        sys.path.insert(0, str(opts.tree.resolve()))
        print(json.dumps(parent_times(helpers())))
        return
    import torch
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops import _build, smooth
    h = helpers()
    h.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    print(h.card_line(), flush=True)
    libs = build_variants(_build)
    ops = operands(h, ft, torch.device("cuda", 0))
    library = _build.library
    rows = {}
    for name, (r, z, coeff, sid, w, nu, fz, res, cf) in ops.items():
        rec = {}
        for variant, lib in [*libs.items(), ("per_sweep", library())]:
            if variant == "per_sweep":
                _build.library = library

                def call():
                    return smooth.fused_smooth(r, z, coeff, sid, w, 2, nu, fz, cheb_coefs=cf,
                                               residual=res)
            else:
                _build.library = lambda lib=lib: lib

                def call():
                    return smooth.fused_smooth_2d(r, z, coeff, sid, w, nu, fz, cheb_coefs=cf,
                                                  residual=res)
            if variant == "kernel":
                want = smooth.fused_smooth_plain(r, z, coeff, sid, w, 2, nu, fz, cf,
                                                 residual=res)
                pairs = zip(call(), want) if res else [(call(), want)]
                for got, ref in pairs:
                    err = float((got - ref).abs().max())
                    h.require(err <= 2e-5 * float(ref.abs().max()),
                              f"{name}: kernel against plain {err:.3e}")
            rec[variant] = b2b(h, call)
        _build.library = library
        rows[name] = rec
        print(json.dumps({"phase": name, **rec}), flush=True)
    if opts.parent:
        proc = subprocess.run([sys.executable, __file__, "--tree", str(opts.parent)],
                              capture_output=True, text=True, timeout=900)
        if proc.returncode:
            raise SystemExit(f"multisweep_probe: the parent's run failed:\n{proc.stderr[-3000:]}")
        for name, ms in json.loads(proc.stdout.strip().splitlines()[-1]).items():
            rows[name]["parent"] = ms
    cols = list(next(iter(rows.values())))
    print("phase (b2b ms) " + " ".join(cols))
    for name, rec in rows.items():
        print(name, " ".join(f"{rec[c]:.4f}" for c in cols))


if __name__ == "__main__":
    main()
