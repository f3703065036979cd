#!/usr/bin/env python3
"""Where a batch of fields should go, and what bounds the batched segment, on one card.

    python3 batch_probe.py [--crossover [fused|cycle]] [--scaling] [--lane T,M] [--out FILE]
    python3 batch_probe.py --ab DIR     # DIR and this tree in turn, eight runs; then a table
    python3 batch_probe.py --tree DIR   # one tree's batched segment times; one JSON line
    python3 batch_probe.py --split      # where a lane-iteration's time goes

Run from the repository root on a machine with one CUDA card and nvcc; with
no flag ``--crossover`` and ``--scaling`` both run. ``--lane T,M`` sets the
batched segment's geometry for the run (`ops.pcg.LANE_GEOMETRY`: T threads
a lane, M lanes an SM).

``--crossover``: B fields of n² (n = 32, 64, 128, 256; B = 1 to 64; 2n
oriented points a lane on circles as `chip_smoke.config3_inputs` makes
them, tol 1e-4, the default multigrid config) solved both ways a batch
can go: ``batched`` (`solver.solve_lanes(..., fused=True)`: one
`fused_pcg_solve_batch` launch per round for all lanes, one block per
lane) and ``lanes`` (`batch._by_lane`: the single-field `solve`, its
cooperative segment kernel spread over the card, once per lane). Each is
the median of three host-clock times (synchronized) after a warm-up, the
assembly excluded; both must converge every lane. Prints, per grid, the
smallest B at which ``batched`` is faster: the data behind
`batch.solve_route`'s rule. Then the same for the ``"cycle"`` route
(``--crossover cycle`` alone): B fields of 32³, 64³ and 128³ (config 4's
sphere clouds, `chip_smoke.make_sphere_cloud`, 4000·(n/128)² points a
lane) and 496² (field A's circle clouds, 2000 points), B = 1, 2, 4, 8, 16,
tol 1e-4, the default config, through ``cycle``
(`solver.solve_lanes(..., fused=False)`: `pcg_batch` with the batched
apply and cycle, one launch of each smoothing phase or whole cycle for all
lanes) and ``lanes``: the data behind `batch._cycle_wins`.

``--scaling``: the batched segment alone at 128² (config 3's operands)
and 256² with tol 0 and a budget of 8 iterations for every lane, so
every lane does the same work, for B from 1 to past one wave of resident
blocks; back to back (`chip_smoke.batch_ms`, 5 calls). A kernel bound by
HBM's rate takes time in proportion to B from the first lanes on; one
bound by each block's own latency takes the same time for every B up to
the lanes the card holds at once, then steps.

``--ab DIR``: the batched segment of two trees timed in turn, as
``cycle_ab.py --ab`` does: DIR (A; for example the parent commit unpacked
with ``git archive`` into a git-ignored directory) and this tree (B), each
run a process of its own that builds its tree's ``csrc`` and imports its
package (``--tree``), in the order A B B A B A A B. Each run times, back to
back, the ``--scaling`` points at 128² (B = 1, 8, 396, 1024) and 256² (B =
1, 396), every lane 8 iterations, and config 3's whole batch (1024 × 128²,
tol 1e-4 from zero, the operands of ``chip_smoke.py`` phase 38's "config 3,
every lane"), and reads the ptxas registers and spills of the batched
kernel from its build. Prints each run's record, then per measurement each
side's median and B/A, and the iterations of config 3's batch on each side.
A's first run also solves one batch of the benchmark's cell
``c3-b1024-true1e-6`` (its inputs from seed `BITS_SEED`) and saves each
segment launch's operands and x, iterations and ‖r‖² (``--bits``); B's first
run launches its segment on those operands (``--replay``) and compares its
outputs with A's by ``torch.equal``.

``--split``: where a lane-iteration's time goes. One-line variants of the
lane body (``csrc/lane2d.cuh``, the ``SPLIT`` table: ``fine_only``, the
cycle's work on level 0 alone, with no restriction's coarse visit, coarse
solve or prolongation; ``no_data``, the 9-channel data term read as one
plane) are built into ``build/batch_probe/<name>/`` and timed, with this
tree, at the ``--ab`` scaling points (every lane 8 iterations, so the work
per lane is the same whatever a variant does to the preconditioner), each
run a process of its own, in the order of the table and then the table
reversed; prints each variant's median per point beside this tree's.

Prints the card and one JSON line per measurement, and writes all of them
to ``--out`` (default ``build/batch_probe.json``).
"""

import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
GRIDS = [(32, 32), (64, 64), (128, 128), (256, 256)]
LANES = [1, 2, 4, 8, 16, 32, 64]
CYCLE_GRIDS = [(32, 32, 32), (64, 64, 64), (128, 128, 128), (496, 496)]
CYCLE_LANES = [1, 2, 4, 8, 16]
REPS = 3
SCALING = {(128, 128): [1, 8, 66, 132, 264, 396, 528, 660, 792, 1024],
           (256, 256): [1, 3, 33, 132, 264, 396, 528]}
BUDGET = 8
AB_SCALING = {(128, 128): [1, 8, 396, 1024], (256, 256): [1, 396]}
ORDER = "ABBABAAB"
BITS_CELL, BITS_SEED = "c3-b1024-true1e-6", 2**33 + 12345
# One-line variants of csrc/lane2d.cuh for --split: (old, new) substitutions.
SPLIT = {
    "fine_only": [
        ("        for (; l < Lv - 1; ++l) {", "        for (; l < 1; ++l) {"),
        ("        coarse_phase<T>(L);", "        (void)0;"),
        ("        for (l = Lv - 2;; --l) {", "        for (l = 0;; --l) {"),
        ("            prolong_phase<T>(L, l, z[l + 1], z[l], last);", "            (void)last;"),
    ],
    "no_data": [("    if (D) {", "    if (true) {")],
}


def helpers():
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(cs, ft, tb, shape, B, device):
    pts, nrm = cs.config3_inputs(device, B=B, shape=shape, n=2 * shape[0])
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(model_2=0.3), pts,
                             pts.new_zeros(pts.shape[:2]), gradients=nrm)


def cycle_problems(cs, ft, tb, shape, B, device):
    """B lanes of config 4's sphere clouds (3-D) or field A's circles (2-D)."""
    if len(shape) == 3:
        n = int(4000 * (shape[0] / 128) ** 2)
        clouds = [cs.sphere_inputs(s, device, shape, n) for s in range(B)]
    else:
        clouds = [cs.field_a_inputs(s, device, shape) for s in range(B)]
    pts, nrm = (cs.torch.stack([c[k] for c in clouds]) for k in (0, 1))
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(model_2=0.3), pts,
                             pts.new_zeros(pts.shape[:2]), gradients=nrm)


def crossover(cs, ft, device, emit, part="fused"):
    """``part`` "fused": the batched segment against lane by lane on its
    GRIDS; "cycle": the batched cycle against lane by lane on CYCLE_GRIDS."""
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch import solver
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    routes = {"batched": lambda p: solver.solve_lanes(p, cfg, fused=part == "fused"),
              "lanes": lambda p: tb._by_lane(solver.solve, p, cfg, None)}
    make = problems if part == "fused" else cycle_problems
    for shape in GRIDS if part == "fused" else CYCLE_GRIDS:
        first = None
        for B in LANES if part == "fused" else CYCLE_LANES:
            p = make(cs, ft, tb, shape, B, device)
            if part == "cycle":
                cs.require(tb.solve_route(p, cfg) in ("cycle", "lanes"),
                           f"{shape}: a fused-path grid in the cycle crossover")
            rec = dict(part="crossover" if part == "fused" else "crossover_cycle",
                       grid=list(shape), lanes=B)
            for name, run in routes.items():
                _, info = run(p)
                cs.require(bool(info.converged.all()), f"{name} {shape} B={B}: not converged")
                rec[f"{name}_iterations"] = int(info.iterations.sum())
                ms = [cs.host_ms(lambda: run(p))[1] for _ in range(REPS)]
                rec[f"{name}_ms"] = statistics.median(ms)
            rec["batched_over_lanes"] = rec["batched_ms"] / rec["lanes_ms"]
            if first is None and rec["batched_ms"] < rec["lanes_ms"]:
                first = B
            emit(rec)
            del p
            cs.torch.cuda.empty_cache()
        emit(dict(part=f"crossover_{part}_summary", grid=list(shape),
                  first_lanes_where_batched_wins=first))


def scaling(cs, ft, device, emit, points=SCALING):
    """The batched segment at equal work per lane (tol 0, a budget of
    BUDGET iterations) for each grid and lane count of ``points``."""
    import torch
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch.multigrid import build_fused_solver_operands
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    for shape, lanes in points.items():
        p = problems(cs, ft, tb, shape, max(lanes), device)
        coeffs, sids, Rs, inv32, lw, cfs = build_fused_solver_operands(p, cfg)
        one_lane_ms = None
        for B in lanes:
            b = p.b[:B].contiguous()
            args = (torch.zeros_like(b), b, torch.zeros(B, device=device),
                    torch.full((B,), BUDGET, dtype=torch.int32, device=device),
                    [c[:B] for c in coeffs], [s[:B] for s in sids], Rs, inv32[:B], lw,
                    cfg.mg_pre_smooth)
            _, iters, _ = fused_pcg_solve_batch(*args)
            cs.require(bool((iters == BUDGET).all()), f"scaling {shape} B={B}: {iters}")
            ms = cs.batch_ms(lambda: fused_pcg_solve_batch(*args), reps=5)
            rec = dict(part="scaling", grid=list(shape), lanes=B, iterations=BUDGET, ms=ms,
                       us_per_lane_iteration=1e3 * ms / (B * BUDGET),
                       ms_per_iteration=ms / BUDGET)
            if B == 1:
                one_lane_ms = ms
            rec["over_one_lane"] = ms / one_lane_ms
            emit(rec)
        del p, coeffs, sids, inv32
        torch.cuda.empty_cache()


def config3_segment(cs, ft, device):
    """Config 3's whole batch through the batched segment at tol 1e-4 from
    zero (chip_smoke.py phase 38's "config 3, every lane"): back-to-back
    ms and the iterations of every lane."""
    import torch
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch.multigrid import build_fused_solver_operands
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    cfg = ft.SolverConfig(tol=1e-4)
    pts, nrm = cs.config3_inputs(device)
    p = tb.assemble_batch(ft.Grid(cs.SHAPE3B), ft.Weights(model_2=0.3), pts,
                          torch.zeros(cs.B3, cs.N_POINTS3B, device=device), gradients=nrm)
    coeffs, sids, Rs, inv32, lw, cfs = build_fused_solver_operands(p, cfg)
    b = p.b
    tol2 = (1e-4 ** 2 * torch.sum(b * b, dim=(1, 2))).contiguous()
    budget = torch.full((cs.B3,), 2000, dtype=torch.int32, device=device)
    args = (torch.zeros_like(b), b, tol2, budget, coeffs, sids, Rs, inv32, lw, cfg.mg_pre_smooth)
    _, iters, _ = fused_pcg_solve_batch(*args)
    ms = cs.batch_ms(lambda: fused_pcg_solve_batch(*args), reps=5)
    return dict(ms=ms, iterations_sum=int(iters.sum()), iterations_max=int(iters.max()))


def _moved(v, device):
    """``v`` with every tensor in it (inside lists and tuples) on ``device``."""
    import torch
    if isinstance(v, torch.Tensor):
        return v.to(device)
    if isinstance(v, (list, tuple)):
        return type(v)(_moved(u, device) for u in v)
    return v


def cell_bits(device, path, replay):
    """The batched segment on BITS_CELL's operands. Without ``replay``: one
    batch of the cell through the tree's entry point (the benchmark's
    inputs, grid, weights and solver), each segment launch's operands and
    outputs (x, iters, rr) saved to ``path`` on the CPU (the card's assembly
    adds in no fixed order, so two processes' operands differ). With it:
    each saved launch again, on its operands, through this tree's segment,
    and whether every output is ``torch.equal`` to the saved one."""
    import torch
    from field_interpolation_tpu_torch import solver
    if replay:
        saved = torch.load(path, weights_only=False)  # written by this script
        equal = []
        for args, kw, outs in saved:
            got = solver.fused_pcg_solve_batch(*_moved(args, device), **_moved(kw, device))
            equal.append(all(torch.equal(g.cpu(), o) for g, o in zip(got, outs)))
        return dict(launches=len(equal), equal=equal)
    sys.path.insert(0, str(HERE))
    from benchmark.cells import Cell, load_benchmark, module
    from benchmark.traffic import make_pool
    cell = Cell(load_benchmark(HERE), BITS_CELL)
    program = module("adapters", cell.traffic["adapter"]).Program(cell)
    pts, nrm = make_pool(cell.config, dict(cell.traffic, pool_batches=1), BITS_SEED, device)[0]
    launches, real = [], solver.fused_pcg_solve_batch

    def spy(*args, **kw):
        out = real(*args, **kw)
        launches.append((_moved(args, "cpu"), _moved(kw, "cpu"), _moved(out, "cpu")))
        return out
    solver.fused_pcg_solve_batch = spy
    try:
        _, conv, iters = program(pts, nrm)
    finally:
        solver.fused_pcg_solve_batch = real
    torch.save(launches, path)
    return dict(launches=len(launches), iterations_sum=int(iters.sum()),
                converged=bool(conv.all()))


def measure(tree, lane=None, config3=True, bits=None, replay=False):
    """One tree's batched segment: the AB_SCALING points and config 3's
    batch, back to back (``lane``: the geometry, where the tree has one),
    and with ``bits`` `cell_bits`; returns the record."""
    sys.path.insert(0, str(tree))
    import torch
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops import _build, pcg
    cs = helpers()
    cs.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    cs.require(Path(ft.__file__).resolve().is_relative_to(tree),
               f"imported {ft.__file__}, not the package of {tree}")
    if lane:
        pcg.LANE_GEOMETRY = lane
    device = torch.device("cuda", 0)
    _, build_s, log = _build.build()
    _build.library()
    rec = dict(tree=str(tree), card=cs.card_line(), build_s=build_s,
               registers=cs.segment_ptxas(log), lane=getattr(pcg, "LANE_GEOMETRY", None))
    points = []
    scaling(cs, ft, device, points.append, AB_SCALING)
    for r in points:
        rec[f"{r['grid'][0]}_B{r['lanes']}"] = r["ms"]
    if config3:
        rec["config3"] = config3_segment(cs, ft, device)
    if bits:
        rec["bits"] = cell_bits(device, bits, replay)
    return rec


def split():
    """The SPLIT variants beside this tree at the --ab scaling points."""
    import shutil
    trees = {"this tree": HERE}
    for name, subs in SPLIT.items():
        tree = HERE / "build" / "batch_probe" / name
        shutil.rmtree(tree, ignore_errors=True)
        shutil.copytree(HERE / "field_interpolation_tpu_torch",
                        tree / "field_interpolation_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__"))
        src = tree / "field_interpolation_tpu_torch" / "csrc" / "lane2d.cuh"
        text = src.read_text()
        for old, new in subs:
            if text.count(old) != 1:
                raise SystemExit(f"batch_probe --split: {name}: {old!r} is not in the source once")
            text = text.replace(old, new)
        src.write_text(text)
        trees[name] = tree
    build = [subprocess.Popen([sys.executable, "-c", "from field_interpolation_tpu_torch.ops "
                               "import _build; _build.build()"], cwd=tree)
             for tree in trees.values()]
    if any(p.wait() for p in build):
        raise SystemExit("batch_probe --split: a build failed")
    runs = {name: [] for name in trees}
    for name in list(trees) + list(trees)[::-1]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree",
                               str(trees[name]), "--no-config3"], capture_output=True, text=True,
                              timeout=900)
        if proc.returncode:
            raise SystemExit(f"batch_probe --split: {name} exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
        rec = json.loads(proc.stdout.strip().splitlines()[-1])
        print(json.dumps(dict(rec, variant=name)), flush=True)
        runs[name].append(rec)
    print(f"card {runs['this tree'][0]['card']}; ms, median of {len(runs['this tree'])} runs, "
          f"every lane {BUDGET} iterations")
    for g, lanes in AB_SCALING.items():
        for B in lanes:
            key = f"{g[0]}_B{B}"
            print(f"{g[0]}², B = {B}: " + "  ".join(
                f"{name} {statistics.median(r[key] for r in recs):.4f}"
                for name, recs in runs.items()))


def ab(other):
    """Run ``other`` (A) and this tree (B) as A B B A B A A B; print each run and the table."""
    runs = []
    bits = HERE / "build" / "batch_probe" / "bits.pt"
    bits.parent.mkdir(parents=True, exist_ok=True)
    for i, side in enumerate(ORDER):
        tree = other if side == "A" else HERE
        first = (["--bits", str(bits)] + (["--replay"] if side == "B" else [])
                 if ORDER.index(side) == i else [])
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--tree",
                               str(tree)] + first, capture_output=True, text=True, timeout=900)
        sys.stderr.write(proc.stderr[-4000:])
        if proc.returncode:
            raise SystemExit(f"batch_probe FAILED: the run of {tree} exited "
                             f"{proc.returncode}:\n{proc.stdout[-4000:]}")
        rec = dict(json.loads(proc.stdout.strip().splitlines()[-1]), side=side)
        print(json.dumps(rec), flush=True)
        runs.append(rec)
    print(f"A = {other}, B = {HERE}; card {runs[0]['card']}")
    for side in "AB":
        regs = [r["registers"] for r in runs if r["side"] == side and r["registers"]]
        print(f"{side} ptxas [registers, spill stores, spill loads]: "
              f"{regs[0] if regs else 'not built in these runs'}")
    keys = [f"{g[0]}_B{B}" for g, lanes in AB_SCALING.items() for B in lanes] + ["config3"]
    for key in keys:
        med = {side: statistics.median(r[key]["ms"] if key == "config3" else r[key]
                                       for r in runs if r["side"] == side) for side in "AB"}
        label = ("config 3 batch, tol 1e-4 from zero" if key == "config3" else
                 f"{key.split('_')[0]}², B = {key.split('B')[1]}, {BUDGET} iterations a lane")
        print(f"{label}: A {med['A']:.4f} ms  B {med['B']:.4f} ms  B/A "
              f"{med['B'] / med['A']:.3f}")
    for side in "AB":
        its = {(r["config3"]["iterations_sum"], r["config3"]["iterations_max"])
               for r in runs if r["side"] == side}
        print(f"config 3 iterations (sum, max) {side}: {sorted(its)}")
    got = [r["bits"] for r in runs if "bits" in r]
    print(f"{BITS_CELL}, seed {BITS_SEED}: A's batch {got[0]}; B on A's segment operands, "
          f"x, iterations and ‖r‖² torch.equal per launch: {got[1]['equal']}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossover", nargs="?", const="both", choices=["both", "fused", "cycle"])
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--lane", help="the batched segment's threads a lane and lanes an SM, T,M")
    ap.add_argument("--ab", type=Path, help="the other tree (A), timed beside this one (B)")
    ap.add_argument("--tree", type=Path, help="the tree whose batched segment to time alone")
    ap.add_argument("--split", action="store_true", help="time the lane body's variants")
    ap.add_argument("--no-config3", action="store_true", help="--tree: the scaling points alone")
    ap.add_argument("--bits", help="--tree: also save the cell batch's segment operands and "
                    "outputs to this file")
    ap.add_argument("--replay", action="store_true",
                    help="--bits: launch the saved operands and compare with the saved outputs")
    ap.add_argument("--out", default=str(HERE / "build" / "batch_probe.json"))
    args = ap.parse_args()
    if args.ab:
        ab(args.ab.resolve())
        return 0
    if args.split:
        split()
        return 0
    lane = tuple(int(v) for v in args.lane.split(",")) if args.lane else None
    if args.tree:
        print(json.dumps(measure(args.tree.resolve(), lane, not args.no_config3, args.bits,
                                 args.replay)))
        return 0
    both = not (args.crossover or args.scaling)
    cs = helpers()
    import torch
    cs.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops import _build, pcg
    if lane:
        pcg.LANE_GEOMETRY = lane
    _build.library()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}; lane geometry {pcg.LANE_GEOMETRY}", flush=True)
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)
    for part in ("fused", "cycle"):
        if both or args.crossover in ("both", part):
            crossover(cs, ft, device, emit, part)
    if both or args.scaling:
        scaling(cs, ft, device, emit)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, records=out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
