#!/usr/bin/env python3
"""Where a batch of fused-path fields should go, and what bounds the batched segment, on one card.

    python3 batch_probe.py [--crossover] [--scaling] [--out FILE]

Run from the repository root on a machine with one CUDA card and nvcc; with
no flag both parts run.

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
`batch.solve_route`'s rule.

``--scaling``: the batched segment alone at 128² (config 3's operands)
and 256² with tol 0 and a budget of 8 iterations for every lane, so
every lane does the same work, for B from 1 to past one wave of resident
blocks; back to back (`chip_smoke.batch_ms`, 5 calls). A kernel bound by
HBM's rate takes time in proportion to B from the first lanes on; one
bound by each block's own latency takes the same time for every B up to
the lanes the card holds at once, then steps.

Prints the card and one JSON line per measurement, and writes all of them
to ``--out`` (default ``build/batch_probe.json``).
"""

import argparse
import importlib.util
import json
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
GRIDS = [(32, 32), (64, 64), (128, 128), (256, 256)]
LANES = [1, 2, 4, 8, 16, 32, 64]
REPS = 3
SCALING = {(128, 128): [1, 8, 66, 132, 264, 396, 528, 660, 792, 1024],
           (256, 256): [1, 3, 33, 132, 264, 396, 528]}
BUDGET = 8


def helpers():
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def problems(cs, ft, tb, shape, B, device):
    pts, nrm = cs.config3_inputs(device, B=B, shape=shape, n=2 * shape[0])
    return tb.assemble_batch(ft.Grid(shape), ft.Weights(model_2=0.3), pts,
                             pts.new_zeros(pts.shape[:2]), gradients=nrm)


def crossover(cs, ft, device, emit):
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch import solver
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    routes = {"batched": lambda p: solver.solve_lanes(p, cfg, fused=True),
              "lanes": lambda p: tb._by_lane(solver.solve, p, cfg, None)}
    for shape in GRIDS:
        first = None
        for B in LANES:
            p = problems(cs, ft, tb, shape, B, device)
            rec = dict(part="crossover", grid=list(shape), lanes=B)
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
        emit(dict(part="crossover_summary", grid=list(shape),
                  first_lanes_where_batched_wins=first))


def scaling(cs, ft, device, emit):
    import torch
    from field_interpolation_tpu_torch import batch as tb
    from field_interpolation_tpu_torch.multigrid import build_fused_solver_operands
    from field_interpolation_tpu_torch.ops.pcg import fused_pcg_solve_batch
    cfg = ft.SolverConfig(tol=1e-4, preconditioner="multigrid")
    for shape, lanes in SCALING.items():
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--crossover", action="store_true")
    ap.add_argument("--scaling", action="store_true")
    ap.add_argument("--out", default=str(HERE / "build" / "batch_probe.json"))
    args = ap.parse_args()
    both = not (args.crossover or args.scaling)
    cs = helpers()
    import torch
    cs.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    import field_interpolation_tpu_torch as ft
    from field_interpolation_tpu_torch.ops import _build
    _build.library()
    device = torch.device("cuda", 0)
    card = cs.card_line()
    print(f"card: {card}", flush=True)
    out = []

    def emit(rec):
        out.append(rec)
        print(json.dumps(rec), flush=True)
    if both or args.crossover:
        crossover(cs, ft, device, emit)
    if both or args.scaling:
        scaling(cs, ft, device, emit)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(dict(card=card, records=out), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
