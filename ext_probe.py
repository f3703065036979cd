#!/usr/bin/env python3
"""Trace a sharded rank, and time the sharded-apply (ext) kernels, of two trees on one card.

    python3 ext_probe.py --trace [--one-rank] [--tree DIR]  # torch.profiler traces of sharded ranks
    python3 ext_probe.py --kernels [--tree DIR]  # the ext kernels at S1's blocks
    python3 ext_probe.py --ab DIR                # DIR (A) and this tree (B) in turn; a table
    python3 ext_probe.py --report FILE           # the table of a saved --ab result

Run from the repository root on a machine with one CUDA card and nvcc. DIR
is another checkout of the repository, for example the parent commit
unpacked with ``git archive`` into a git-ignored directory. Each run is a
process of its own that imports its tree's package (and builds its tree's
``csrc``); the ranks of a trace are spawned from it. ``--out FILE`` writes
the records there as JSON too. The inputs are ``chip_smoke.py``'s (this
tree's).

``--trace``: ``torch.profiler`` over CG iterations of one rank of a sharded
solve (`parallel.sharded`: the distributed multigrid preconditioner, the
sharded apply), in three runs: S2 (config 5's 4096² problem, tol 1e-4,
multigrid) as rank 0 of a 2 x 2 mesh of four ranks sharing the card
(gloo, halos through host memory), S2 as one rank (mesh 1 x 1: no halo
messages) and S4 (192³, 56 250 sphere points) as one rank. Per CG iteration
(the difference of a window of 1 + K iterations and one of 1, each a
``solver.pcg`` call from zero with tol 0, over K): wall ms (unprofiled),
host ms in the halo exchange (``sharded._post``: its device→host copy and
host sync, then gloo's wait and the host→device copy), in the ext wrappers'
calls and in ``all_reduce`` (``sharded._all_sum``), the CUDA runtime's
copies and synchronizations, and device kernels by kind (ext kernels,
copies, every other kernel: the plain torch ops) with their launches.

``--kernels``: each ext form at the blocks S2 and S4 give it (S1 of
``chip_smoke.py``), single call (median of 20 after a warm-up), back to
back (20 calls) and device time (``torch.profiler``), against its bound;
one sweep and one residual on S2's and S4's sharded levels, and CG's apply
of their fine levels, as the sharded solve runs them (the parent's:
``torch.cat`` halos, the apply, plain updates; this tree's: one launch on
the block and its slabs), on a block of the 2 x 2 mesh and as one rank;
the wrappers' host µs per call; and the whole-grid apply kernel
(``csrc/normal_apply.cu``, which shares ``normal_apply.cuh``).

``--ab`` runs the kernels A B B A (and once each those of ``--extra``
trees, variants of this one), then the traces A B, writes the records to
``--out`` as they come, and prints per measurement the medians of each side
and their ratio.
"""

import argparse
import contextlib
import functools
import importlib.util
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
TRACE_ITERS = 3  # K: the iterations the two windows of a trace differ by
ORDER = "ABBA"
EXT_KERNEL = r"apply_ext|ext_level"  # the ext kernels' names, in either tree


@functools.cache
def helpers():
    """chip_smoke.py of this tree, for its inputs and timers."""
    spec = importlib.util.spec_from_file_location("_chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def import_tree(tree):
    """The package of ``tree``, imported ahead of any other on sys.path."""
    sys.path.insert(0, str(tree))
    import field_interpolation_tpu_torch as ft
    if not Path(ft.__file__).resolve().is_relative_to(tree):
        raise SystemExit(f"imported {ft.__file__}, not the package of {tree}")
    return ft


# ---- the trace -----------------------------------------------------------

def _ranged(fn, name):
    import torch

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)
    return wrapped


@contextlib.contextmanager
def instrumented():
    """Named host ranges around the sharded solve's halo exchange
    (``_post`` and the wait it returns), its ``all_reduce`` calls and the
    ext wrappers it calls (the parent's functions or this tree's level
    objects), restored on exit."""
    from field_interpolation_tpu_torch.ops import stencil_ext
    from field_interpolation_tpu_torch.parallel import sharded
    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, owner.__dict__[name]))
        setattr(owner, name, new)

    post = sharded._post

    def post_ranged(*args, **kwargs):
        import torch
        with torch.profiler.record_function("halo.post"):
            wait = post(*args, **kwargs)
        return _ranged(wait, "halo.wait")

    patch(sharded, "_post", post_ranged)
    patch(sharded, "_all_sum", _ranged(sharded._all_sum, "all_reduce"))
    for name in ("fused_normal_apply_ext", "fused_normal_apply_ext_striped"):
        if name in sharded.__dict__:
            patch(sharded, name, _ranged(sharded.__dict__[name], "ext.call"))
    level = getattr(stencil_ext, "ExtLevel", None)
    if level is not None:
        patch(level, "__call__", _ranged(level.__call__, "ext.call"))
    try:
        yield
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)


def summarize(prof):
    """Host ranges, runtime calls and device kernels of one profiled window."""
    import re

    from torch.autograd import DeviceType
    events = helpers().trace_events(prof)
    out = {}

    def add(key, ms, n=1):
        ms_key, n_key = f"{key}_ms", f"{key}_n"
        out[ms_key] = out.get(ms_key, 0.0) + ms
        out[n_key] = out.get(n_key, 0) + n

    for kind, name, t0, t1 in events:
        ms = (t1 - t0) / 1e3
        if kind == DeviceType.CPU:
            if name in ("halo.post", "halo.wait", "all_reduce", "ext.call"):
                add("host_" + name.replace(".", "_"), ms)
            elif re.match(r"cudaLaunch(Cooperative)?Kernel", name):
                add("host_launch", ms)
            elif name in ("cudaMemcpyAsync", "cudaStreamSynchronize", "cudaDeviceSynchronize",
                          "cudaHostAlloc", "cudaEventSynchronize"):
                add("host_" + name, ms)
        elif kind == DeviceType.CUDA:
            if re.search(r"Memcpy DtoH|Memcpy Device -> Host", name):
                add("dev_copy_dtoh", ms)
            elif re.search(r"Memcpy HtoD|Memcpy Host -> Device", name):
                add("dev_copy_htod", ms)
            elif re.search(r"Memcpy|Memset", name):
                add("dev_copy_other", ms)
            elif re.search(EXT_KERNEL, name):
                add("dev_ext", ms)
            else:
                add("dev_plain", ms)
    dev = [(e[2], e[3]) for e in events if e[0] == DeviceType.CUDA]
    out["dev_busy_ms"] = helpers().busy_ms(dev)
    return out


def trace_rank(cloud, mesh_shape, config, iters, *, device):
    """On every rank: build the sharded solve's operator and preconditioner
    as `solve_sharded` does, then run CG windows of 1 and 1 + ``iters``
    iterations from zero (tol 0), unprofiled and, on rank 0, under
    ``torch.profiler``. Returns rank 0's per-iteration differences."""
    import torch
    import torch.distributed as dist
    from torch.profiler import ProfilerActivity, profile

    from field_interpolation_tpu_torch.parallel import sharded
    from field_interpolation_tpu_torch.parallel.mesh import Mesh
    from field_interpolation_tpu_torch.solver import pcg
    mesh = Mesh(mesh_shape)
    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    t0 = time.perf_counter()
    p = sharded.shard_problem(cloud.problem(device), mesh)
    plan, ops = sharded._make_mg_plan(p, mesh, config)
    apply_fn = sharded.make_sharded_apply(p.grid.shape, p.weights, mesh, p.coeff,
                                          backend=config.backend)
    precond = sharded._make_local_precond(config, plan, ops, p.diag, apply_fn, mesh)
    sync()
    setup_s = time.perf_counter() - t0

    def window(k):
        dist.barrier()
        sync()
        t = time.perf_counter()
        _, info = pcg(apply_fn, p.b, None, precond, tol=0.0, maxiter=k,
                      recompute_every=config.recompute_every, max_restarts=1,
                      dot_fn=sharded._pdot)
        sync()
        return 1e3 * (time.perf_counter() - t), int(info.iterations)

    window(1)  # warm-up
    (ms1, it1), (ms2, it2) = window(1), window(1 + iters)
    rank0 = dist.get_rank() == 0
    prof_windows = []
    with instrumented():
        for k in (1, 1 + iters):
            if rank0:
                with profile(activities=activities) as prof:
                    window(k)
                prof_windows.append(summarize(prof))
            else:
                window(k)
    if not rank0:
        return {}
    a, b = prof_windows
    per_it = {k: (b.get(k, 0) - a.get(k, 0)) / iters for k in set(a) | set(b)}
    return dict(mesh=list(mesh_shape), shape=list(p.grid.shape),
                block=list(p.b.shape), iterations=[it1, it2], setup_s=setup_s,
                wall_ms_per_iteration=(ms2 - ms1) / (it2 - it1),
                level_routes=list(getattr(precond, "level_routes", ())),
                per_iteration=dict(sorted(per_it.items())))


def trace(tree, one_rank=False):
    import torch
    ft = import_tree(tree)
    from field_interpolation_tpu_torch.parallel.cases import Cloud
    from field_interpolation_tpu_torch.parallel.launch import run_ranks
    h = helpers()
    h.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    w = ft.Weights(model_2=0.3)
    cfg2 = ft.SolverConfig(**h.CFG5)
    cfg4 = ft.SolverConfig(tol=1e-4, preconditioner="multigrid", maxiter=500)
    pts5, nrm5 = (t.cpu().numpy() for t in h.circle5_inputs(0, torch.device("cpu")))
    c2 = Cloud(h.SHAPE5, w, pts5, None, nrm5)
    pts4, nrm4 = h.sphere5_inputs(h.SHAPE_S4, h.N_POINTS_S4)
    c4 = Cloud(h.SHAPE_S4, w, pts4, None, nrm4)
    rec = dict(tree=str(tree), card=h.card_line())
    runs = [("S2_rank0_of_2x2", c2, cfg2, h.MESH_S), ("S2_one_rank", c2, cfg2, (1, 1)),
            ("S4_one_rank", c4, cfg4, (1, 1))]
    for name, cloud, cfg, mesh in runs[1:] if one_rank else runs:
        t0 = time.perf_counter()
        rec[name] = run_ranks(trace_rank, math.prod(mesh), cloud, mesh, cfg, TRACE_ITERS,
                              device="cuda")[0]
        rec[name]["run_s"] = time.perf_counter() - t0
        print(f"{name}: {json.dumps(rec[name])}", file=sys.stderr, flush=True)
    return rec


# ---- the kernels ---------------------------------------------------------

def timing(fn, nbytes, flops=0.0, calls=20):
    """Single (median of 20 after a warm-up) and back-to-back (20 calls) ms
    from CUDA events, device ms per call from ``torch.profiler`` (every
    kernel and copy the call runs), the host µs of a call (enqueue, the card
    left to catch up) and the bound of its work."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    h = helpers()
    ms, b2b = h.cuda_ms(fn), h.batch_ms(fn)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    dev = [e for e in h.trace_events(prof) if e[0] == DeviceType.CUDA]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    host_us = 1e6 * (time.perf_counter() - t0) / calls
    torch.cuda.synchronize()
    return dict(ms=ms, b2b_ms=b2b, dev_ms=sum(e[3] - e[2] for e in dev) / 1e3 / calls,
                dev_kernels=len(dev) / calls, host_us=host_us, **h.bound(nbytes, flops))


def registers(log):
    """{ext kernel: {"regs", "stack", "spill"}} from the build's ptxas
    output (empty when the library was built before)."""
    import re
    out, name = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            name = line.split("'")[1] if "'" in line else line
        elif re.search(EXT_KERNEL, name):
            m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores", line)
            if m:
                out.setdefault(name, {}).update(stack=int(m[1]), spill=int(m[2]))
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out.setdefault(name, {})["regs"] = int(m[1])
    return out


def kernels(tree, device="cuda"):
    """The ext kernels of ``tree`` at the blocks S2 and S4 give them
    (``device="cpu"`` rehearses the probe on the plain versions)."""
    import os
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist
    ft = import_tree(tree)
    from field_interpolation_tpu_torch import multigrid as tmg
    from field_interpolation_tpu_torch.ops import _build
    from field_interpolation_tpu_torch.ops import stencil_ext as se
    from field_interpolation_tpu_torch.ops.stencil import fused_normal_apply
    from field_interpolation_tpu_torch.parallel import sharded
    from field_interpolation_tpu_torch.parallel.mesh import Mesh
    h = helpers()
    device = torch.device(device, 0 if device == "cuda" else None)
    build_s = None
    if device.type == "cuda":
        h.require(torch.cuda.is_available(), "torch.cuda.is_available() is False")
        torch.cuda.set_device(device)
        _, build_s, log = _build.build()
        _build.library()
    tmp = tempfile.mkdtemp()
    dist.init_process_group("gloo", init_method="file://" + os.path.join(tmp, "rendezvous"),
                            rank=0, world_size=1)
    one_rank = Mesh((1, 1))
    new = hasattr(se, "ExtLevel")
    rec = dict(tree=str(tree), card=h.card_line() if device.type == "cuda" else "cpu",
               build_s=build_s, new=new,
               ptxas=registers(log) if device.type == "cuda" else {})
    rng = np.random.default_rng(30)
    F = torch.nn.functional

    def randn(shape):
        return torch.as_tensor(rng.standard_normal(shape).astype(np.float32), device=device)

    def uniform(shape):
        return torch.as_tensor(rng.uniform(0.05, 0.5, shape).astype(np.float32), device=device)

    w, r = ft.Weights(model_2=0.3), 2
    cfg = ft.SolverConfig(**h.CFG5)
    tau = 0.7
    tau_t = torch.tensor(tau, device=device)

    def sweeps(key, shape, coeff, lw, rad, layout, striped=False):
        """One Jacobi sweep and one residual on block 0 of ``layout`` (its
        slabs given, as the exchange delivers them) and on the whole level
        as one rank (this tree's exchange on a 1 x 1 mesh): the parent's
        concatenations, apply and plain update, or this tree's one launch."""
        nd = len(shape)
        diag = coeff.ndim == nd
        order = (1, 0) if striped else tuple(range(nd))
        x = randn(shape)
        loc = tuple(n // s for n, s in zip(shape, layout))
        blk = tuple(slice(0, n) for n in loc)
        c = coeff[blk if diag else (slice(None),) + blk].contiguous()
        z, slabs = h.block_slabs(x, blk, rad, order, shape)
        rr, inv_d = randn(loc), uniform(loc)
        planes = 1 if diag else 3 ** nd
        n = math.prod(loc)
        z_bytes = 4 * (n + sum(t.numel() for pair in slabs for t in pair if t is not None))
        flops = h.apply_flops(lw, nd, diag) * n
        if new:
            level = se.ExtLevel(c, [0] * nd, lw, rad, shape, striped=striped)
            sweep = lambda: level(z, slabs, "jacobi", r=rr, inv_d=inv_d, s0=tau)  # noqa: E731
            res = lambda: level(z, slabs, "residual", r=rr)  # noqa: E731
        else:
            def az():
                parts = [(lo if lo is not None else z.new_zeros(shp),
                          hi if hi is not None else z.new_zeros(shp))
                         for (lo, hi), shp in zip(slabs, se_slab_shapes(loc, rad, order))]
                if striped:
                    x1 = torch.cat([parts[0][0], z, parts[0][1]], dim=1)
                    return se.fused_normal_apply_ext_striped(x1, *parts[1], c, [0, 0], lw,
                                                             rad, shape)
                xe = z
                for (lo, hi), axis in zip(parts, order):
                    xe = torch.cat([lo, xe, hi], dim=axis)
                return se.fused_normal_apply_ext(xe, c, [0] * nd, lw, nd, rad, shape)
            sweep = lambda: z + tau_t * inv_d * (rr - az())  # noqa: E731
            res = lambda: rr - az()  # noqa: E731
        rec[f"{key}_sweep"] = timing(sweep, z_bytes + 4 * n * (planes + 3), flops)
        rec[f"{key}_residual"] = timing(res, z_bytes + 4 * n * (planes + 2), flops)
        if not diag:  # CG's apply of the fine level
            rec[f"{key}_apply"] = timing(lambda: level(z, slabs) if new else az(),
                                         z_bytes + 4 * n * (planes + 1), flops)
        if striped:
            return
        # The whole level as one rank: no neighbours, the exchange's own code.
        xw, rw, dw = x, randn(shape), uniform(shape)
        if new:
            lw1 = se.ExtLevel(coeff.contiguous(), [0] * nd, lw, rad, shape)
            one = lambda: lw1(xw, sharded._level_slabs(xw, rad, one_rank, lw1.order),  # noqa: E731
                              "jacobi", r=rw, inv_d=dw, s0=tau)
        else:
            one = lambda: xw + tau_t * dw * (rw - se.fused_normal_apply_ext(  # noqa: E731
                sharded._extend(xw, rad, one_rank), coeff, [0] * nd, lw, nd, rad, shape))
        N = math.prod(shape)
        rec[f"{key}_one_rank_sweep"] = timing(one, 4 * N * (planes + 4), h.apply_flops(
            lw, nd, diag) * N)

    def se_slab_shapes(loc, rad, order):
        out = []
        for k, axis in enumerate(order):
            shp = list(loc)
            for before in order[:k]:
                shp[before] += 2 * rad
            shp[axis] = rad
            out.append(tuple(shp))
        return out

    # S2: config 5's 4096² field; the whole-grid apply (normal_apply.cu),
    # the striped blocks in the reference's operand form, the fine level's
    # sweeps on 2 x 2 blocks, every sharded level's diagonal form.
    p5 = ft.assemble_sdf(ft.Grid(h.SHAPE5), w, *h.circle5_inputs(0, device))
    x = randn(h.SHAPE5)
    N5 = math.prod(h.SHAPE5)
    rec["apply_4096"] = timing(lambda: fused_normal_apply(x, p5.coeff, w, 2),
                               4 * 11 * N5, h.apply_flops(w, 2, False) * N5)
    xp = F.pad(x, (r,) * 4)
    for layout, key in (((2, 2), "striped_2048"), ((1, 8), "striped_4096x512")):
        loc = tuple(n // s for n, s in zip(h.SHAPE5, layout))
        blk = tuple(slice(0, n) for n in loc)
        args = (xp[r:loc[0] + r, :loc[1] + 2 * r].contiguous(), xp[:r, :loc[1] + 2 * r].contiguous(),
                xp[loc[0]:loc[0] + r, :loc[1] + 2 * r].contiguous(),
                p5.coeff[(slice(None),) + blk].contiguous(), [0, 0], w, r, h.SHAPE5)
        n = math.prod(loc)
        rec[key] = timing(lambda args=args: se.fused_normal_apply_ext_striped(*args),
                          4 * ((loc[0] + 2 * r) * (loc[1] + 2 * r) + 10 * n),
                          h.apply_flops(w, 2, False) * n)
    sweeps("S2_fine_2048_striped", h.SHAPE5, p5.coeff, w, r, h.MESH_S, striped=True)
    levels = tmg.build_levels(p5, cfg)
    radii = tuple(max([k for k in l.weights.active_orders() if k > 0], default=0)
                  for l in levels)
    n_sh, _ = sharded._sharded_prefix((h.SHAPE5,) + tuple(l.shape for l in levels),
                                      h.MESH_S, radii)
    for lv, rad in zip(levels[:n_sh], radii):
        key = f"diag_{lv.shape[0] // 2}"
        loc = tuple(m // 2 for m in lv.shape)
        xl = F.pad(randn(lv.shape), (rad,) * 4)
        ext = xl[:loc[0] + 2 * rad, :loc[1] + 2 * rad].contiguous()
        dd = lv.data_diag[:loc[0], :loc[1]].contiguous()
        n = math.prod(loc)
        rec[key] = timing(lambda ext=ext, dd=dd, lv=lv, rad=rad: se.fused_normal_apply_ext(
            ext, dd, [0, 0], lv.weights, 2, rad, lv.shape), 4 * (ext.numel() + 2 * n),
            h.apply_flops(lv.weights, 2, True) * n)
        sweeps(f"S2_level_{lv.shape[0]}", lv.shape, lv.data_diag, lv.weights, rad, h.MESH_S)
    del p5, x, xp, levels
    
    # S4: 192³, 56 250 sphere points; the whole-grid apply at 128³ beside.
    pts, nrm = h.sphere5_inputs(h.SHAPE_S4, h.N_POINTS_S4)
    p3 = ft.assemble_sdf(ft.Grid(h.SHAPE_S4), w, torch.as_tensor(pts, device=device),
                         torch.as_tensor(nrm, device=device))
    layout3 = h.MESH_S + (1,)
    loc3 = tuple(n // s for n, s in zip(h.SHAPE_S4, layout3))
    n3 = math.prod(loc3)
    x3p = F.pad(randn(h.SHAPE_S4), (r,) * 6)
    ext3 = x3p[:loc3[0] + 2 * r, :loc3[1] + 2 * r, :].contiguous()
    c3 = p3.coeff[:, :loc3[0], :loc3[1]].contiguous()
    rec["whole_96x96x192"] = timing(lambda: se.fused_normal_apply_ext(
        ext3, c3, [0, 0, 0], w, 3, r, h.SHAPE_S4), 4 * (ext3.numel() + 28 * n3),
        h.apply_flops(w, 3, False) * n3)
    sweeps("S4_fine_27", h.SHAPE_S4, p3.coeff, w, r, layout3)
    from field_interpolation_tpu_torch import constraints as cons
    dd3 = cons.data_diag(p3.coeff, 3).contiguous()
    rec["diag_lumped_96x96x192"] = timing(lambda: se.fused_normal_apply_ext(
        ext3, dd3[:loc3[0], :loc3[1]].contiguous(), [0, 0, 0], w, 3, r, h.SHAPE_S4),
        4 * (ext3.numel() + 2 * n3), h.apply_flops(w, 3, True) * n3)
    sweeps("S4_fine_lumped", h.SHAPE_S4, dd3, w, r, layout3)
    levels3 = tmg.build_levels(p3, ft.SolverConfig(tol=1e-4, preconditioner="multigrid"))
    radii3 = tuple(max([k for k in l.weights.active_orders() if k > 0], default=0)
                   for l in levels3)
    n_sh3, _ = sharded._sharded_prefix((h.SHAPE_S4,) + tuple(l.shape for l in levels3),
                                       layout3, radii3)
    for lv, rad in zip(levels3[:n_sh3], radii3):
        key = f"S4_level_{'x'.join(map(str, lv.shape))}"
        sweeps(key, lv.shape, lv.data_diag, lv.weights, rad, layout3)
    del p3, x3p, ext3, c3, dd3, levels3
    shape = h.SHAPE3  # config 4's 128³
    x128 = randn(shape)
    p128 = ft.assemble_sdf(ft.Grid(shape), w, *(torch.as_tensor(a, device=device) for a in
                                               h.sphere5_inputs(shape, h.N_POINTS3)))
    N = math.prod(shape)
    rec["apply_128cubed"] = timing(lambda: fused_normal_apply(x128, p128.coeff, w, 3),
                                   4 * 29 * N, h.apply_flops(w, 3, False) * N)
    dist.destroy_process_group()
    return rec


def ab(other, extra=(), out=None, traces=True):
    """A (``other``) and B (this tree): the kernels A B B A, then once each
    the kernels of the ``extra`` trees (variants of B), then the traces A B;
    the records (written to ``out`` as they come), then the table."""
    result = dict(runs=[], extra={}, traces={})

    def save():
        if out:
            out.parent.mkdir(parents=True, exist_ok=True)
            out.write_text(json.dumps(result, indent=1))

    for side in ORDER:
        rec = dict(run_tree(other if side == "A" else HERE, "kernels"), side=side)
        print(f"kernels run {side}: {rec['tree']}", flush=True)
        result["runs"].append(rec)
        save()
    for tree in extra:
        result["extra"][str(tree)] = run_tree(tree, "kernels")
        save()
    for side in "AB" if traces else "":
        result["traces"][side] = run_tree(other if side == "A" else HERE, "trace")
        save()
    result["table"] = report(result)
    save()
    return result


def report(result):
    """Print the table of an ``--ab`` result: per measurement each side's
    median and B/A, the bound's share of each side's back-to-back time, the
    extra trees' times; per trace the per-iteration numbers of A and B.
    Returns the table."""
    runs, traces = result["runs"], result["traces"]
    print(f"A = {runs[0]['tree'] if runs[0]['side'] == 'A' else runs[1]['tree']}, "
          f"B = {HERE}; card {runs[0]['card']}")
    table = {}
    for key in [k for k, v in runs[0].items() if isinstance(v, dict) and "b2b_ms" in v]:
        row = {sub: tuple(statistics.median(r[key][sub] for r in runs if r["side"] == side)
                          for side in "AB")
               for sub in ("ms", "b2b_ms", "dev_ms", "host_us", "dev_kernels")}
        bound = runs[0][key]["bound_ms"]
        table[key] = dict(row, bound_ms=bound)
        ext = "".join(f"; {Path(t).name} b2b {rec[key]['b2b_ms']:.4f} dev {rec[key]['dev_ms']:.4f}"
                      for t, rec in result["extra"].items() if key in rec)
        print(f"{key}: " + "; ".join(f"{sub} A {a:.4f} B {b:.4f} B/A {b / a:.3f}"
                                     for sub, (a, b) in row.items())
              + f"; bound {bound:.4f} ms, of b2b A {bound / row['b2b_ms'][0]:.2f} B "
                f"{bound / row['b2b_ms'][1]:.2f}" + ext)
    for name, ta in traces.get("A", {}).items():
        if not isinstance(ta, dict) or name not in traces.get("B", {}):
            continue
        tb = traces["B"][name]
        print(f"trace {name}: wall ms per CG iteration A {ta['wall_ms_per_iteration']:.1f} B "
              f"{tb['wall_ms_per_iteration']:.1f}")
        for k in sorted(set(ta["per_iteration"]) | set(tb["per_iteration"])):
            print(f"  {k}: A {ta['per_iteration'].get(k, 0):.3f} B "
                  f"{tb['per_iteration'].get(k, 0):.3f}")
    return table


# ---- command line ----------------------------------------------------------

def run_tree(tree, what):
    """One measurement of ``tree`` in a process of its own; its record."""
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), f"--{what}",
                           "--tree", str(tree)], capture_output=True, text=True, timeout=1500)
    sys.stderr.write(proc.stderr[-6000:])
    if proc.returncode:
        raise SystemExit(f"ext_probe FAILED: --{what} of {tree} exited {proc.returncode}:\n"
                         f"{proc.stdout[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=HERE, help="the tree to measure alone")
    ap.add_argument("--trace", action="store_true", help="trace sharded ranks")
    ap.add_argument("--one-rank", action="store_true",
                    help="with --trace: only the runs as one rank")
    ap.add_argument("--kernels", action="store_true", help="time the ext kernels")
    ap.add_argument("--ab", type=Path, help="the other tree (A), measured beside this one (B)")
    ap.add_argument("--extra", type=Path, nargs="*", default=(),
                    help="with --ab: variant trees whose kernels are measured once each")
    ap.add_argument("--no-trace", action="store_true", help="with --ab: the kernels only")
    ap.add_argument("--out", type=Path, help="also write the records here as JSON")
    ap.add_argument("--report", type=Path, help="print the table of a saved --ab result")
    opts = ap.parse_args()
    if opts.report:
        report(json.loads(opts.report.read_text()))
        return
    if opts.ab:
        out = ab(opts.ab.resolve(), [t.resolve() for t in opts.extra], opts.out,
                 not opts.no_trace)
    elif opts.trace:
        out = trace(opts.tree.resolve(), opts.one_rank)
    elif opts.kernels:
        out = kernels(opts.tree.resolve())
    else:
        ap.error("give --trace, --kernels or --ab DIR")
    if opts.out and not opts.ab:
        opts.out.parent.mkdir(parents=True, exist_ok=True)
        opts.out.write_text(json.dumps(out, indent=1))
    if not opts.ab:
        print(json.dumps(out))


if __name__ == "__main__":
    main()
