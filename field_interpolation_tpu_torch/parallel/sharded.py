"""Spatially sharded solves: one large grid block-decomposed over ranks.

Counterpart of ``field_interpolation_tpu.parallel.sharded``, over
``torch.distributed`` with one process per shard (`parallel.launch`):

* Grid dim d is sharded over mesh axis d; each rank holds one contiguous
  block of the lattice and the same block of ``coeff``, ``b`` and ``diag``
  (`shard_problem`). The grid stays global.
* The whole PCG loop runs on every rank. Per iteration:
  - halo exchange: slabs as wide as the operator radius go to the
    neighbours, one axis at a time, so corner halos fill transitively; edge
    ranks receive zeros, the zero padding the unsharded operator uses
    (`lax.ppermute`'s semantics). Under gloo a slab on a card goes through
    host memory; under nccl it stays on the device;
  - the operator on the block and its halo slabs with the smoothness
    windows masked in GLOBAL coordinates, so the dropped-row boundary
    appears at the global edge only: the ext kernel of
    ``ops/stencil_ext.py`` (`ExtLevel`, the slabs read in place), or plain
    torch on the concatenated block under ``backend="xla"``;
  - the CG inner products summed over ranks (``all_reduce``), the only
    global syncs per iteration.
* ``preconditioner="multigrid"`` is the reference's distributed multigrid:
  the unsharded solver's hierarchy, its large levels block-sharded (halo
  exchanged smoothing through the ext kernel's diagonal form, each sweep and
  each residual one launch; banded transfers over neighbour halos), levels
  of at most `_REPLICATE_NODES`
  nodes gathered onto every rank, the dense coarsest inverse replicated.

Each rank's solve returns its own block of the field; `SolveInfo` is the
same on every rank.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .. import constraints as cons
from .. import stencils
from ..grid import Grid
from ..multigrid import (_coarse_dense_inverse, _resize_matrix, _rho_bound,
                         apply_bands, build_levels, chebyshev_coefs, fine_lumped,
                         level_rhos, make_restrict, prolong, resolve_wdepth)
from ..operators import Problem
from ..ops import _policy
from ..ops.stencil_ext import (ExtLevel, fused_normal_apply_ext_plain, level_update,
                               smoothness_ext)
from ..solver import SolveInfo, pcg
from ..weights import SolverConfig
from .mesh import Mesh

# Levels with at most this many nodes are gathered onto every rank and
# smoothed / solved there redundantly (sharded.py:46-50 of the reference).
_REPLICATE_NODES = 4096


# ---- blocks ---------------------------------------------------------------

def _check_divisible(grid_shape, mesh: Mesh) -> None:
    for d, (n, s, name) in enumerate(zip(grid_shape, mesh.shape, mesh.axis_names)):
        if n % s:
            raise ValueError(f"grid dim {d} ({n}) not divisible by mesh axis "
                             f"{name!r} ({s})")


def _block(shape, mesh: Mesh) -> tuple[slice, ...]:
    """This rank's block of a grid-shaped array of ``shape``."""
    shards = mesh.shards(len(shape))
    coords = mesh.coords() + (0,) * (len(shape) - len(mesh.shape))
    loc = [n // s for n, s in zip(shape, shards)]
    return tuple(slice(c * n, (c + 1) * n) for c, n in zip(coords, loc))


def shard_problem(problem: Problem, mesh: Mesh) -> Problem:
    """This rank's contiguous blocks of the problem's ``coeff``, ``b`` and
    ``diag``; the grid and weights stay global."""
    _check_divisible(problem.grid.shape, mesh)
    blk = _block(problem.grid.shape, mesh)
    return Problem(coeff=problem.coeff[(slice(None),) + blk].contiguous(),
                   b=problem.b[blk].contiguous(), diag=problem.diag[blk].contiguous(),
                   grid=problem.grid, weights=problem.weights)


def _local(problem: Problem, mesh: Mesh) -> Problem:
    """The problem's local blocks: shards a whole-grid problem, passes an
    already sharded one through."""
    _check_divisible(problem.grid.shape, mesh)
    if tuple(problem.b.shape) == problem.grid.shape:
        return shard_problem(problem, mesh)
    loc = tuple(sl.stop - sl.start for sl in _block(problem.grid.shape, mesh))
    if tuple(problem.b.shape) != loc:
        raise ValueError(f"problem blocks {tuple(problem.b.shape)} are neither the grid "
                         f"{problem.grid.shape} nor this rank's block {loc}")
    return problem


def _local_field(x: Optional[torch.Tensor], like: torch.Tensor, grid_shape, mesh: Mesh):
    """x0 as this rank's block: zeros, a whole-grid field cut, or a block."""
    if x is None:
        return torch.zeros_like(like)
    if tuple(x.shape) == tuple(grid_shape):
        return x[_block(grid_shape, mesh)].contiguous()
    return x


# ---- communication --------------------------------------------------------

def _post(msgs, zeros: bool = True):
    """Start point-to-point messages at once. ``msgs``: (tensor, dst, src)
    per message, all of one dtype on one device; the tensor goes to rank
    ``dst`` and one of its shape comes from rank ``src`` (None: nothing sent
    / zeros received, or None unless ``zeros``). Returns a function that
    waits and gives the received tensors. Under gloo, tensors on a card
    travel through host memory,
    packed: one device→host copy for all the sends (the one host sync of a
    round) and one pinned host→device copy for all the receives."""
    like = msgs[0][0]
    staged = like.device.type == "cuda" and dist.get_backend() != "nccl"
    sends = [t for t, dst, _ in msgs if dst is not None]
    recv_shapes = [t.shape for t, _, src in msgs if src is not None]
    if staged:
        host = torch.cat([t.reshape(-1) for t in sends]).cpu() if sends else None
        send_bufs = iter(host.split([t.numel() for t in sends]) if sends else ())
        n_recv = [math.prod(sh) for sh in recv_shapes]
        recv_host = torch.empty(sum(n_recv), dtype=like.dtype, pin_memory=True)
        recv_bufs = iter(recv_host.split(n_recv))
    else:
        send_bufs = iter([t.contiguous() for t in sends])
        recv_bufs = iter([torch.empty(sh, dtype=like.dtype, device=like.device)
                          for sh in recv_shapes])
    ops, recvs = [], []
    for tag, (t, dst, src) in enumerate(msgs):
        if dst is not None:
            ops.append(dist.P2POp(dist.isend, next(send_bufs), dst, tag=tag))
        if src is not None:
            rb = next(recv_bufs)
            ops.append(dist.P2POp(dist.irecv, rb, src, tag=tag))
            recvs.append(rb)
        else:
            recvs.append(None)
    works = dist.batch_isend_irecv(ops) if ops else []

    def wait():
        for w in works:
            w.wait()
        got = iter(recv_host.to(like.device, non_blocking=True).split(n_recv)
                   if staged else [rb for rb in recvs if rb is not None])
        return [(torch.zeros(t.shape, dtype=t.dtype, device=t.device) if zeros else None)
                if rb is None else next(got).view(t.shape) for (t, _, _), rb in zip(msgs, recvs)]
    return wait


def _halo_msgs(x: torch.Tensor, axis: int, h: int, mesh: Mesh):
    """The messages of one axis' exchange, giving (from_left, from_right):
    my last h along ``axis`` to the right neighbour, my first h to the left
    one."""
    n = x.shape[axis]
    right, left = mesh.neighbour(axis, 1), mesh.neighbour(axis, -1)
    return [(x.narrow(axis, n - h, h), right, left), (x.narrow(axis, 0, h), left, right)]


def _halo_slabs(x: torch.Tensor, axis: int, h: int, mesh: Mesh):
    """(from_left, from_right) neighbour slabs of width h along ``axis``
    (zeros at the global edges, the unsharded zero-pad)."""
    return tuple(_post(_halo_msgs(x, axis, h, mesh))())


def _halo_exchange(x: torch.Tensor, axis: int, h: int, mesh: Mesh) -> torch.Tensor:
    """The block extended by h on both sides of ``axis`` with neighbour data."""
    if h == 0:
        return x
    from_left, from_right = _halo_slabs(x, axis, h, mesh)
    return torch.cat([from_left, x, from_right], dim=axis)


def _extend(x: torch.Tensor, h: int, mesh: Mesh) -> torch.Tensor:
    """Extended by h along every axis, one axis after the other (corner
    halos fill transitively)."""
    for d in range(x.ndim):
        x = _halo_exchange(x, d, h, mesh)
    return x


def _level_slabs(x: torch.Tensor, h: int, mesh: Mesh, order) -> list:
    """The halo slabs an `ExtLevel` reads, one (from_left, from_right) pair
    per axis of ``order``: `_extend`'s exchange (the same slabs, the corners
    filled by the later axes) without concatenating the block. Only the
    pieces of a slab that is sent are concatenated; a slab is None where it
    would be zeros (a global edge), and an axis that is not sharded sends
    and receives nothing."""
    slabs = []
    for axis in order:
        right, left = mesh.neighbour(axis, 1), mesh.neighbour(axis, -1)
        if right is None and left is None:
            slabs.append((None, None))
            continue

        def edge(start, axis=axis):
            # The block extended along the axes before ``axis``, narrowed to h
            # nodes along it from ``start``.
            piece = x.narrow(axis, start, h)
            for (lo, hi), before in zip(slabs, order):
                shape = list(piece.shape)
                shape[before] = h
                lo, hi = (piece.new_zeros(shape) if t is None else t.narrow(axis, start, h)
                          for t in (lo, hi))
                piece = torch.cat([lo, piece, hi], dim=before)
            return piece

        to_right = edge(x.shape[axis] - h) if right is not None else None
        to_left = edge(0) if left is not None else None
        like = to_right if to_right is not None else to_left  # both of one shape
        slabs.append(tuple(_post([(like if to_right is None else to_right, right, left),
                                  (like if to_left is None else to_left, left, right)],
                                 zeros=False)()))
    return slabs


def _all_sum(t: torch.Tensor) -> torch.Tensor:
    """``t`` summed over the ranks, in place (callers pass a fresh tensor)."""
    dist.all_reduce(t)
    return t


def _pdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _all_sum(torch.sum(a * b))


def _gather(x_l: torch.Tensor, shape, mesh: Mesh) -> torch.Tensor:
    """The whole grid-shaped array on every rank, from each rank's block (a
    sum of zero-padded blocks: exact)."""
    full = torch.zeros(shape, dtype=x_l.dtype, device=x_l.device)
    full[_block(shape, mesh)] = x_l
    return _all_sum(full)


# ---- the sharded operator -------------------------------------------------

def _global_start(loc_shape, mesh: Mesh) -> tuple[int, ...]:
    """Global coordinate of the first node of this rank's block."""
    coords = mesh.coords() + (0,) * (len(loc_shape) - len(mesh.shape))
    return tuple(c * n for c, n in zip(coords, loc_shape))


def apply_route(grid_shape, weights, mesh: Mesh,
                backend: str = "xla") -> tuple[str, int | None]:
    """(route, stripe) of the float32 sharded apply. Off ``backend="xla"``:
    the striped kernel where the reference's `pick_stripe_ext` finds a
    stripe (2-D blocks past `ext_fits_vmem`), the whole-form ext kernel
    everywhere else, at every size. Under "xla" (and for float64 operands):
    the sequential plain apply."""
    nd = len(grid_shape)
    radius = max(stencils.max_stencil_radius(weights), 1)
    local = tuple(n // s for n, s in zip(grid_shape, mesh.shards(nd)))
    if backend != "xla":
        if nd == 2 and not _policy.ext_fits_vmem(local, radius):
            stripe = _policy.pick_stripe_ext(local, radius)
            if stripe is not None:
                return "ext_striped", stripe
        return "ext", None
    return "sequential", None


def make_sharded_apply(grid_shape, weights, mesh: Mesh, coeff: torch.Tensor,
                       backend: str = "xla", overlap: bool = True):
    """The local-block operator apply with halo exchange; ``coeff`` is this
    rank's data-term block. The route is `apply_route`'s; the returned
    function carries it as ``.route`` (and ``.stripe``), and as ``.level``
    the `ExtLevel` its float32 applies launch (None on the sequential
    route), whose other modes the distributed cycle's fine sweeps use.
    ``overlap`` is the reference's argument and changes nothing here: the
    reference's overlapped 2-D body gives the sequential route's bits and
    took 1.7-1.8x its host time on one H100 under gloo (PERF.md), so the
    plain apply keeps the one sequential route."""
    grid_shape = tuple(grid_shape)
    nd = len(grid_shape)
    radius = max(stencils.max_stencil_radius(weights), 1)
    route, stripe = apply_route(grid_shape, weights, mesh, backend)
    level = None
    if route != "sequential":
        c32 = coeff.to(torch.float32).contiguous()
        level = ExtLevel(c32, _global_start(c32.shape[1:], mesh), weights, radius, grid_shape,
                         striped=route == "ext_striped")

    def apply_fn(x_loc: torch.Tensor) -> torch.Tensor:
        if level is not None and x_loc.dtype == torch.float32:
            return level(x_loc, _level_slabs(x_loc, radius, mesh, level.order))
        return fused_normal_apply_ext_plain(_extend(x_loc, radius, mesh), coeff,
                                            _global_start(x_loc.shape, mesh), weights, nd,
                                            radius, grid_shape)

    apply_fn.route, apply_fn.stripe, apply_fn.level = route, stripe, level
    return apply_fn


# ---- the distributed multigrid --------------------------------------------

def _transfer_band_halos(n_f: int, n_c: int, n_shards: int) -> tuple[int, int]:
    """(hR, hP): how far any rank's restriction band reaches into neighbour
    FINE blocks / its prolongation band into neighbour COARSE blocks, from
    the resize matrix's actual support (multigrid._resize_matrix)."""
    Pm = _resize_matrix(n_f, n_c)   # [n_f, n_c] prolongation
    bf, bc = n_f // n_shards, n_c // n_shards
    hR = hP = 0
    for k in range(n_shards):
        sup = np.nonzero(np.abs(Pm[:, k * bc:(k + 1) * bc]).sum(axis=1))[0]
        hR = max(hR, k * bf - sup.min(), sup.max() + 1 - (k + 1) * bf)
        supP = np.nonzero(np.abs(Pm[k * bf:(k + 1) * bf]).sum(axis=0))[0]
        hP = max(hP, k * bc - supP.min(), supP.max() + 1 - (k + 1) * bc)
    return max(0, int(hR)), max(0, int(hP))


def _band(M: np.ndarray, device) -> tuple[torch.Tensor, torch.Tensor]:
    """`apply_bands` operands (rows [W·n_out] int64, w [W, n_out] float32)
    of a matrix whose nonzeros in each row are contiguous."""
    n_out, n_in = M.shape
    nz = M != 0
    has = nz.any(axis=1)
    first = np.where(has, np.argmax(nz, axis=1), 0)
    last = np.where(has, n_in - 1 - np.argmax(nz[:, ::-1], axis=1), 0)
    W = max(int((last - first).max()) + 1, 1)
    start = np.minimum(first, n_in - W)
    cols = start[None, :] + np.arange(W)[:, None]               # [W, n_out]
    w = M[np.arange(n_out)[None, :], cols]
    return (torch.tensor(cols.reshape(-1), dtype=torch.int64, device=device),
            torch.tensor(w, dtype=torch.float32, device=device))


@dataclasses.dataclass(frozen=True)
class _MGPlan:
    """Static metadata of the distributed-multigrid hierarchy."""

    shapes: tuple            # (K+1) level shapes, [0] = fine grid
    fweights: object         # fine-level Weights (for lumped smoothing)
    lweights: tuple          # (K) energy-rescaled Weights per coarse level
    radii: tuple             # (K) smoothing halo radius per coarse level
    n_sh: int                # levels[0..n_sh-1] sharded; the rest replicated
    lump: bool               # fine smoothing operator diagonally lumped
    has_dense: bool          # dense coarsest inverse available
    # per transition t (shapes[t] -> shapes[t+1]): ("ss"|"boundary"|"rr",
    #   changing-axes tuple, per-changing-axis (hR, hP) tuple)
    trans: tuple
    cheb_nus: tuple = ()     # Chebyshev sweep counts with schedules (empty = Jacobi)


def _sharded_prefix(shapes, shards, radii):
    """(n_sh, trans): how many coarse levels stay sharded and the kind of
    each transition. A level stays sharded while it has more than
    `_REPLICATE_NODES` nodes, divides the mesh, and every halo (smoothing
    and transfer bands) fits one neighbour hop (sharded.py:445-472)."""
    nd = len(shapes[0])
    n_sh = 0
    trans = []
    for li in range(len(shapes) - 1):
        S_f, S_c = shapes[li], shapes[li + 1]
        changing = tuple(d for d in range(nd) if S_f[d] != S_c[d])
        ok = (li == n_sh and math.prod(S_c) > _REPLICATE_NODES
              and all(S_c[d] % shards[d] == 0 for d in range(nd)))
        halos = []
        if ok:
            halos = [_transfer_band_halos(S_f[d], S_c[d], shards[d]) for d in changing]
            blocks_f = [S_f[d] // shards[d] for d in range(nd)]
            blocks_c = [S_c[d] // shards[d] for d in range(nd)]
            ok = all(blocks_c[d] >= radii[li] for d in range(nd))
            for (hR, hP), d in zip(halos, changing):
                ok = ok and blocks_f[d] >= hR and blocks_c[d] >= hP
        if ok:
            n_sh = li + 1
            trans.append(("ss", changing, tuple(halos)))
        elif li == n_sh:
            trans.append(("boundary", changing, ()))
        else:
            trans.append(("rr", changing, ()))
    return n_sh, tuple(trans)


def _make_mg_plan(problem: Problem, mesh: Mesh, config: SolverConfig):
    """Distributed geometric multigrid setup: the unsharded solver's
    hierarchy (the same `build_levels` shapes, rescaled weights, lumped
    coarse data, taus and dense coarsest inverse), with each large level
    block-sharded and the small ones replicated. ``problem`` holds this
    rank's blocks; the fine data diagonal is gathered once so every rank
    builds the whole hierarchy. The hierarchy is always lumped, as the
    reference's (sharded.py:412-419): a distributed Galerkin stencil is not
    implemented there either.

    Returns (plan, ops): ops = (taus, fine data diagonal block, per-level
    data diagonals, per-level D⁻¹ (blocks on sharded levels, whole on
    replicated ones), restriction and prolongation bands per transition,
    dense coarsest inverse, Chebyshev schedules)."""
    grid = problem.grid
    nd = grid.ndim
    shards = mesh.shards(nd)
    dev, dtype = problem.diag.device, problem.diag.dtype
    if config.mg_coarse_data != "lumped":
        config = dataclasses.replace(config, mg_coarse_data="lumped")
    fine_dd_l = cons.data_diag(problem.coeff, nd)
    levels = build_levels(problem, config, ddiag=_gather(fine_dd_l, grid.shape, mesh))
    K = len(levels)
    shapes = (grid.shape,) + tuple(l.shape for l in levels)

    # The fine level's Gershgorin bound: the max over this rank's block, then
    # over the ranks (the reference's global max, exactly).
    lump = fine_lumped(config, grid.shape)
    base = stencils.smoothness_row_abs_sum(grid.shape, problem.weights, dtype, dev)
    rowabs = base[_block(grid.shape, mesh)] + (
        fine_dd_l if lump else torch.sum(torch.abs(problem.coeff), dim=0))
    rho0 = _rho_bound(rowabs, problem.diag)
    dist.all_reduce(rho0, op=dist.ReduceOp.MAX)
    rhos = [rho0] + level_rhos(levels)
    taus = [(2.0 * config.mg_omega / r).to(torch.float32) for r in rhos]
    cheb_cfs, cheb_nus = (), ()
    if config.mg_smoother.startswith("chebyshev"):
        cheb_nus = tuple(sorted({config.mg_pre_smooth, config.mg_post_smooth,
                                 config.mg_coarse_iters} - {0}))
        cheb_cfs = tuple(tuple(chebyshev_coefs(r, n, config) for n in cheb_nus)
                         for r in rhos)

    radii = tuple(max([k for k in l.weights.active_orders() if k > 0], default=0)
                  for l in levels)
    n_sh, trans = _sharded_prefix(shapes, shards, radii)
    has_dense = (config.mg_coarse_solver == "dense" and K > 0
                 and math.prod(shapes[-1]) <= 4096 and K > n_sh)
    plan = _MGPlan(shapes=shapes, fweights=problem.weights,
                   lweights=tuple(l.weights for l in levels), radii=radii, n_sh=n_sh,
                   lump=lump, has_dense=has_dense, trans=trans, cheb_nus=cheb_nus)

    def mine(t, li):
        return t[_block(t.shape, mesh)].contiguous() if li < n_sh else t

    ddiags = tuple(mine(l.data_diag.to(dtype), li) for li, l in enumerate(levels))
    invdiags = tuple(mine(torch.where(l.diag > 0, 1.0 / l.diag, 1.0).to(dtype), li)
                     for li, l in enumerate(levels))
    coords = mesh.coords() + (0,) * (nd - len(mesh.shape))
    tR, tP = [], []
    for t, (kind, changing, halos) in enumerate(trans):
        Rrow, Prow = [], []
        S_f, S_c = shapes[t], shapes[t + 1]
        for j, d in enumerate(changing if kind != "rr" else ()):
            k = coords[d]
            Pm = _resize_matrix(S_f[d], S_c[d])          # [n_f, n_c]
            bf, bc = S_f[d] // shards[d], S_c[d] // shards[d]
            if kind == "ss":
                hR, hP = halos[j]
                # Columns index the neighbour-extended block.
                Rl = np.pad(Pm.T, ((0, 0), (hR, hR)))[k * bc:(k + 1) * bc,
                                                      k * bf:k * bf + bf + 2 * hR]
                Pl = np.pad(Pm, ((0, 0), (hP, hP)))[k * bf:(k + 1) * bf,
                                                    k * bc:k * bc + bc + 2 * hP]
            else:  # boundary: every coarse row x my fine block, and back
                Rl = Pm.T[:, k * bf:(k + 1) * bf]
                Pl = Pm[k * bf:(k + 1) * bf, :]
            Rrow.append(_band(Rl, dev))
            Prow.append(_band(Pl, dev))
        tR.append(tuple(Rrow))
        tP.append(tuple(Prow))
    inv_c = (_coarse_dense_inverse(levels[-1]).to(torch.float32) if has_dense
             else torch.zeros((1, 1), dtype=torch.float32, device=dev))
    ops = (taus, fine_dd_l, ddiags, invdiags, tuple(tR), tuple(tP), inv_c,
           cheb_cfs)
    return plan, ops


def level_routes(plan: _MGPlan, backend: str) -> tuple[str, ...]:
    """How each level of the distributed cycle applies its operator: "apply"
    (the fine level's exact sharded apply, whose float32 sweeps and residuals
    launch its ext kernel's modes where it has one), "ext" (the ext kernel's
    diagonal form on a sharded level: each float32 sweep and residual one
    launch), "plain" (a sharded level in plain torch: under ``backend="xla"``
    or without a smoothness term) or "replicated". Off "xla" every sharded
    level goes through the kernel at every size; the reference does only
    where `ext_fits_vmem` holds (sharded.py:557-605)."""
    fine_rad = max([k for k in plan.fweights.active_orders() if k > 0], default=0)

    def route(li):
        if li == 0 and not plan.lump:
            return "apply"
        if li > plan.n_sh:
            return "replicated"
        rad = fine_rad if li == 0 else plan.radii[li - 1]
        return "ext" if backend != "xla" and rad > 0 else "plain"

    return tuple(route(li) for li in range(len(plan.shapes)))


def _make_mg_precond(plan: _MGPlan, ops, apply_fn, diag_l, mesh: Mesh,
                     config: SolverConfig):
    """r_loc -> z_loc: one symmetric distributed cycle (see `_make_mg_plan`).
    ``apply_fn`` is the exact sharded fine apply, ``diag_l`` this rank's
    block of the fine diagonal. The returned function carries each level's
    route (`level_routes`) as ``.level_routes``."""
    taus, fine_dd_l, ddiags, invdiags, tR, tP, inv_c, cheb_cfs = ops
    nd = len(plan.shapes[0])
    shards = mesh.shards(nd)
    coords = mesh.coords() + (0,) * (nd - len(mesh.shape))
    K = len(plan.shapes) - 1
    nu, nu_post = config.mg_pre_smooth, config.mg_post_smooth
    fine_inv_diag = torch.where(diag_l > 0, 1.0 / diag_l, 1.0)
    wdepth = resolve_wdepth(config, plan.shapes[0])
    fine_rad = max([k for k in plan.fweights.active_orders() if k > 0], default=0)
    routes = level_routes(plan, config.backend)

    def plain_level_apply(x, dd, weights_l, S_l, radius):
        """(S + diag(dd)) x on a sharded level with plain torch ops."""
        return fused_normal_apply_ext_plain(_extend(x, radius, mesh), dd,
                                            _global_start(x.shape, mesh), weights_l, nd,
                                            radius, S_l)

    def lev_apply(x, li):
        """A x on level li where no ext launch computes it with its update."""
        if routes[li] == "apply":
            return apply_fn(x)
        if li == 0:
            return plain_level_apply(x, fine_dd_l, plan.fweights, plan.shapes[0], fine_rad)
        w_l, S_l, dd = plan.lweights[li - 1], plan.shapes[li], ddiags[li - 1]
        if routes[li] == "replicated":
            return stencils.smoothness_apply(x, w_l, nd) + dd * x
        return plain_level_apply(x, dd, w_l, S_l, plan.radii[li - 1])

    def ext_level(li):
        """The ext kernel's block operator of level li, made once, where the
        level's route launches it."""
        if routes[li] == "apply":
            return getattr(apply_fn, "level", None)
        if routes[li] != "ext":
            return None
        dd, w_l, S_l, rad = ((fine_dd_l, plan.fweights, plan.shapes[0], fine_rad) if li == 0
                             else (ddiags[li - 1], plan.lweights[li - 1], plan.shapes[li],
                                   plan.radii[li - 1]))
        dd = dd.to(torch.float32).contiguous()
        return ExtLevel(dd, _global_start(dd.shape, mesh), w_l, rad, S_l)

    levels = [ext_level(li) for li in range(K + 1)]
    # The sweeps' scalars, read to the host once: τ per level and the
    # Chebyshev schedules' rows. They are float32 values, so a product with
    # them rounds as the product with the 0-d tensor did.
    tau_host = [float(t) for t in taus]
    cheb_host = [[cf.tolist() for cf in cfs] for cfs in cheb_cfs]

    def step(li, z, mode, **kw):
        """One sweep, or the residual, on level li (`ExtLevel`'s modes):
        one ext launch on z and its halo slabs where the level has its
        kernel (float32), else A z and the update in plain torch ops."""
        lv = levels[li]
        if lv is not None and z.dtype == torch.float32:
            return lv(z, _level_slabs(z, lv.radius, mesh, lv.order), mode, **kw)
        return level_update(mode, lev_apply(z, li), z, **kw)

    def residual(r, z, li):
        return step(li, z.contiguous(), "residual", r=r.contiguous())

    def smooth(li, r, z, iters, from_zero):
        inv_d = fine_inv_diag if li == 0 else invdiags[li - 1]
        r, z = r.contiguous(), z.contiguous()
        if plan.cheb_nus:
            # Chebyshev in iterate-difference form (multigrid.chebyshev_coefs).
            if iters == 0:
                return torch.zeros_like(r) if from_zero else z
            cf = cheb_host[li][plan.cheb_nus.index(iters)]
            if from_zero:
                zp = torch.zeros_like(r)
                z = cf[0][1] * (inv_d * r)  # apply(0) == 0
                start = 1
            else:
                zp, start = z, 0
            for k in range(start, iters):
                z, zp = step(li, z, "chebyshev", r=r, inv_d=inv_d, z_prev=zp, s0=cf[k][0],
                             s1=cf[k][1]), z
            return z
        tau = tau_host[li]
        if from_zero:
            if iters == 0:
                return torch.zeros_like(r)
            z = tau * inv_d * r  # first sweep from zero: apply(0) == 0
            iters -= 1
        for _ in range(iters):
            z = step(li, z, "jacobi", r=r, inv_d=inv_d, s0=tau)
        return z

    def restrict(res, t):
        kind, changing, halos = plan.trans[t]
        S_f, S_c = plan.shapes[t], plan.shapes[t + 1]
        if kind == "rr":
            return make_restrict(S_f, S_c)(res)
        out = res
        for j, d in enumerate(changing):
            if kind == "ss":
                out = _halo_exchange(out, d, halos[j][0], mesh)
            rows, w = tR[t][j]
            out = apply_bands(out, rows, w.to(out.dtype), d)
        if kind == "ss":
            return out
        # boundary: place the block at its global offset on the unchanged
        # sharded axes, so the sum over ranks assembles the coarse residual.
        full = list(out.shape)
        idx = [slice(None)] * out.ndim
        for d in range(nd):
            if d not in changing and shards[d] > 1:
                b = S_f[d] // shards[d]
                full[d] = S_c[d]
                idx[d] = slice(coords[d] * b, (coords[d] + 1) * b)
        placed = torch.zeros(full, dtype=out.dtype, device=out.device)
        placed[tuple(idx)] = out
        return _all_sum(placed)

    def prolong_up(zc, t):
        kind, changing, halos = plan.trans[t]
        S_f = plan.shapes[t]
        if kind == "rr":
            return prolong(zc, S_f)
        out = zc
        for j, d in enumerate(changing):
            if kind == "ss":
                out = _halo_exchange(out, d, halos[j][1], mesh)
            rows, w = tP[t][j]
            out = apply_bands(out, rows, w.to(out.dtype), d)
        if kind == "boundary":
            for d in range(nd):
                if d not in changing and shards[d] > 1:
                    b = S_f[d] // shards[d]
                    out = out.narrow(d, coords[d] * b, b)
        return out

    def vcycle(r, li):
        if li == K:
            if li > 0 and plan.has_dense:
                return (inv_c.to(r.dtype) @ r.reshape(-1)).reshape(r.shape)
            return smooth(li, r, r, config.mg_coarse_iters, True)
        z = smooth(li, r, r, nu, True)
        rc = restrict(residual(r, z, li), li)
        zc = vcycle(rc, li + 1)
        if li + 1 < K and li < wdepth:
            # W-cycle second visit; skipped when the child is the coarsest.
            zc = zc + vcycle(residual(rc, zc, li + 1), li + 1)
        z = z + prolong_up(zc, li)
        return smooth(li, r, z, nu_post, False)

    def precond(r):
        return vcycle(r, 0)

    precond.level_routes, precond.levels = routes, levels
    return precond


def _make_local_precond(config: SolverConfig, plan, mg_ops, diag_l, apply_fn,
                        mesh: Mesh):
    """The rank's preconditioner: Jacobi on its diag block, or the
    distributed multigrid cycle."""
    if config.preconditioner == "jacobi":
        inv_diag = torch.where(diag_l > 0, 1.0 / diag_l, 1.0)
        return lambda r: inv_diag * r
    if config.preconditioner == "multigrid":
        return _make_mg_precond(plan, mg_ops, apply_fn, diag_l, mesh, config)
    return None


def _check_preconditioner(config: SolverConfig) -> None:
    if config.preconditioner not in ("none", "jacobi", "multigrid"):
        raise ValueError("sharded solve supports 'none', 'jacobi' or 'multigrid' "
                         f"preconditioning, got {config.preconditioner!r}")


def solve_sharded(problem: Problem, mesh: Mesh, config: SolverConfig = SolverConfig(),
                  x0: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, SolveInfo]:
    """Solve one large problem sharded over the ranks of ``mesh``; called on
    every rank. ``problem`` is the whole problem or this rank's blocks
    (`shard_problem`); every sharded extent must divide evenly. Returns this
    rank's block of the field and the (same on every rank) SolveInfo.

    Preconditioners: "none", "jacobi" (the local diag) or "multigrid" (the
    distributed multigrid, which computes the unsharded cycle up to float
    summation order, so the iterations do not depend on the mesh)."""
    _check_preconditioner(config)
    p = _local(problem, mesh)
    grid = p.grid
    plan, mg_ops = (_make_mg_plan(p, mesh, config) if config.preconditioner == "multigrid"
                    else (None, ()))
    apply_fn = make_sharded_apply(grid.shape, p.weights, mesh, p.coeff,
                                  backend=config.backend)
    precond = _make_local_precond(config, plan, mg_ops, p.diag, apply_fn, mesh)
    return pcg(apply_fn, p.b, _local_field(x0, p.b, grid.shape, mesh), precond,
               tol=config.tol, maxiter=config.maxiter,
               recompute_every=config.recompute_every,
               max_restarts=config.max_restarts, dot_fn=_pdot)


# ---- refinement -----------------------------------------------------------

def _shard_precise_parts(pp, mesh: Mesh):
    """This rank's per-sample float64 rows: the samples whose base cell
    corner lies in its block (their OWNER), with corner indices relocated
    into the block extended by one node on the high side of every axis (a
    sample at a seam spills one node past the block; `_scatter_fold_hi`
    folds that halo back onto the neighbour). Returns (rows [m, R, C] f64,
    tw [m, R] f64, idx [m, C] int64: flat indices into the extended block)."""
    grid = pp.grid
    nd = grid.ndim
    shards = mesh.shards(nd)
    n_loc = torch.tensor([n // s for n, s in zip(grid.shape, shards)],
                         device=pp.corner_idx.device)
    strides = Grid(grid.shape).strides
    ci = pp.corner_idx                                            # [n, C]
    coords = torch.stack([(ci // s) % n for s, n in zip(strides, grid.shape)], dim=-1)
    owner_vec = coords[:, 0, :] // n_loc                          # corner 0 = base
    owner = torch.zeros_like(owner_vec[:, 0])
    for d in range(nd):
        owner = owner * shards[d] + owner_vec[:, d]
    mine = owner == dist.get_rank()
    local = coords[mine] - (owner_vec[mine] * n_loc)[:, None, :]  # [m, C, D]
    ext_strides = Grid(tuple(int(n) + 1 for n in n_loc)).strides
    idx = sum(local[..., d] * ext_strides[d] for d in range(nd))
    return pp.rows64[mine], pp.tw64[mine], idx


def _ext_hi(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The block extended by ONE node on the high side of every axis with
    neighbour data (one axis after the other, corners transitively); zeros
    past the global edge, where no sample reads."""
    for d in range(x.ndim):
        (from_right,) = _post([(x.narrow(d, 0, 1), mesh.neighbour(d, -1),
                                mesh.neighbour(d, 1))])()
        x = torch.cat([x, from_right], dim=d)
    return x


def _scatter_fold_hi(contrib: torch.Tensor, idx_l: torch.Tensor, ext_shape,
                     loc_shape, mesh: Mesh) -> torch.Tensor:
    """Scatter [m, C] per-sample corner contributions into the extended
    block, then FOLD each high halo slab onto the neighbour's first row (the
    reverse of `_ext_hi`; one axis after the other)."""
    flat = torch.zeros(math.prod(ext_shape), dtype=contrib.dtype, device=contrib.device)
    flat.index_add_(0, idx_l.reshape(-1), contrib.reshape(-1))
    y = flat.reshape(ext_shape)
    for d, n_l in enumerate(loc_shape):
        body, hi = y.narrow(d, 0, n_l), y.narrow(d, n_l, 1)
        (recv,) = _post([(hi, mesh.neighbour(d, 1), mesh.neighbour(d, -1))])()
        y = torch.cat([body.narrow(d, 0, 1) + recv, body.narrow(d, 1, n_l - 1)], dim=d)
    return y


def _inner_solve(apply32, precond, r, rr, bnorm2, config: SolverConfig):
    """One refinement round's float32 sharded PCG on the current residual:
    it only has to shrink that residual to the final target (max_restarts=1:
    the float64 outer loop verifies). Returns (d float64, iterations)."""
    rel = torch.sqrt(rr / bnorm2)
    floor = max(config.tol, 1e-4)  # float32 inner solves stagnate near 1e-4
    inner_tol = float(torch.clamp(0.5 * config.tol / rel, floor, 0.5))
    d32, info = pcg(apply32, r.to(torch.float32), precond_fn=precond, tol=inner_tol,
                    maxiter=config.maxiter, recompute_every=config.recompute_every,
                    max_restarts=1, dot_fn=_pdot)
    return d32.to(torch.float64), int(info.iterations)


def _bnorm2(b64_l: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(_pdot(b64_l, b64_l), torch.finfo(torch.float64).tiny)


def _refined_info(rr, bnorm2, iters: int, config: SolverConfig) -> SolveInfo:
    rel = torch.sqrt(rr / bnorm2)
    return SolveInfo(iterations=torch.tensor(iters, dtype=torch.int32),
                     rel_residual=rel.to(torch.float32), converged=rel <= config.tol)


def solve_refined_sharded(problem64, mesh: Mesh, config: SolverConfig = SolverConfig(),
                          x0: Optional[torch.Tensor] = None
                          ) -> tuple[torch.Tensor, SolveInfo]:
    """Sharded mixed-precision solve to a TRUE ≤ ``tol`` relative residual:
    float32 sharded PCG rounds inside a float64 outer loop with summed float64
    inner products; called on every rank, returns this rank's float64 block.

    ``problem64`` is a ``sdf.PreciseProblem`` (the matter-free protocol,
    `_solve_refined_sharded_precise`) or a float64 `Problem` (whole or this
    rank's blocks; a full float64 residual per round)."""
    if hasattr(problem64, "residual64"):
        return _solve_refined_sharded_precise(problem64, mesh, config, x0)
    _check_preconditioner(config)
    p64 = _local(problem64, mesh)
    grid = p64.grid
    p32 = dataclasses.replace(p64, coeff=p64.coeff.to(torch.float32),
                              b=p64.b.to(torch.float32), diag=p64.diag.to(torch.float32))
    plan, mg_ops = (_make_mg_plan(p32, mesh, config) if config.preconditioner == "multigrid"
                    else (None, ()))
    apply64 = make_sharded_apply(grid.shape, p64.weights, mesh, p64.coeff)
    apply32 = make_sharded_apply(grid.shape, p64.weights, mesh, p32.coeff,
                                 backend=config.backend)
    precond = _make_local_precond(config, plan, mg_ops, p32.diag, apply32, mesh)
    bnorm2 = _bnorm2(p64.b)
    tol2 = config.tol * config.tol * bnorm2
    x = _local_field(x0, p64.b, grid.shape, mesh).to(torch.float64)
    r = p64.b - apply64(x)
    rr, k, iters = _pdot(r, r), 0, 0
    while bool(rr > tol2) and k < config.refine_rounds:
        d, n = _inner_solve(apply32, precond, r, rr, bnorm2, config)
        x = x + d
        r = p64.b - apply64(x)
        rr, k, iters = _pdot(r, r), k + 1, iters + n
    return x, _refined_info(rr, bnorm2, iters, config)


def _solve_refined_sharded_precise(pp, mesh: Mesh, config: SolverConfig,
                                   x0: Optional[torch.Tensor]
                                   ) -> tuple[torch.Tensor, SolveInfo]:
    """The matter-free sharded refinement (the single-card PreciseProblem
    protocol on every rank): per-sample float64 rows on their base cell's
    owner (`_shard_precise_parts`), row gathers from the one-node
    high-extended block (`_ext_hi`), row scatters folded back
    (`_scatter_fold_hi`), exact in float64; ONE exact float64 residual after
    the peeled round 1, then r ← r − A·d with the smoothness on the exact
    split d = hi + lo in float32."""
    _check_preconditioner(config)
    grid = pp.grid
    nd = grid.ndim
    _check_divisible(grid.shape, mesh)
    weights = pp.weights
    radius = max(stencils.max_stencil_radius(weights), 1)
    p32 = shard_problem(pp.p32, mesh)
    loc_shape = tuple(p32.b.shape)
    ext_shape = tuple(n + 1 for n in loc_shape)
    b64_l = pp.b64[_block(grid.shape, mesh)].contiguous()
    rows_l, tw_l, idx_l = _shard_precise_parts(pp, mesh)
    plan, mg_ops = (_make_mg_plan(p32, mesh, config) if config.preconditioner == "multigrid"
                    else (None, ()))
    apply32 = make_sharded_apply(grid.shape, weights, mesh, p32.coeff,
                                 backend=config.backend)
    precond = _make_local_precond(config, plan, mg_ops, p32.diag, apply32, mesh)

    def smooth_sharded(x):
        return smoothness_ext(_extend(x, radius, mesh), x.shape, weights, grid.shape,
                              radius, _global_start(x.shape, mesh))

    def rows_apply(x):
        """B x: [m, R] per-sample row values from the local block."""
        xc = _ext_hi(x, mesh).reshape(-1)[idx_l]
        return torch.einsum("nrc,nc->nr", rows_l, xc)

    def row_scatter(y):
        """Bᵀ y folded onto the local blocks."""
        contrib = torch.einsum("nrc,nr->nc", rows_l, y)
        return _scatter_fold_hi(contrib, idx_l, ext_shape, loc_shape, mesh)

    def residual64(x):
        # r = −S x + Bᵀ(t − B x), the scatter exact in float64.
        return row_scatter(tw_l - rows_apply(x)) - smooth_sharded(x)

    def apply64_delta(d):
        hi = d.to(torch.float32)
        lo = (d - hi).to(torch.float32)
        s = smooth_sharded(hi).to(torch.float64) + smooth_sharded(lo).to(torch.float64)
        return s + row_scatter(rows_apply(d))

    bnorm2 = _bnorm2(b64_l)
    tol2 = config.tol * config.tol * bnorm2
    if x0 is None:
        x = torch.zeros_like(b64_l)
        r, rr = b64_l, bnorm2  # r(0) = b: skip one float64 residual
    else:
        x = _local_field(x0, b64_l, grid.shape, mesh).to(torch.float64)
        r = residual64(x)
        rr = _pdot(r, r)
    # Peeled round 1, then the ONE exact float64 residual of the solve.
    d, iters = _inner_solve(apply32, precond, r, rr, bnorm2, config)
    x = x + d
    r = residual64(x)
    rr, k = _pdot(r, r), 1
    while bool(rr > tol2) and k < config.refine_rounds:
        d, n = _inner_solve(apply32, precond, r, rr, bnorm2, config)
        x = x + d
        r = r - apply64_delta(d)  # incremental: the error ∝ ‖d‖
        rr, k, iters = _pdot(r, r), k + 1, iters + n
    return x, _refined_info(rr, bnorm2, iters, config)
