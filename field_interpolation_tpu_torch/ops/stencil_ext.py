"""The sharded apply: ``(S + DᵀWD) x`` on one shard's halo-extended block.

One CUDA source (``csrc/normal_apply_ext.cu``) stands in for the last two TPU
kernels of ``field_interpolation_tpu/ops/pallas_stencil.py``:

* ``fused_normal_apply_ext`` (378, ``pallas_call`` 462): the local block
  extended by ``radius`` on every axis with neighbour data (zeros past the
  global edge); the data term is the [3^D, *local] stencil or a bare
  [*local] diagonal (the distributed multigrid's levels); 2-D and 3-D.
* ``fused_normal_apply_ext_striped`` (1282, ``pallas_call`` 1387): a 2-D
  block extended along axis 1 only, its axis-0 halos passed as two separate
  slabs, as the reference's striped kernel takes them.

The smoothness windows are masked in GLOBAL coordinates: the dropped-row
boundary appears at the global edge only, never at a shard seam. Each
wrapper launches its kernel for a CUDA tensor and runs its plain version
(``*_plain``) for a CPU tensor; nothing else decides.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

from .. import constraints as cons
from .. import stencils
from ..weights import Weights
from . import _build
from .stencil import order_w2

_INT32_MAX = 2**31 - 1


def axis_normal_ext(x_ext: torch.Tensor, order: int, axis: int, h: int, n_glob: int,
                    n_loc: int, global_start: int) -> torch.Tensor:
    """(BᵀB)x along one axis of a block extended by h ≥ order on both sides
    of ``axis``, whose first local node has global coordinate
    ``global_start``: the valid-window correlate, windows that leave the
    global grid masked, the transposed full convolution, the local part (the
    reference's ``parallel/sharded.py:_sharded_axis_normal_apply``)."""
    taps = stencils.STENCIL_TAPS[order]
    L = len(taps)
    y = stencils._valid_corr(x_ext, taps, axis)
    m = y.shape[axis]
    # Window j starts at global coordinate global_start - h + j.
    win = torch.arange(m, device=x_ext.device) + (global_start - h)
    shape = [1] * y.ndim
    shape[axis] = m
    keep = ((win >= 0) & (win <= n_glob - L)).view(shape)
    y = torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return stencils._full_conv_t(y, taps, axis, m + L - 1).narrow(axis, h, n_loc)


def smoothness_ext(x_ext: torch.Tensor, loc_shape: Sequence[int], weights: Weights,
                   grid_shape: Sequence[int], radius: int,
                   global_start: Sequence[int]) -> torch.Tensor:
    """Σ_k w_k² (B_kᵀB_k) x (+ w_0² x) on a block extended by ``radius``
    along every axis; windows masked in global coordinates (the reference's
    ``parallel/sharded.py:_smoothness_from_ext``)."""
    ndim = len(grid_shape)
    centre = x_ext
    for d in range(ndim):
        centre = centre.narrow(d, radius, loc_shape[d])
    out = torch.zeros_like(centre)
    active = weights.active_orders()
    if 0 in active:
        out = out + weights.model_0 ** 2 * centre
    for d in range(ndim):
        # The block extended along axis d only.
        view = x_ext
        for d2 in range(ndim):
            if d2 != d:
                view = view.narrow(d2, radius, loc_shape[d2])
        for order in active:
            if order:
                out = out + weights.model_weight(order) ** 2 * axis_normal_ext(
                    view, order, d, radius, grid_shape[d], loc_shape[d],
                    int(global_start[d]))
    return out


def fused_normal_apply_ext_plain(x_ext: torch.Tensor, coeff: torch.Tensor,
                                 global_start: Sequence[int], weights: Weights,
                                 ndim: int, radius: int,
                                 grid_shape: Sequence[int]) -> torch.Tensor:
    """(S + data) x on the extended block with plain torch ops; the data term
    is diagonal when ``coeff`` has the grid's rank."""
    r = radius
    loc = tuple(n - 2 * r for n in x_ext.shape)
    out = smoothness_ext(x_ext, loc, weights, grid_shape, r, global_start)
    if coeff.ndim == ndim:
        centre = x_ext[tuple(slice(r, r + n) for n in loc)]
        return out + coeff * centre
    for o_idx, off in enumerate(cons.offset_list(ndim)):
        src = tuple(slice(r + int(o), r + int(o) + n) for o, n in zip(off, loc))
        out = out + coeff[o_idx] * x_ext[src]
    return out


def fused_normal_apply_ext_striped_plain(x_ext1: torch.Tensor, from_top: torch.Tensor,
                                         from_bot: torch.Tensor, coeff: torch.Tensor,
                                         global_start: Sequence[int], weights: Weights,
                                         radius: int,
                                         grid_shape: Sequence[int]) -> torch.Tensor:
    """The striped operand form with plain torch ops: the slabs stacked
    around the block, then `fused_normal_apply_ext_plain`."""
    x_ext = torch.cat([from_top, x_ext1, from_bot], dim=0)
    return fused_normal_apply_ext_plain(x_ext, coeff, global_start, weights, 2, radius,
                                        grid_shape)


def _check(what: str, tensors, ok: bool, want: str) -> None:
    dev = tensors[0].device
    if not ok or any(t.dtype != torch.float32 or t.device != dev
                     or not t.is_contiguous() for t in tensors):
        raise ValueError(
            f"{what}: needs contiguous float32 tensors on one device, {want}; got "
            + ", ".join(f"{tuple(t.shape)} {t.dtype} on {t.device}" for t in tensors))


def _check_block(what: str, loc, global_start, grid_shape, weights: Weights,
                 radius: int) -> tuple[int, ...]:
    """Validate the block's place in the global grid and the halo width;
    returns the global start as ints."""
    gs = tuple(int(v) for v in global_start)
    if (len(gs) != len(loc) or len(grid_shape) != len(loc)
            or any(n < 1 or g < 0 or g + n > N for n, g, N in zip(loc, gs, grid_shape))):
        raise ValueError(f"{what}: block {loc} at {gs} does not lie in the grid "
                         f"{tuple(grid_shape)}")
    if radius < max(stencils.max_stencil_radius(weights), 1):
        raise ValueError(f"{what}: halo {radius} is narrower than the operator's "
                         f"radius {stencils.max_stencil_radius(weights)}")
    return gs


def _dims3(v: Sequence[int]) -> tuple[int, int, int]:
    return (v[0], v[1], v[2] if len(v) == 3 else 1)


def fused_normal_apply_ext(x_ext: torch.Tensor, coeff: torch.Tensor,
                           global_start: Sequence[int], weights: Weights, ndim: int,
                           radius: int, grid_shape: Sequence[int]) -> torch.Tensor:
    """(S + DᵀWD) x on one block of a 2-D or 3-D grid: ``x_ext`` is the block
    extended by ``radius`` on every axis, ``global_start`` the global
    coordinate of its first node, ``grid_shape`` the global grid; the data
    term is diagonal when ``coeff`` has the grid's rank."""
    if x_ext.device.type == "cpu":
        return fused_normal_apply_ext_plain(x_ext, coeff, global_start, weights, ndim,
                                            radius, grid_shape)
    if x_ext.device.type != "cuda":
        raise ValueError(f"fused_normal_apply_ext: no kernel for device {x_ext.device}")
    what = "fused_normal_apply_ext"
    if ndim not in (2, 3) or x_ext.ndim != ndim:
        raise ValueError(f"{what}: the CUDA kernel covers 2-D and 3-D blocks, got "
                         f"ndim={ndim} and x_ext {tuple(x_ext.shape)}")
    loc = tuple(n - 2 * radius for n in x_ext.shape)
    diag = coeff.ndim == ndim
    want = loc if diag else (3 ** ndim,) + loc
    _check(what, (x_ext, coeff), tuple(coeff.shape) == want,
           f"x_ext of the block plus {radius} on every axis and coeff {want}")
    gs = _check_block(what, loc, global_start, grid_shape, weights, radius)
    n = math.prod(loc)
    if x_ext.numel() > _INT32_MAX or (ndim == 2 and not diag and 9 * n > _INT32_MAX):
        raise ValueError(f"{what}: block {loc} exceeds the kernel's 32-bit indexing")
    out = torch.empty(loc, dtype=torch.float32, device=x_ext.device)
    lib = _build.library()
    with torch.cuda.device(x_ext.device):
        rc = lib.fi_normal_apply_ext(x_ext.data_ptr(), coeff.data_ptr(), out.data_ptr(),
                                     ndim, *_dims3(loc), *_dims3(gs),
                                     *_dims3(tuple(grid_shape)), radius,
                                     *order_w2(weights), int(diag),
                                     _build.stream_handle(x_ext.device))
    _build.check(rc, what)
    fused_normal_apply_ext.launches += 1
    return out


fused_normal_apply_ext.launches = 0


def fused_normal_apply_ext_striped(x_ext1: torch.Tensor, from_top: torch.Tensor,
                                   from_bot: torch.Tensor, coeff: torch.Tensor,
                                   global_start: Sequence[int], weights: Weights,
                                   radius: int, grid_shape: Sequence[int]) -> torch.Tensor:
    """(S + DᵀWD) x on one block of a 2-D grid in the reference's striped
    operand form: ``x_ext1`` [n0, n1 + 2r] is the block extended along axis 1,
    ``from_top`` / ``from_bot`` [r, n1 + 2r] its axis-0 halos (corners
    filled), ``coeff`` [9, n0, n1]. One launch covers the whole block; the
    three operands are read where they lie, never stacked into a copy."""
    if x_ext1.device.type == "cpu":
        return fused_normal_apply_ext_striped_plain(x_ext1, from_top, from_bot, coeff,
                                                    global_start, weights, radius,
                                                    grid_shape)
    what = "fused_normal_apply_ext_striped"
    if x_ext1.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {x_ext1.device}")
    r = radius
    n0, W = tuple(x_ext1.shape) if x_ext1.ndim == 2 else (0, 0)
    loc = (n0, W - 2 * r)
    ok = (x_ext1.ndim == 2 and tuple(from_top.shape) == (r, W)
          and tuple(from_bot.shape) == (r, W) and tuple(coeff.shape) == (9,) + loc)
    _check(what, (x_ext1, from_top, from_bot, coeff), ok,
           f"x_ext1 [n0, n1 + 2·{r}], slabs [{r}, n1 + 2·{r}] and coeff [9, n0, n1]")
    gs = _check_block(what, loc, global_start, grid_shape, weights, r)
    if 9 * n0 * loc[1] > _INT32_MAX or n0 * W > _INT32_MAX:
        raise ValueError(f"{what}: block {loc} exceeds the kernel's 32-bit indexing")
    out = torch.empty(loc, dtype=torch.float32, device=x_ext1.device)
    lib = _build.library()
    with torch.cuda.device(x_ext1.device):
        rc = lib.fi_normal_apply_ext_striped(
            x_ext1.data_ptr(), from_top.data_ptr(), from_bot.data_ptr(), coeff.data_ptr(),
            out.data_ptr(), n0, loc[1], gs[0], gs[1], grid_shape[0], grid_shape[1], r,
            *order_w2(weights), _build.stream_handle(x_ext1.device))
    _build.check(rc, what)
    fused_normal_apply_ext_striped.launches += 1
    return out


fused_normal_apply_ext_striped.launches = 0
