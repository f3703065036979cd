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

`ExtLevel` is the form the distributed multigrid and the sharded apply
launch: one rank's block and the halo slabs the exchange delivers, read in
place (no extended copy of the block), the block's constant launch
arguments made once, and in the same launch one of the cycle's updates
(``MODES``): A z, the residual r − A z, the Jacobi sweep z + τ·D⁻¹(r − A z)
or the Chebyshev step z + c0·(z − z_prev) + c1·D⁻¹(r − A z), in the
reference's order and rounding (its ``parallel/sharded.py:611-640, 720``).

The smoothness windows are masked in GLOBAL coordinates: the dropped-row
boundary appears at the global edge only, never at a shard seam. Each
wrapper launches its kernel for a CUDA tensor and runs its plain version
(``*_plain``) for a CPU tensor; nothing else decides. Launches are counted
in ``fused_normal_apply_ext.launches`` (the whole and diagonal forms) and
``fused_normal_apply_ext_striped.launches`` (the striped form), per mode in
their ``.modes``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Sequence

import torch

from .. import constraints as cons
from .. import stencils
from ..weights import Weights
from . import _build
from .stencil import order_w2

_INT32_MAX = 2**31 - 1
MODES = ("apply", "residual", "jacobi", "chebyshev")
# The widest halo the kernel stages (csrc/normal_apply_ext.cu:kMaxHalo): the
# operator's radius is at most 3 (model_3).
MAX_HALO = 3


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


def slab_shapes(loc: Sequence[int], radius: int,
                order: Sequence[int]) -> list[tuple[int, ...]]:
    """The halo slabs' shape per axis of ``order``, the order of the
    exchange: axes exchanged before it extended by ``radius`` on both sides
    (the corners), ``radius`` along its own axis, the local extent along
    the later ones."""
    out = []
    for k, axis in enumerate(order):
        shape = list(loc)
        for before in order[:k]:
            shape[before] += 2 * radius
        shape[axis] = radius
        out.append(tuple(shape))
    return out


def extend_with_slabs(z: torch.Tensor, slabs, radius: int,
                      order: Sequence[int]) -> torch.Tensor:
    """The block extended by its halo slabs, axis after axis in ``order``
    (zeros where a slab is None or missing): the array `parallel.sharded`'s
    exchange used to concatenate."""
    x = z
    for k, axis in enumerate(order):
        lo, hi = slabs[k] if k < len(slabs) else (None, None)
        shape = list(x.shape)
        shape[axis] = radius
        lo = x.new_zeros(shape) if lo is None else lo
        hi = x.new_zeros(shape) if hi is None else hi
        x = torch.cat([lo, x, hi], dim=axis)
    return x


def level_update(mode: str, az: torch.Tensor, z: torch.Tensor,
                 r: Optional[torch.Tensor] = None, inv_d: Optional[torch.Tensor] = None,
                 z_prev: Optional[torch.Tensor] = None, s0: float = 0.0,
                 s1: float = 0.0) -> torch.Tensor:
    """A mode's output from az = A z with plain torch ops, in the reference
    cycle's order (its ``parallel/sharded.py:632-640, 720``): A z; r − A z;
    z + τ·D⁻¹(r − A z) with τ = s0; z + c0·(z − z_prev) + c1·D⁻¹(r − A z)
    with (c0, c1) = (s0, s1)."""
    if mode == "apply":
        return az
    if mode == "residual":
        return r - az
    if mode == "jacobi":
        return z + s0 * inv_d * (r - az)
    if mode == "chebyshev":
        return z + s0 * (z - z_prev) + s1 * inv_d * (r - az)
    raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")


def fused_normal_apply_ext_slabs_plain(z: torch.Tensor, slabs, coeff: torch.Tensor,
                                       global_start: Sequence[int], weights: Weights,
                                       radius: int, grid_shape: Sequence[int],
                                       order: Sequence[int], mode: str = "apply",
                                       r=None, inv_d=None, z_prev=None, s0: float = 0.0,
                                       s1: float = 0.0) -> torch.Tensor:
    """`ExtLevel`'s function with plain torch ops: the slabs concatenated
    around the block (`extend_with_slabs`), `fused_normal_apply_ext_plain`,
    then the mode's update (`level_update`)."""
    x_ext = extend_with_slabs(z, slabs, radius, order)
    az = fused_normal_apply_ext_plain(x_ext, coeff, global_start, weights, z.ndim, radius,
                                      grid_shape)
    return level_update(mode, az, z, r, inv_d, z_prev, s0, s1)


class _ExtArgs(ctypes.Structure):
    """csrc/normal_apply_ext.cu:ExtArgs, field for field."""

    _fields_ = [("x", ctypes.c_void_p), ("lo", ctypes.c_void_p * 3),
                ("hi", ctypes.c_void_p * 3), ("coeff", ctypes.c_void_p),
                ("r", ctypes.c_void_p), ("zp", ctypes.c_void_p), ("inv_d", ctypes.c_void_p),
                ("out", ctypes.c_void_p), ("w2", ctypes.c_float * 4), ("s0", ctypes.c_float),
                ("s1", ctypes.c_float), ("ndim", ctypes.c_int), ("diag", ctypes.c_int),
                ("mode", ctypes.c_int), ("halo", ctypes.c_int), ("x_halo", ctypes.c_int),
                ("slab0_halo", ctypes.c_int), ("xs0", ctypes.c_int), ("xs1", ctypes.c_int),
                ("n", ctypes.c_int * 3), ("g", ctypes.c_int * 3), ("N", ctypes.c_int * 3)]


class ExtLevel:
    """One rank's block operator on one level of a sharded solve: ``(S +
    DᵀWD) z`` on the block and the halo slabs the exchange delivers, and in
    the same launch one of the distributed cycle's updates (``MODES``).

    ``coeff`` is the block's [3^D, *local] stencil or [*local] data diagonal,
    ``global_start`` the global coordinate of its first node. The slabs come
    one (low, high) pair per axis in ``order``, the order of the exchange:
    axis 0 first (``order`` (0, 1[, 2])), or for the ``striped`` form (2-D,
    9 channels; the reference's operand form) axis 1 first, so that the
    axis-0 slabs carry the corners. A slab is None only past the global edge
    (an axis that is not sharded passes none): the kernel reads nothing
    there, where the plain version reads zeros.

    Everything constant is checked and packed once, here and at the first
    launch; a call checks its operands' shapes and takes their pointers and
    the current stream. On a CUDA tensor a call launches the kernel
    (``csrc/normal_apply_ext.cu:fi_ext_level``) or raises; on a CPU tensor
    it runs `fused_normal_apply_ext_slabs_plain`."""

    def __init__(self, coeff: torch.Tensor, global_start: Sequence[int], weights: Weights,
                 radius: int, grid_shape: Sequence[int], striped: bool = False):
        nd = len(grid_shape)
        self.ndim, self.radius, self.weights = nd, int(radius), weights
        self.grid_shape = tuple(int(n) for n in grid_shape)
        self.diag = coeff.ndim == nd
        self.loc = tuple(coeff.shape[-nd:])
        want = self.loc if self.diag else (3 ** nd,) + self.loc
        if nd not in (2, 3) or tuple(coeff.shape) != want or (striped and (nd, self.diag)
                                                              != (2, False)):
            raise ValueError(f"ExtLevel: coeff {tuple(coeff.shape)} is neither a 2-D/3-D "
                             f"block's 3^D-channel stencil nor its diagonal"
                             + (" (the striped form takes 9 channels)" if striped else ""))
        self.global_start = _check_block("ExtLevel", self.loc, global_start, grid_shape,
                                         weights, self.radius)
        self.coeff = coeff
        self.striped = bool(striped)
        self.order = (1, 0) if striped else tuple(range(nd))
        self.slab_shapes = slab_shapes(self.loc, self.radius, self.order)
        # Per exchanged axis, whether its low and high faces are the global edge.
        self._edges = [(self.global_start[a] == 0,
                        self.global_start[a] + self.loc[a] == self.grid_shape[a])
                       for a in self.order]
        self.counter = fused_normal_apply_ext_striped if striped else fused_normal_apply_ext
        self._args = None

    def __call__(self, z: torch.Tensor, slabs=(), mode: str = "apply", r=None, inv_d=None,
                 z_prev=None, s0: float = 0.0, s1: float = 0.0) -> torch.Tensor:
        """The mode's output on the block ``z`` (see `level_update`):
        ``slabs`` one (low, high) pair per axis of ``order`` (fewer pairs:
        None past them); ``r`` for every mode but "apply", ``inv_d`` and
        ``s0`` (τ, or c0) for the sweeps, ``z_prev`` and ``s1`` (c1) for
        "chebyshev"."""
        if z.device.type == "cpu":
            return fused_normal_apply_ext_slabs_plain(
                z, slabs, self.coeff, self.global_start, self.weights, self.radius,
                self.grid_shape, self.order, mode, r, inv_d, z_prev, s0, s1)
        if z.device.type != "cuda":
            raise ValueError(f"ExtLevel: no kernel for device {z.device}")
        out = torch.empty(self.loc, dtype=torch.float32, device=z.device)
        self._launch(out, z, slabs, mode, r, inv_d, z_prev, s0, s1)
        return out

    def _launch(self, out, z, slabs, mode, r, inv_d, z_prev, s0, s1) -> None:
        """Check the operands, take their pointers and launch into ``out``."""
        a = self._args if self._args is not None else self._pack(z.device)
        m = MODES.index(mode) if mode in MODES else -1
        if m < 0:
            raise ValueError(f"unknown mode {mode!r}; the modes are {MODES}")
        operands = (z, r, inv_d, z_prev)[:min(m, 2) + 1 + (m == 3)]
        for t in operands:
            if (t is None or tuple(t.shape) != self.loc or t.dtype != torch.float32
                    or not t.is_contiguous() or t.get_device() != self._index):
                raise ValueError(f"ExtLevel ({mode}): needs z, r, inv_d, z_prev as the mode "
                                 f"takes them, contiguous float32 {self.loc} on "
                                 f"{self.coeff.device}; got {self._describe(operands)}")
        a.lo[0] = a.lo[1] = a.lo[2] = a.hi[0] = a.hi[1] = a.hi[2] = None
        for k, edges in enumerate(self._edges):
            axis, shape = self.order[k], self.slab_shapes[k]
            for side, t, edge in zip((a.lo, a.hi), slabs[k] if k < len(slabs)
                                     else (None, None), edges):
                if t is None:
                    if not edge:
                        raise ValueError(f"ExtLevel: the axis-{axis} face of block "
                                         f"{self.loc} at {self.global_start} is a seam, "
                                         "not the global edge: its slab cannot be None")
                    continue
                if (tuple(t.shape) != shape or t.dtype != torch.float32
                        or not t.is_contiguous() or t.get_device() != self._index):
                    raise ValueError(f"ExtLevel: the axis-{axis} slab must be contiguous "
                                     f"float32 {shape} on {self.coeff.device}; got "
                                     f"{self._describe([t])}")
                side[axis] = t.data_ptr()
        a.x, a.out, a.mode = z.data_ptr(), out.data_ptr(), m
        if m:
            a.r = r.data_ptr()
        if m >= 2:
            a.inv_d, a.s0 = inv_d.data_ptr(), s0
        if m == 3:
            a.zp, a.s1 = z_prev.data_ptr(), s1
        _build.check(self._fn(self._addr, self._stream(self._index)), "ExtLevel")
        self.counter.launches += 1
        self.counter.modes[mode] += 1

    def _pack(self, device) -> _ExtArgs:
        """The constant launch arguments, once (the first CUDA call)."""
        c = self.coeff
        if (c.dtype != torch.float32 or not c.is_contiguous() or c.device != device
                or self.radius > MAX_HALO):
            raise ValueError(f"ExtLevel: needs a contiguous float32 coeff on {device} and a "
                             f"halo of at most {MAX_HALO}; got {self._describe([c])}, "
                             f"halo {self.radius}")
        ext = math.prod(n + 2 * self.radius for n in self.loc)
        if ext > _INT32_MAX or (self.ndim == 2 and not self.diag
                                and 9 * math.prod(self.loc) > _INT32_MAX):
            raise ValueError(f"ExtLevel: block {self.loc} exceeds the kernel's 32-bit indexing")
        a = _ExtArgs()
        a.coeff = c.data_ptr()
        a.w2[:] = order_w2(self.weights)
        a.ndim, a.diag, a.halo = self.ndim, int(self.diag), self.radius
        a.slab0_halo = int(self.striped)
        for d, (n, g, N) in enumerate(zip(_dims3(self.loc), _dims3(self.global_start),
                                          _dims3(self.grid_shape))):
            a.n[d], a.g[d], a.N[d] = n, (g if d < self.ndim else 0), N
        self._fn = _build.library().fi_ext_level
        # The current stream's handle: torch's raw getter (what its own
        # compiled kernels launch on), or the public one where it is absent.
        self._stream = getattr(torch._C, "_cuda_getCurrentRawStream", None) or (
            lambda i: torch.cuda.current_stream(i).cuda_stream)
        self._index = device.index if device.index is not None else torch.cuda.current_device()
        self._addr = ctypes.addressof(a)
        self._args = a
        return a

    @staticmethod
    def _describe(tensors) -> str:
        return ", ".join("None" if t is None else f"{tuple(t.shape)} {t.dtype} on {t.device}"
                         for t in tensors)


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
    fused_normal_apply_ext.modes["apply"] += 1
    return out


fused_normal_apply_ext.launches = 0
fused_normal_apply_ext.modes = dict.fromkeys(MODES, 0)


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
    fused_normal_apply_ext_striped.modes["apply"] += 1
    return out


fused_normal_apply_ext_striped.launches = 0
fused_normal_apply_ext_striped.modes = dict.fromkeys(MODES, 0)
