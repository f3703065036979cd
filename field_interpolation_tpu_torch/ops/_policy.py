"""The reference's TPU tiling rules, kept as pure shape arithmetic.

Copies of the VMEM-fit and stripe/tile pickers of
``field_interpolation_tpu/ops/pallas_stencil.py`` (line numbers below).
They size blocks for a TPU core's VMEM and mean nothing on the H100; the
port evaluates them only to decide, level by level and exactly as the
reference does, WHICH reference kernel a call stands in for (the whole-array
apply, the striped apply, the two-axis 3-D apply, the multi-sweep smoother,
a per-sweep kernel, the sharded apply's whole or striped form, or plain
ops). ``tests/test_torch_dispatch.py`` holds each function equal to the
reference's. Re-deciding these rules on the H100 is ROADMAP work.
"""

from __future__ import annotations

import math

_VMEM_BUDGET_BYTES = 8 * 1024 * 1024  # pallas_stencil.py:52
_H_EXT = 8       # axis-0 halo of the 2-D smoothers and the striped ext apply (1259)
_W_EXT = 128     # axis-1 halo block of the 2-D tiled smoother (778)
_H0_3D, _H1_3D = 4, 8  # halos of the two-axis 3-D kernels (1641)


def fits_vmem(shape: tuple[int, ...], diag_data: bool = False) -> bool:
    """Whole-array gate (79-96). ``diag_data``: the data term is a single
    diagonal plane (multigrid coarse levels, the lumped fine operator)
    instead of 3^D channels."""
    if len(shape) < 2:
        return False
    n = math.prod(shape)
    channels = 1 if diag_data else 3 ** len(shape)
    extra = 5 if diag_data else 2
    return n * (channels + extra) * 4 <= _VMEM_BUDGET_BYTES


def ext_fits_vmem(local_shape: tuple[int, ...], radius: int,
                  diag_data: bool = False) -> bool:
    """Whole-extended-block gate of the sharded apply (359-372): the local
    block extended by ``radius`` on every axis, its data term (3^D channels,
    or one diagonal plane with ``diag_data``) and the output."""
    if len(local_shape) < 2:
        return False
    ext = math.prod(n + 2 * radius for n in local_shape)
    n = math.prod(local_shape)
    channels = 1 if diag_data else 3 ** len(local_shape)
    return (ext + (channels + 1) * n) * 4 <= _VMEM_BUDGET_BYTES


def pick_stripe_ext(local_shape: tuple[int, ...], radius: int) -> int | None:
    """Axis-0 stripe of the striped sharded apply, or None (1262-1276; 2-D,
    radius ≤ 8)."""
    if len(local_shape) != 2 or radius > _H_EXT:
        return None
    n0, n1 = local_shape
    W = n1 + 2 * radius
    h = _H_EXT
    for T in (256, 128, 64, 32, 16, 8):
        if n0 % T or T % h:
            continue
        est = (2 * 9 * T * n1 + 2 * (T + 2 * h) * W + 4 * h * W) * 4
        if est <= _VMEM_BUDGET_BYTES:
            return T
    return None


def halo(ndim: int, radius: int = 3) -> int:
    """Halo rows above and below an axis-0 stripe (``_halo``, 196-203)."""
    if ndim <= 2:
        return 8
    return 2 if radius <= 2 else 4


def pick_stripe(shape: tuple[int, ...], radius: int = 3) -> int | None:
    """Axis-0 stripe of the striped apply, or None (206-225)."""
    if len(shape) < 2:
        return None
    rest = math.prod(shape[1:])
    channels = 3 ** len(shape)
    h = halo(len(shape), radius)
    cands = (256, 128, 64, 32, 16, 8) if len(shape) <= 2 else (16, 8, 4, 2)
    for T in cands:
        if shape[0] % T or T < h or T % h:
            continue
        est = (2 * channels * T + 4 * T + 6 * h) * rest * 4
        if est <= _VMEM_BUDGET_BYTES + 2 * 1024 * 1024:
            return T
    return None


def pick_stripe_smooth(shape: tuple[int, ...], radius: int,
                       sweeps: int) -> int | None:
    """Stripe of the 2-D multi-sweep smoother, or None (569-590)."""
    if len(shape) != 2 or sweeps * radius > _H_EXT:
        return None
    n0, n1 = shape
    h = _H_EXT
    for T in (64, 32, 16, 8):
        if n0 % T or T % h:
            continue
        E = T + 2 * h
        est = (13 * E + 2 * (12 * E + T) + T) * n1 * 4
        if est <= 14 * 1024 * 1024:
            return T
    return None


def pick_tile_smooth(shape: tuple[int, ...], radius: int, sweeps: int):
    """(T0, T1) of the 2-D tiled multi-sweep smoother, or None (781-806)."""
    if len(shape) != 2 or sweeps * radius > _H_EXT:
        return None
    n0, n1 = shape
    best = None
    best_amp = None
    for T0 in (128, 64, 32, 16, 8):
        if n0 % T0 or T0 % _H_EXT:
            continue
        for T1 in (1024, 512, 256, 128):
            if n1 % T1 or T1 % _W_EXT or n1 == T1:
                continue
            E0, E1 = T0 + 2 * _H_EXT, T1 + 2 * _W_EXT
            est = (13 + 24) * E0 * E1 * 4 + 2 * T0 * T1 * 4
            if est > 14 * 1024 * 1024:
                continue
            amp = (E0 * E1) / (T0 * T1)
            if best is None or amp < best_amp:
                best, best_amp = (T0, T1), amp
    return best


def pick_stripe2_3d(shape: tuple[int, ...]):
    """(T0, T1) of the two-axis 3-D apply, or None (1644-1657)."""
    if len(shape) != 3:
        return None
    n2 = shape[2]
    for T0 in (8, 4):
        for T1 in (64, 32, 16, 8):
            if shape[0] % T0 or shape[1] % T1 or T0 < _H0_3D or T1 < _H1_3D:
                continue
            est = (2 * 27 * T0 * T1 + 6 * (T0 + 2 * _H0_3D) * (T1 + 2 * _H1_3D)
                   ) * n2 * 4
            if est <= _VMEM_BUDGET_BYTES:
                return (T0, T1)
    return None


def pick_stripe2_3d_sweep(shape: tuple[int, ...]):
    """(T0, T1) of the 3-D diagonal-data sweep, or None (1793-1808)."""
    if len(shape) != 3:
        return None
    n2 = shape[2]
    for T0 in (16, 8, 4):
        for T1 in (64, 32, 16, 8):
            if shape[0] % T0 or shape[1] % T1 or T0 < _H0_3D or T1 < _H1_3D:
                continue
            E0, E1 = T0 + 2 * _H0_3D, T1 + 2 * _H1_3D
            est = (2 * (E0 * E1 + 4 * T0 * T1) + E0 * E1) * n2 * 4
            if est <= _VMEM_BUDGET_BYTES:
                return (T0, T1)
    return None


def pick_stripe_sweep_diag(shape: tuple[int, ...]) -> int | None:
    """Stripe of the 2-D diagonal-data sweep, or None (1939-1954)."""
    if len(shape) != 2:
        return None
    n1 = shape[1]
    h = _H_EXT
    for T in (256, 128, 64, 32, 16, 8):
        if shape[0] % T or T % h:
            continue
        E = T + 2 * h
        est = (2 * (E + 3 * T) + T) * n1 * 4
        if est <= _VMEM_BUDGET_BYTES:
            return T
    return None


def apply_plan(shape: tuple[int, ...], radius: int) -> str | None:
    """The reference kernel of a grid's operator apply (solver.py:213-227):
    the whole-array one inside the gate, else the axis-0 striped one, else
    (3-D) the two-axis one, else None (XLA). ``radius``: the operator radius
    (≥ 1). The port's one apply kernel stands in for all three."""
    if fits_vmem(shape):
        return "fused_normal_apply"
    if pick_stripe(shape, radius) is not None:
        return "fused_normal_apply_striped"
    if pick_stripe2_3d(shape) is not None:
        return "fused_normal_apply_striped2_3d"
    return None
