"""Plain reference of the SDF normal equations, for the benchmark's check.

Written from SPEC.md alone, in plain torch: it imports nothing of the
program. For each lane it works the rows out again from the lane's oriented
points (one value row ``f(p) = 0`` and one gradient row per axis
``∂f/∂x_a (p) = n_a``, multilinear over the sample's cell, scaled by
``data_pos`` / ``data_gradient``) and the smoothness rows (one row per
valid window of each active order along each axis, scaled by its weight),
and judges a field by the TRUE relative residual of the normal equations

    ‖Aᵀt − AᵀA x‖₂ / ‖Aᵀt‖₂

in float64, the stopping rule of SPEC.md's "Solve".

`solve` is the reference put in the program's place: CG on the same normal
equations, preconditioned by the exact inverse of the smoothness operator
plus a constant shift (each axis's operator diagonalised once on the host).
Only the control runs it (`control.py`), in a precision below the one the
configuration states: ``"tf32"`` rounds both inputs of every product of the
operator, the preconditioner and the CG updates to TF32's 10-bit mantissa
and adds in float32, as a TF32 matrix product does (the dot products stay
float32); ``"float32"`` and ``"float64"`` are plain.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

TAPS = {1: (-1.0, 1.0), 2: (1.0, -2.0, 1.0), 3: (-1.0, 3.0, -3.0, 1.0)}
PRECISIONS = {"float64": torch.float64, "float32": torch.float32, "tf32": torch.float32}


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """Float32 values rounded to the nearest TF32 value (10 mantissa bits;
    halves away from zero)."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _mul(precision: str):
    if precision == "tf32":
        def mul(a, b):
            a = round_tf32(a) if torch.is_tensor(a) else float(round_tf32(torch.tensor(a)))
            return a * round_tf32(b)
        return mul
    return lambda a, b: a * b


class Lanes:
    """The normal equations of a block of lanes: grid ``shape``, positions and
    normals [L, n, D], weights {"data_pos", "data_gradient", "model_k"}."""

    def __init__(self, shape, weights, positions, normals, precision="float64"):
        self.shape = tuple(int(s) for s in shape)
        self.ndim = len(self.shape)
        self.precision = precision
        self.dtype = PRECISIONS[precision]
        self.mul = _mul(precision)
        self.model = {k: float(weights.get(f"model_{k}", 0.0)) for k in range(4)}
        self.model = {k: w for k, w in self.model.items() if w != 0.0}
        pos = positions.to(torch.float64)
        self.L, self.n = pos.shape[:2]
        D, dev = self.ndim, pos.device
        ext = torch.tensor(self.shape, dtype=torch.float64, device=dev)
        inside = ((pos >= 0) & (pos <= ext - 1)).all(-1)                    # [L, n]
        cell = torch.minimum(torch.floor(pos).clamp_min(0), ext - 2)
        frac = pos - cell
        bits = torch.tensor(list(itertools.product((0, 1), repeat=D)),
                            dtype=torch.float64, device=dev)                  # [C, D]
        w1 = torch.where(bits.bool(), frac[..., None, :], 1 - frac[..., None, :])  # [L, n, C, D]
        value = w1.prod(-1)
        grads = []
        for a in range(D):
            others = torch.cat([w1[..., :a], w1[..., a + 1:]], -1).prod(-1)
            grads.append((2 * bits[:, a] - 1) * others)
        coef = torch.stack([value] + grads, -2)                               # [L, n, R, C]
        w_row = torch.tensor([float(weights.get("data_pos", 1.0))]
                             + [float(weights.get("data_gradient", 1.0))] * D,
                             dtype=torch.float64, device=dev)
        w_row = w_row * inside[..., None]                                     # [L, n, R]
        target = torch.cat([torch.zeros_like(pos[..., :1]), normals.to(torch.float64)], -1)
        strides = [math.prod(self.shape[d + 1:]) for d in range(D)]
        corner = (cell[..., None, :] + bits).long()                           # [L, n, C, D]
        self.idx = sum(corner[..., d] * strides[d] for d in range(D))         # [L, n, C]
        self.coef = coef.to(self.dtype)
        self.w2 = (w_row * w_row).to(self.dtype)
        self.target = target.to(self.dtype)

    # -- operators ---------------------------------------------------------
    def _smooth(self, x):
        """Σ over orders and axes of w² Bᵀ B x (valid windows only)."""
        mul, out = self.mul, torch.zeros_like(x)
        for order, w in self.model.items():
            if order == 0:
                out += mul(w * w, x)
                continue
            taps = TAPS[order]
            for a in range(self.ndim):
                ax = x.ndim - self.ndim + a
                m = x.shape[ax] - len(taps) + 1
                if m <= 0:
                    continue
                y = sum(mul(t, x.narrow(ax, k, m)) for k, t in enumerate(taps))
                y = mul(w * w, y)
                for k, t in enumerate(taps):
                    out.narrow(ax, k, m).add_(mul(t, y))
        return out

    def _rows(self, x):
        """Each sample's row values B x: [L, n, R]."""
        flat = x.reshape(self.L, -1)
        xc = torch.gather(flat, 1, self.idx.reshape(self.L, -1)).reshape(self.idx.shape)
        return self.mul(self.coef, xc[..., None, :]).sum(-1)

    def _scatter(self, e):
        """Bᵀ (w² e) for row values e [L, n, R]: [L, *shape]."""
        contrib = self.mul(self.coef, self.mul(self.w2, e)[..., None]).sum(-2)  # [L, n, C]
        out = torch.zeros(self.L, math.prod(self.shape), dtype=self.dtype,
                          device=contrib.device)
        out.scatter_add_(1, self.idx.reshape(self.L, -1), contrib.reshape(self.L, -1))
        return out.reshape((self.L,) + self.shape)

    def rhs(self):
        """Aᵀt [L, *shape]."""
        return self._scatter(self.target)

    def apply(self, x):
        """AᵀA x [L, *shape]."""
        return self._smooth(x) + self._scatter(self._rows(x))

    def residual(self, x):
        """Aᵀt − AᵀA x, computed from the rows' misfit."""
        return self._scatter(self.target - self._rows(x)) - self._smooth(x)


def _lane_norm(t):
    return torch.linalg.vector_norm(t.reshape(t.shape[0], -1), dim=1)


def true_rel_residual(shape, weights, positions, normals, fields, block=256):
    """Each lane's ‖Aᵀt − AᵀA x‖ / ‖Aᵀt‖ in float64 [L] (NaN or Inf in a
    field reads +Inf), in blocks of ``block`` lanes."""
    out = []
    for s in range(0, positions.shape[0], block):
        lanes = Lanes(shape, weights, positions[s:s + block], normals[s:s + block])
        x = fields[s:s + block].to(torch.float64)
        rel = _lane_norm(lanes.residual(x)) / _lane_norm(lanes.rhs())
        out.append(torch.where(torch.isfinite(rel), rel, torch.inf))
    return torch.cat(out)


# ------------------------------------------------------------- the solve

def _axis_operator(n, model):
    """The 1-D smoothness normal operator Σ_k w_k² Bᵀ B over n nodes."""
    K = np.zeros((n, n))
    for order, w in model.items():
        if order == 0:
            K += w * w * np.eye(n)
            continue
        taps = np.asarray(TAPS[order])
        for i in range(n - len(taps) + 1):
            row = np.zeros(n)
            row[i:i + len(taps)] = taps
            K += w * w * np.outer(row, row)
    return K


class _Precond:
    """z = (S + αI)⁻¹ r, S diagonalised axis by axis (S = Σ_a I⊗K_a⊗I)."""

    def __init__(self, lanes: Lanes, alpha: float, device):
        self.lanes = lanes
        lam_sum, self.Q = 0.0, []
        for a, n in enumerate(lanes.shape):
            lam, Q = np.linalg.eigh(_axis_operator(n, {k: w for k, w in lanes.model.items()
                                                        if k > 0}))
            view = [1] * lanes.ndim
            view[a] = n
            lam_sum = lam_sum + lam.reshape(view)
            self.Q.append(torch.as_tensor(Q, dtype=lanes.dtype, device=device))
        w0 = lanes.model.get(0, 0.0)
        self.inv = torch.as_tensor(1.0 / (lam_sum + w0 * w0 + alpha), dtype=lanes.dtype,
                                   device=device)

    def _transform(self, x, transpose):
        for a, Q in enumerate(self.Q):
            ax = x.ndim - self.lanes.ndim + a
            x = x.movedim(ax, -1)
            Qm = Q if transpose else Q.T          # x @ Q applies Qᵀ along the axis
            if self.lanes.precision == "tf32":
                x = round_tf32(x) @ round_tf32(Qm)
            else:
                x = x @ Qm
            x = x.movedim(-1, ax)
        return x

    def __call__(self, r):
        return self._transform(self.lanes.mul(self.inv, self._transform(r, True)), False)


def solve(lanes: Lanes, tol: float, maxiter: int = 2000):
    """Preconditioned CG on each lane's normal equations, from zero, to
    ‖r‖ ≤ tol·‖Aᵀt‖ by the recurrence (every lane on its own; a lane that
    stops is frozen). Returns (fields [L, *shape], converged [L])."""
    b = lanes.rhs()
    dev = b.device
    red = tuple(range(1, b.ndim))
    diag_data = lanes._scatter(torch.ones_like(lanes.target)).mean(red)  # mean data weight a node
    alpha = float(diag_data.mean()) if lanes.L else 0.0
    M = _Precond(lanes, alpha, dev)
    x = torch.zeros_like(b)
    r = b.clone()
    z = M(r)
    p = z.clone()
    rz = (r * z).sum(red)
    bb = (b * b).sum(red)
    tol2 = tol * tol * bb
    active = (r * r).sum(red) > tol2
    view = (-1,) + (1,) * lanes.ndim
    for _ in range(maxiter):
        if not bool(active.any()):
            break
        Ap = lanes.apply(p)
        pAp = (p * Ap).sum(red)
        alpha_k = torch.where(active & (pAp > 0), rz / pAp, torch.zeros_like(rz)).reshape(view)
        x = x + lanes.mul(alpha_k, p)
        r = r - lanes.mul(alpha_k, Ap)
        z = M(r)
        rz_new = (r * z).sum(red)
        beta = torch.where(active & (rz > 0), rz_new / rz, torch.zeros_like(rz)).reshape(view)
        p = torch.where(active.reshape(view), z + lanes.mul(beta, p), p)
        rz = torch.where(active, rz_new, rz)
        active = active & ((r * r).sum(red) > tol2)
    return x, ~active
