// The normal operator (S + DᵀWD) x at one node of a 2-D or 3-D grid, shared
// by the apply kernel (normal_apply.cu), the smoothing kernels
// (jacobi_sweep.cu and jacobi_multisweep2d.cu, on shared-memory tiles) and
// the PCG segment and cycle kernels (pcg_segment.cu, mg_cycle2d.cuh; 2-D).
//
// Gather form of field_interpolation_tpu/ops/pallas_stencil.py:_kernel_body
// (lines 104-166): the TPU kernel scatters each window's contribution into
// the output with static slices; here one thread owns one output node and
// gathers what lands on it, so no two threads write the same address.
#pragma once

#include <cuda_runtime.h>

struct ApplyOp {
    const float* coeff;  // [3^D, *grid] channel-major data stencil, or [*grid] when diag
    int n0, n1;
    int diag;            // 1: the data term is the diagonal plane coeff[*grid]
    float w2[4];         // w_k² per smoothness order; 0 = order inactive
    int n2;              // third extent (3-D grids only; last, so the 2-D layout is unchanged)
};

// STENCIL_TAPS of stencils.py, tap k of an order-(L-1) stencil.
template <int L>
__device__ __forceinline__ float stencil_tap(int k) {
    if (L == 2) return k == 0 ? -1.f : 1.f;
    if (L == 3) return k == 1 ? -2.f : 1.f;
    return k == 0 ? -1.f : (k == 1 ? 3.f : (k == 2 ? -3.f : 1.f));  // L == 4
}

// (BᵀB x)[i] along one axis of length n, for the node at flat index `flat`
// whose coordinate on that axis is i and whose flat stride there is st:
//   Σ_{k : 0 ≤ i−k < m} s_k · y[i−k],   y[j] = Σ_l s_l · x[j+l],   m = n−L+1.
// The window bounds ARE the reference's dropped-row boundary policy.
template <int L>
__device__ __forceinline__ float axis_normal(const float* __restrict__ x,
                                             int flat, int i, int n, int st) {
    const int m = n - L + 1;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const int j = i - k;
        if (j < 0 || j >= m) continue;
        const float* xj = x + (flat - k * st);
        float y = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) y += stencil_tap<L>(l) * xj[l * st];
        acc += stencil_tap<L>(k) * y;
    }
    return acc;
}

// The same windows with x read through x(d), the value d nodes along the
// axis from the node (registers, or rows taken from several arrays). A loop
// of its own: the array form above, written as a call of this one, made
// the 3-D apply kernel about a fifth slower on the H100.
template <int L, class X>
__device__ __forceinline__ float axis_normal(X x, int i, int n) {
    const int m = n - L + 1;
    float acc = 0.f;
#pragma unroll
    for (int k = 0; k < L; ++k) {
        const int j = i - k;
        if (j < 0 || j >= m) continue;
        float y = 0.f;
#pragma unroll
        for (int l = 0; l < L; ++l) y += stencil_tap<L>(l) * x(l - k);
        acc += stencil_tap<L>(k) * y;
    }
    return acc;
}

// The smoothness part S x = Σ_orders w² Σ_axes BᵀB x (+ w0² x) at node
// (i0, i1) of an n0 × n1 grid. x is addressed around x[flat] with row stride
// st0: the grid's own (st0 = n1) or a shared-memory tile's. The windows are
// bounded by the node's GLOBAL index and extent, so a tile edge inside the
// grid is not a boundary.
__device__ __forceinline__ float smooth_at(const float* w2,
                                           const float* __restrict__ x, int flat,
                                           int i0, int i1, int n0, int n1,
                                           int st0) {
    float out = w2[0] != 0.f ? w2[0] * x[flat] : 0.f;
    if (w2[1] != 0.f)
        out += w2[1] * (axis_normal<2>(x, flat, i0, n0, st0)
                        + axis_normal<2>(x, flat, i1, n1, 1));
    if (w2[2] != 0.f)
        out += w2[2] * (axis_normal<3>(x, flat, i0, n0, st0)
                        + axis_normal<3>(x, flat, i1, n1, 1));
    if (w2[3] != 0.f)
        out += w2[3] * (axis_normal<4>(x, flat, i0, n0, st0)
                        + axis_normal<4>(x, flat, i1, n1, 1));
    return out;
}

// The 9-channel data term Σ_o c(o) · x[i + o] over the 3×3 box at node
// (i0, i1), offsets in constraints.offset_list C-order, x addressed as in
// smooth_at; pairs leaving the grid carry c = 0 and are skipped. c(o) gives
// the node's coefficient of channel o (from global memory or registers).
template <class Coeff>
__device__ __forceinline__ float data_at(Coeff c, const float* __restrict__ x,
                                         int flat, int i0, int i1, int n0, int n1,
                                         int st0) {
    float out = 0.f;
#pragma unroll
    for (int o = 0; o < 9; ++o) {
        const int d0 = o / 3 - 1, d1 = o % 3 - 1;
        const int j0 = i0 + d0, j1 = i1 + d1;
        if (j0 < 0 || j0 >= n0 || j1 < 0 || j1 >= n1) continue;
        out += c(o) * x[flat + d0 * st0 + d1];
    }
    return out;
}

// (A x) at node (i0, i1) for A = S + data, S = Σ_orders w² Σ_axes BᵀB (+ w0² I),
// x addressed around x[flat] with row stride st0 (the grid's own or a
// shared-memory tile's, as in smooth_at); g is the node's index in the grid,
// where its coefficients sit. 32-bit channel offsets: 9·N < 2³¹ (the
// wrappers check it).
__device__ __forceinline__ float apply_at(const ApplyOp& op,
                                          const float* __restrict__ x, int flat,
                                          int st0, int g, int i0, int i1) {
    const int n0 = op.n0, n1 = op.n1;
    const float out = smooth_at(op.w2, x, flat, i0, i1, n0, n1, st0);
    if (op.diag) return out + op.coeff[g] * x[flat];
    const float* c = op.coeff + g;
    const int N = n0 * n1;
    return out + data_at([&](int o) { return c[o * N]; }, x, flat, i0, i1, n0, n1, st0);
}

// (A x)[i0, i1], x the whole grid.
__device__ __forceinline__ float apply_at(const ApplyOp& op,
                                          const float* __restrict__ x,
                                          int i0, int i1) {
    const int flat = i0 * op.n1 + i1;
    return apply_at(op, x, flat, op.n1, flat, i0, i1);
}

// (A x) at node (i0, i1, i2) of a 3-D grid (C order), x addressed around
// x[flat] with strides st0, st1 and 1 (the grid's own or a shared-memory
// tile's); g is the node's index in the grid. Node indices are 32-bit
// (N < 2³¹); channel offsets o·N are 64-bit, since 27·N passes 2³¹ from
// 430³ on.
__device__ __forceinline__ float apply_at(const ApplyOp& op,
                                          const float* __restrict__ x, int flat,
                                          int st0, int st1, int g, int i0, int i1,
                                          int i2) {
    const int n0 = op.n0, n1 = op.n1, n2 = op.n2;
    const float xc = x[flat];
    float out = op.w2[0] != 0.f ? op.w2[0] * xc : 0.f;
    if (op.w2[1] != 0.f)
        out += op.w2[1] * (axis_normal<2>(x, flat, i0, n0, st0)
                           + axis_normal<2>(x, flat, i1, n1, st1)
                           + axis_normal<2>(x, flat, i2, n2, 1));
    if (op.w2[2] != 0.f)
        out += op.w2[2] * (axis_normal<3>(x, flat, i0, n0, st0)
                           + axis_normal<3>(x, flat, i1, n1, st1)
                           + axis_normal<3>(x, flat, i2, n2, 1));
    if (op.w2[3] != 0.f)
        out += op.w2[3] * (axis_normal<4>(x, flat, i0, n0, st0)
                           + axis_normal<4>(x, flat, i1, n1, st1)
                           + axis_normal<4>(x, flat, i2, n2, 1));
    if (op.diag) return out + op.coeff[g] * xc;
    // Data term over the 3×3×3 box, channel o = 9·(d0+1) + 3·(d1+1) + (d2+1)
    // (constraints.offset_list(3) C-order).
    const long long N = static_cast<long long>(n0) * n1 * n2;
    const float* c = op.coeff + g;
#pragma unroll
    for (int o = 0; o < 27; ++o) {
        const int d0 = o / 9 - 1, d1 = (o / 3) % 3 - 1, d2 = o % 3 - 1;
        const int j0 = i0 + d0, j1 = i1 + d1, j2 = i2 + d2;
        if (j0 < 0 || j0 >= n0 || j1 < 0 || j1 >= n1 || j2 < 0 || j2 >= n2) continue;
        out += c[o * N] * x[flat + d0 * st0 + d1 * st1 + d2];
    }
    return out;
}

// (A x)[i0, i1, i2], x the whole grid.
__device__ __forceinline__ float apply_at(const ApplyOp& op,
                                          const float* __restrict__ x,
                                          int i0, int i1, int i2) {
    const int s0 = op.n1 * op.n2;
    const int flat = i0 * s0 + i1 * op.n2 + i2;
    return apply_at(op, x, flat, s0, op.n2, flat, i0, i1, i2);
}
