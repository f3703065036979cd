// The sharded apply for Hopper: (S + DᵀWD) z on one shard's block of a 2-D
// or 3-D grid, read from the block and r nodes of neighbour data around it,
// and in the same launch one of the distributed cycle's updates of it.
//
// Replaces two TPU kernels of field_interpolation_tpu/ops/pallas_stencil.py:
// fused_normal_apply_ext (378, pallas_call 462: the whole extended block in
// VMEM; 3^D-channel or diagonal data; 2-D and 3-D) and
// fused_normal_apply_ext_striped (1282, pallas_call 1387: a 2-D block too
// large for VMEM, striped along axis 0, whose axis-0 halos arrive as two
// separate slabs). The modes (out =) A z, r − A z, the Jacobi sweep
// z + τ·D⁻¹(r − A z) and the Chebyshev step z + c0·(z − z_prev) +
// c1·D⁻¹(r − A z) compute the reference's expressions of the distributed
// cycle (field_interpolation_tpu/parallel/sharded.py:611-640, :720) node by
// node, in its order and rounding (no contraction into FMAs).
//
// The smoothness windows are bounded by the node's GLOBAL coordinate and the
// GLOBAL extent (axis_normal of normal_apply.cuh, given g[d] + i and N[d]): a
// shard seam is interior, only the global edge drops rows, which is the
// reference's global window mask. The data term is NOT bounded by the block:
// across a seam a pair reads the halo, and where a pair leaves the global
// grid its coefficient is zero (the halo there holds zeros).
//
// Operands, read where they lie (no extended copy of the block is made):
// the block z itself, and per axis two halo slabs as the halo exchange
// delivers them, axis after axis with the corners filled by the later axis
// (a null slab reads zeros: a global edge, or an axis that is not sharded);
// or, for the reference's operand forms, the block extended in place
// (`x_halo`) and axis-0 slabs that carry the axis-1 halo (`slab0_halo`).
//
// What bounds it on the H100: memory. Per node the 3^D coefficient planes
// (36 B in 2-D, 108 B in 3-D) or one diagonal plane, z, and per mode r,
// D⁻¹ and z_prev, and the output: a 2048² 9-channel block moves ~185 MB
// (0.055 ms at 3.35 TB/s); a 1024² diagonal sweep ~21 MB. What the design
// does about it: one thread per node in gather form, coalesced along the
// minor axis, every plane read once. A node at least r from every face of
// the block that has a slab reads its neighbours from the block with plain
// strides, through L1/L2, as the whole-grid apply does; a node of that
// shell resolves each row it reads to the operand that holds it (block,
// slab, or zeros). A face with no slab is the global edge: nothing past it
// is read (the smoothness windows stop there, the data taps that would
// cross it are skipped), so it makes no shell. A first design staged a
// tile of z and its halo in shared memory per block of 64 × 32 (2-D) or
// 32 × 8 × 4 (3-D) nodes, 8 or 4 nodes a thread (and 4 or 2): it was
// slower on the device at every 3-D and every diagonal block, and no
// faster at the striped ones (PERF.md §6).
#include "normal_apply.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxHalo = 3;

// The modes of the launch (ops/stencil_ext.py:MODES).
enum Mode { kApply = 0, kResidual = 1, kJacobi = 2, kChebyshev = 3 };

}  // namespace

// One launch's arguments, filled by the host (ops/stencil_ext.py:_ExtArgs
// mirrors this layout field for field).
struct ExtArgs {
    const float* x;       // the block (x_halo: extended in place, see row2/row3)
    const float* lo[3];   // low-side halo slab of each axis, null: zeros
    const float* hi[3];   // high-side halo slab of each axis, null: zeros
    const float* coeff;   // [3^D, *local] channel-major, or [*local] when diag
    const float* r;       // residual and sweep modes
    const float* zp;      // Chebyshev: the previous iterate
    const float* inv_d;   // sweep modes: D⁻¹
    float* out;           // [*local]
    float w2[4];          // w_k² per smoothness order; 0 = order inactive
    float s0, s1;         // Jacobi: τ; Chebyshev: c0, c1
    int ndim, diag, mode, halo;
    int x_halo;           // 1: x is the block extended on every axis (3-D), or
                          //    along axis 1 (2-D); its row stride(s) xs0, xs1
    int slab0_halo;       // 2-D: 1 when the axis-0 slabs carry the axis-1 halo
                          //    ([r, n1 + 2r], exchanged after axis 1), 0 when
                          //    the axis-1 slabs carry the axis-0 halo ([n0 + 2r, r])
    int xs0, xs1;
    int n[3];             // local extents (n[2] = 1 in 2-D)
    int g[3];             // global coordinate of the block's first node
    int N[3];             // global extents
};

namespace {

// One staged row of the extended block: the pointers to its columns −r..−1
// (lft), 0..n−1 (mid) and n..n+r−1 (rgt) along the minor axis, each null
// where that part is zeros.
struct RowPtrs {
    const float* lft;
    const float* mid;
    const float* rgt;
};

__device__ __forceinline__ RowPtrs contiguous_row(const float* b, int r, int n) {
    return b ? RowPtrs{b, b + r, b + r + n} : RowPtrs{nullptr, nullptr, nullptr};
}

// Row e0 ∈ [−r, n0 + r) of a 2-D block.
__device__ __forceinline__ RowPtrs row2(const ExtArgs& a, int e0) {
    const int r = a.halo, n0 = a.n[0], n1 = a.n[1];
    if (e0 >= 0 && e0 < n0) {
        if (a.x_halo) return contiguous_row(a.x + static_cast<size_t>(e0) * a.xs0, r, n1);
        const size_t o = static_cast<size_t>(a.slab0_halo ? e0 : e0 + r) * r;
        return {a.lo[1] ? a.lo[1] + o : nullptr, a.x + static_cast<size_t>(e0) * n1,
                a.hi[1] ? a.hi[1] + o : nullptr};
    }
    const bool low = e0 < 0;
    const int j = low ? e0 + r : e0 - n0;
    const float* b = low ? a.lo[0] : a.hi[0];
    if (a.slab0_halo)
        return contiguous_row(b ? b + static_cast<size_t>(j) * (n1 + 2 * r) : nullptr, r, n1);
    const size_t o = static_cast<size_t>(e0 + r) * r;
    return {a.lo[1] ? a.lo[1] + o : nullptr, b ? b + static_cast<size_t>(j) * n1 : nullptr,
            a.hi[1] ? a.hi[1] + o : nullptr};
}

// Row (e0, e1) of a 3-D block, e0 ∈ [−r, n0 + r), e1 ∈ [−r, n1 + r). Slabs in
// exchange order: axis 0 [r, n1, n2], axis 1 [n0 + 2r, r, n2], axis 2
// [n0 + 2r, n1 + 2r, r]; x_halo: x is the extended block's first node.
__device__ __forceinline__ RowPtrs row3(const ExtArgs& a, int e0, int e1) {
    const int r = a.halo, n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
    if (a.x_halo)
        return contiguous_row(a.x + static_cast<size_t>(e0 + r) * a.xs0
                              + static_cast<size_t>(e1 + r) * a.xs1, r, n2);
    const float* mid = nullptr;
    if (e1 >= 0 && e1 < n1) {
        if (e0 >= 0 && e0 < n0) {
            mid = a.x + (static_cast<size_t>(e0) * n1 + e1) * n2;
        } else {
            const float* b = e0 < 0 ? a.lo[0] : a.hi[0];
            const int j = e0 < 0 ? e0 + r : e0 - n0;
            if (b) mid = b + (static_cast<size_t>(j) * n1 + e1) * n2;
        }
    } else {
        const float* b = e1 < 0 ? a.lo[1] : a.hi[1];
        const int j = e1 < 0 ? e1 + r : e1 - n1;
        if (b) mid = b + (static_cast<size_t>(e0 + r) * r + j) * n2;
    }
    const size_t o = (static_cast<size_t>(e0 + r) * (n1 + 2 * r) + (e1 + r)) * r;
    return {a.lo[2] ? a.lo[2] + o : nullptr, mid, a.hi[2] ? a.hi[2] + o : nullptr};
}

// The extended block's value at column c ∈ [−r, n + r) of a resolved row.
__device__ __forceinline__ float column(const RowPtrs& p, int c, int r, int n) {
    if (c < 0) return p.lft ? p.lft[c + r] : 0.f;
    if (c < n) return p.mid ? p.mid[c] : 0.f;
    return p.rgt ? p.rgt[c - n] : 0.f;
}

// The mode's output at one node from az = (A z)[node] and z = z[node].
template <int MODE>
__device__ __forceinline__ float finish(const ExtArgs& a, float az, float z, size_t node) {
    if (MODE == kApply) return az;
    const float res = __fsub_rn(a.r[node], az);
    if (MODE == kResidual) return res;
    if (MODE == kJacobi)
        return __fadd_rn(z, __fmul_rn(__fmul_rn(a.s0, a.inv_d[node]), res));
    const float t = __fadd_rn(z, __fmul_rn(a.s0, __fsub_rn(z, a.zp[node])));
    return __fadd_rn(t, __fmul_rn(__fmul_rn(a.s1, a.inv_d[node]), res));
}

// Σ over the D axes of (BᵀB z) for stencils of length L at x[f] (strides
// st[d]), global coordinates gi[d] in extents N[d].
template <int L, int D>
__device__ __forceinline__ float axes_strided(const ExtArgs& a, const float* x, int f,
                                              const int* gi, const int* st) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d) s += axis_normal<L>(x, f, gi[d], a.N[d], st[d]);
    return s;
}

// The same with z read through zd(d, k), the value k nodes along axis d.
template <int L, int D, class Z>
__device__ __forceinline__ float axes_resolved(const ExtArgs& a, const Z& zd, const int* gi) {
    float s = 0.f;
#pragma unroll
    for (int d = 0; d < D; ++d)
        s += axis_normal<L>([&](int k) { return zd(d, k); }, gi[d], a.N[d]);
    return s;
}

// S z at a node, in the reference's order of the sums: z read with
// strides (x, f, st), or through zd.
template <int D>
__device__ __forceinline__ float smooth_strided(const ExtArgs& a, const float* x, int f,
                                                const int* st, const int* gi, float z) {
    float out = a.w2[0] != 0.f ? a.w2[0] * z : 0.f;
    if (a.w2[1] != 0.f) out += a.w2[1] * axes_strided<2, D>(a, x, f, gi, st);
    if (a.w2[2] != 0.f) out += a.w2[2] * axes_strided<3, D>(a, x, f, gi, st);
    if (a.w2[3] != 0.f) out += a.w2[3] * axes_strided<4, D>(a, x, f, gi, st);
    return out;
}

template <int D, class Z>
__device__ __forceinline__ float smooth_resolved(const ExtArgs& a, const Z& zd, const int* gi,
                                                 float z) {
    float out = a.w2[0] != 0.f ? a.w2[0] * z : 0.f;
    if (a.w2[1] != 0.f) out += a.w2[1] * axes_resolved<2, D>(a, zd, gi);
    if (a.w2[2] != 0.f) out += a.w2[2] * axes_resolved<3, D>(a, zd, gi);
    if (a.w2[3] != 0.f) out += a.w2[3] * axes_resolved<4, D>(a, zd, gi);
    return out;
}

constexpr int kWarp = 32, kRows = kThreads / kWarp;

// Whether a node reads only the block itself along axis d: r nodes from
// both faces, or a face with no slab (past it lies the global edge, where
// the smoothness windows stop and the data taps are skipped).
__device__ __forceinline__ bool inside(const ExtArgs& a, int d, int i, int r) {
    return (i >= r || !a.lo[d]) && (i + r < a.n[d] || !a.hi[d]);
}

// One thread per node (i0, i1); warps along the minor axis. The 9-channel
// form is held to 8 blocks an SM (32 registers; the face nodes' rows spill
// to the stack): on the H100 that took its 2048² block from 0.0760 to 0.0658
// ms of device time, while the diagonal form and the 3-D forms lost with
// the same bound (ext_probe.py, PERF.md §6).
template <int DIAG, int MODE>
__global__ void __launch_bounds__(kThreads, DIAG ? 1 : 8) ext_level_2d(ExtArgs a) {
    const int i1 = blockIdx.x * kWarp + threadIdx.x % kWarp;
    const int i0 = blockIdx.y * kRows + threadIdx.x / kWarp;
    const int r = a.halo, n0 = a.n[0], n1 = a.n[1];
    if (i0 >= n0 || i1 >= n1) return;
    const size_t node = static_cast<size_t>(i0) * n1 + i1, N = static_cast<size_t>(n0) * n1;
    const int gi[2] = {a.g[0] + i0, a.g[1] + i1};
    const float* c = a.coeff + node;
    float z, az;
    if (inside(a, 0, i0, r) && (a.x_halo || inside(a, 1, i1, r))) {
        // Every tap in the block (or the column halo x carries in place):
        // strided reads; data taps past a global edge skipped.
        const int st[2] = {a.x_halo ? a.xs0 : n1, 1};
        const float* x = a.x + (a.x_halo ? r : 0);
        const int f = i0 * st[0] + i1;
        z = x[f];
        az = smooth_strided<2>(a, x, f, st, gi, z);
        if (DIAG) {
            az += c[0] * z;
        } else {
            // Which of the 3 × 3 box's rows and columns lie in the block.
            const bool lo[2] = {i0 > 0, a.x_halo || i1 > 0};
            const bool hi[2] = {i0 + 1 < n0, a.x_halo || i1 + 1 < n1};
#pragma unroll
            for (int o = 0; o < 9; ++o) {
                const int d0 = o / 3 - 1, d1 = o % 3 - 1;
                const bool in = (d0 >= 0 || lo[0]) && (d0 <= 0 || hi[0]) && (d1 >= 0 || lo[1])
                                && (d1 <= 0 || hi[1]);
                // A predicated load, not a branch: the taps' loads stay in flight together.
                az += c[o * N] * (in ? x[f + d0 * st[0] + d1] : 0.f);
            }
        }
    } else {
        // Rows i0 − r .. i0 + r, each resolved once, at indices fixed when
        // the taps unroll.
        RowPtrs rows[2 * kMaxHalo + 1];
#pragma unroll
        for (int k = -kMaxHalo; k <= kMaxHalo; ++k)
            if (k >= -r && k <= r) rows[kMaxHalo + k] = row2(a, i0 + k);
        const auto at = [&](int d0, int d1) {
            return column(rows[kMaxHalo + d0], i1 + d1, r, n1);
        };
        const auto zd = [&](int d, int k) { return d == 0 ? at(k, 0) : at(0, k); };
        z = at(0, 0);
        az = smooth_resolved<2>(a, zd, gi, z);
        if (DIAG) {
            az += c[0] * z;
        } else {
#pragma unroll
            for (int o = 0; o < 9; ++o) az += c[o * N] * at(o / 3 - 1, o % 3 - 1);
        }
    }
    a.out[node] = finish<MODE>(a, az, z, node);
}

// One thread per node (i0, i1, i2); warps along axis 2, blockIdx.z = i0.
// Node indices are 32-bit; channel offsets o·N are 64-bit (27·N passes 2³¹).
// At most 64 registers (4 blocks an SM): the face nodes' path is the
// longest and may spill; the strided path needs ~60.
template <int DIAG, int MODE>
__global__ void __launch_bounds__(kThreads, 4) ext_level_3d(ExtArgs a) {
    const int i2 = blockIdx.x * kWarp + threadIdx.x % kWarp;
    const int i1 = blockIdx.y * kRows + threadIdx.x / kWarp, i0 = blockIdx.z;
    const int r = a.halo, n0 = a.n[0], n1 = a.n[1], n2 = a.n[2];
    if (i1 >= n1 || i2 >= n2) return;
    const size_t node = (static_cast<size_t>(i0) * n1 + i1) * n2 + i2;
    const size_t N = static_cast<size_t>(n0) * n1 * n2;
    const int gi[3] = {a.g[0] + i0, a.g[1] + i1, a.g[2] + i2};
    const float* c = a.coeff + node;
    // x's strides: the extended block's (x_halo) or the block's.
    const int st[3] = {a.x_halo ? a.xs0 : n1 * n2, a.x_halo ? a.xs1 : n2, 1};
    const int f = a.x_halo ? (i0 + r) * st[0] + (i1 + r) * st[1] + i2 + r
                           : static_cast<int>(node);
    float z, az;
    if (a.x_halo || (inside(a, 0, i0, r) && inside(a, 1, i1, r) && inside(a, 2, i2, r))) {
        // Every tap in the block (or in the extended block x is): strided
        // reads; data taps past a global edge skipped.
        z = a.x[f];
        az = smooth_strided<3>(a, a.x, f, st, gi, z);
        if (DIAG) {
            az += c[0] * z;
        } else {
            // Which of the 3 × 3 × 3 box's planes lie in the block.
            const bool lo[3] = {a.x_halo || i0 > 0, a.x_halo || i1 > 0, a.x_halo || i2 > 0};
            const bool hi[3] = {a.x_halo || i0 + 1 < n0, a.x_halo || i1 + 1 < n1,
                                a.x_halo || i2 + 1 < n2};
#pragma unroll
            for (int o = 0; o < 27; ++o) {
                const int d[3] = {o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1};
                const bool in = (d[0] >= 0 || lo[0]) && (d[0] <= 0 || hi[0])
                                && (d[1] >= 0 || lo[1]) && (d[1] <= 0 || hi[1])
                                && (d[2] >= 0 || lo[2]) && (d[2] <= 0 || hi[2]);
                // A predicated load, not a branch: the taps' loads stay in flight together.
                az += c[o * N] * (in ? a.x[f + d[0] * st[0] + d[1] * st[1] + d[2]] : 0.f);
            }
        }
    } else {
        // A tap in the block reads it with strides; one past a face resolves
        // its row to the slab (or zeros) that holds it.
        const auto at = [&](int d0, int d1, int d2) {
            const int j0 = i0 + d0, j1 = i1 + d1, j2 = i2 + d2;
            if (j0 >= 0 && j0 < n0 && j1 >= 0 && j1 < n1 && j2 >= 0 && j2 < n2)
                return a.x[f + d0 * st[0] + d1 * st[1] + d2];
            return column(row3(a, j0, j1), j2, r, n2);
        };
        const auto zd = [&](int d, int k) {
            return d == 0 ? at(k, 0, 0) : (d == 1 ? at(0, k, 0) : at(0, 0, k));
        };
        z = a.x[f];
        az = smooth_resolved<3>(a, zd, gi, z);
        if (DIAG) {
            az += c[0] * z;
        } else {
#pragma unroll
            for (int o = 0; o < 27; ++o)
                az += c[o * N] * at(o / 9 - 1, (o / 3) % 3 - 1, o % 3 - 1);
        }
    }
    a.out[node] = finish<MODE>(a, az, z, node);
}

template <int DIAG, int MODE>
void launch(const ExtArgs& a, cudaStream_t s) {
    if (a.ndim == 2) {
        const dim3 grid((a.n[1] + kWarp - 1) / kWarp, (a.n[0] + kRows - 1) / kRows);
        ext_level_2d<DIAG, MODE><<<grid, kThreads, 0, s>>>(a);
    } else {
        const dim3 grid((a.n[2] + kWarp - 1) / kWarp, (a.n[1] + kRows - 1) / kRows, a.n[0]);
        ext_level_3d<DIAG, MODE><<<grid, kThreads, 0, s>>>(a);
    }
}

template <int DIAG>
void launch_mode(const ExtArgs& a, cudaStream_t s) {
    switch (a.mode) {
        case kApply: launch<DIAG, kApply>(a, s); break;
        case kResidual: launch<DIAG, kResidual>(a, s); break;
        case kJacobi: launch<DIAG, kJacobi>(a, s); break;
        default: launch<DIAG, kChebyshev>(a, s); break;
    }
}

int run(const ExtArgs& a, void* stream) {
    if ((a.ndim != 2 && a.ndim != 3) || a.halo < 1 || a.halo > kMaxHalo || a.mode < kApply
        || a.mode > kChebyshev || (a.ndim == 2 ? a.n[0] / kRows : a.n[0]) >= 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (a.diag)
        launch_mode<1>(a, s);
    else
        launch_mode<0>(a, s);
    return static_cast<int>(cudaGetLastError());
}

ExtArgs apply_args(const float* x, const float* coeff, float* out, int ndim, int n0, int n1,
                   int n2, int g0, int g1, int g2, int N0, int N1, int N2, int r, float w2_0,
                   float w2_1, float w2_2, float w2_3, int diag) {
    const bool three = ndim == 3;
    ExtArgs a{};
    a.x = x;
    a.coeff = coeff;
    a.out = out;
    a.w2[0] = w2_0, a.w2[1] = w2_1, a.w2[2] = w2_2, a.w2[3] = w2_3;
    a.ndim = ndim, a.diag = diag, a.mode = kApply, a.halo = r, a.x_halo = 1;
    a.n[0] = n0, a.n[1] = n1, a.n[2] = three ? n2 : 1;
    a.g[0] = g0, a.g[1] = g1, a.g[2] = three ? g2 : 0;
    a.N[0] = N0, a.N[1] = N1, a.N[2] = three ? N2 : 1;
    return a;
}

}  // namespace

// One launch of any form and mode (ops/stencil_ext.py:ExtLevel).
extern "C" int fi_ext_level(const ExtArgs* a, void* stream) { return run(*a, stream); }

// The reference's whole operand form: x_ext [*(local + 2r)], coeff [3^D,
// *local] or [*local] (diag), out [*local]. ndim 2: (n0, n1), (g0, g1), (N0,
// N1); the third of each is ignored.
extern "C" int fi_normal_apply_ext(const float* x_ext, const float* coeff, float* out,
                                   int ndim, int n0, int n1, int n2, int g0, int g1,
                                   int g2, int N0, int N1, int N2, int r, float w2_0,
                                   float w2_1, float w2_2, float w2_3, int diag,
                                   void* stream) {
    ExtArgs a = apply_args(x_ext, coeff, out, ndim, n0, n1, n2, g0, g1, g2, N0, N1, N2, r,
                           w2_0, w2_1, w2_2, w2_3, diag);
    if (ndim == 2) {  // rows of the block at x + i0·W, its axis-0 halo rows around them
        const int W = n1 + 2 * r;
        a.xs0 = W, a.slab0_halo = 1;
        a.x = x_ext + static_cast<size_t>(r) * W;
        a.lo[0] = x_ext;
        a.hi[0] = x_ext + static_cast<size_t>(n0 + r) * W;
    } else {
        a.xs1 = n2 + 2 * r;
        a.xs0 = (n1 + 2 * r) * a.xs1;
    }
    return run(a, stream);
}

// The reference's striped operand form: x_ext1 [n0, n1 + 2r], from_top /
// from_bot [r, n1 + 2r], coeff [9, n0, n1].
extern "C" int fi_normal_apply_ext_striped(const float* x_ext1, const float* from_top,
                                           const float* from_bot, const float* coeff,
                                           float* out, int n0, int n1, int g0, int g1,
                                           int N0, int N1, int r, float w2_0, float w2_1,
                                           float w2_2, float w2_3, void* stream) {
    ExtArgs a = apply_args(x_ext1, coeff, out, 2, n0, n1, 1, g0, g1, 0, N0, N1, 1, r, w2_0,
                           w2_1, w2_2, w2_3, 0);
    a.xs0 = n1 + 2 * r, a.slab0_halo = 1;
    a.lo[0] = from_top;
    a.hi[0] = from_bot;
    return run(a, stream);
}
