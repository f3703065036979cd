// One lane of the batched PCG segment (pcg_segment.cu:pcg_segment_batch_kernel):
// fused_pcg_solve on one field, run by one block of T threads with block
// barriers, for BASELINE config 3 (1024 fields of 128²). The same segment
// and cycle as mg_cycle2d.cuh's (damped-Jacobi or Chebyshev smoothing, V or
// W, lumped or Galerkin coarse levels, the dense coarsest solve), with
// phase bodies of its own for one block: the single-field kernels keep
// mg_cycle2d.cuh's.
//
// What the body does against one block's latency:
// - a work item is a run of kRun = 4 consecutive nodes along axis 1, so a
//   thread issues the loads of four nodes (16-byte loads where the level's
//   rows and arrays are 16-byte aligned) before it uses any, and divides
//   once per run;
// - the operator reads x from a window around the run held in registers
//   (16-byte loads away from the grid's edge, guarded loads near it), every
//   load of the window and the run's data planes issued before any is used,
//   with normal_apply.cuh:apply_at's arithmetic node by node;
// - level 0's data term is zero but at the corners of cells that hold a
//   point (~6% of config 3's runs), so a run mask in shared memory, built
//   once a launch, lets each level-0 apply load the nine data planes and do
//   their multiply-adds only at the runs that hold data (a warp whose 32
//   runs hold none skips them); the bits are the same;
// - the transfers' bands and weights sit in shared memory (built once per
//   launch), and so do the vectors, D⁻¹ and data of the coarse levels that
//   fit the block's share (the host's plan), and level 0's residual;
// - a dot product sums in the order of a 1024-thread block at every width
//   (Dot), so a lane's bits do not depend on its geometry or its batch,
//   and is read after the barrier that ends its phase: no barriers of its
//   own;
// - level 0's first pre-sweep from zero is pointwise (c2·sid·r), so it is
//   done by the phase that writes r (the start, and CG's x/r update), not
//   by a phase of its own.
#pragma once

#include "mg_cycle2d.cuh"

namespace lane2d {

using mg2d::Cycle;
using mg2d::kMaxLevels;
using mg2d::Level;
using mg2d::nodes;
using mg2d::other;

constexpr int kRun = 4;        // nodes per work item, along axis 1
constexpr int kSpanR = 4;      // restriction: fine indices per coarse index and axis
constexpr int kSpanP = 2;      // prolongation: coarse indices per fine index and axis
enum Slot { kPAp = 0, kRR = 1, kRZ = 2, kSlots = 3 };

template <int V>
struct IC {
    static constexpr int value = V;
};

struct Bands {       // one axis of one transfer, in shared memory
    int* rs;         // [nc] restriction row j: first fine index
    int* rc;         // [nc] its span (≤ kSpanR)
    float* rw;       // [nc, kSpanR] R[j, rs[j] + b]
    int* ps;         // [nf] prolongation row i: first coarse index
    int* pc;         // [nf] its span (≤ kSpanP)
    float* pw;       // [nf, kSpanP] R[ps[i] + a, i]
};

// What a lane holds in static shared memory.
struct Lane {
    Cycle cyc;                       // the lane's pointers; some point into shared memory
    Bands bands[kMaxLevels - 1][2];
    int vec[kMaxLevels];             // 1: n1 % 4 == 0 and the level's arrays 16-byte aligned
    int reach[kMaxLevels];           // 1..3: the widest active smoothness order
    const float* x_in;
    const float* r_in;
    float* x;
    float* p;
    int* iters_out;
    float* rr_out;
    unsigned* mask;                  // level 0's run mask (mark_runs)
    int runs;                        // its set bits
    int* runs_out;
    float tol2;
    int budget;
    float red[kSlots][32];           // virtual warp sums of the dot products
};

// ------------------------------------------------------ shared-memory plan

__host__ __device__ __forceinline__ int round4(int w) { return (w + 3) & ~3; }
__host__ __device__ __forceinline__ int band_words(int nf, int nc) {
    return 2 * round4(nc) + nc * kSpanR + 2 * round4(nf) + nf * kSpanP;
}
__host__ __device__ __forceinline__ int level_words(const Level& lv) {
    const int n = nodes(lv);
    return 5 * round4(n) + round4(lv.op.diag ? n : 9 * n);
}
__host__ __device__ __forceinline__ int runs_per_row(int n1) { return (n1 + kRun - 1) / kRun; }
// Level 0's run mask: bit q is run q of for_runs' order (row-major).
__host__ __device__ __forceinline__ int mask_words(const Level& lv) {
    return round4((lv.op.n0 * runs_per_row(lv.op.n1) + 31) / 32);
}

// Offsets (in floats) into the dynamic shared memory: the bands of every
// transfer, level 0's run mask, then each planned coarse level (r, za, zb,
// az, sid, data), then level 0's residual buffer when planned. The host
// sizes the launch with it, the kernel places its arrays with it.
struct Layout {
    int band[kMaxLevels - 1][2];
    int mask;
    int level[kMaxLevels];   // -1: in global memory
    int az0;                 // -1: in global memory
    int words;
};

__host__ __device__ inline Layout plan_layout(const Cycle& c, unsigned smem_levels, int az0) {
    Layout o{};
    int w = 0;
    for (int t = 0; t < c.L - 1; ++t) {
        const ApplyOp& f = c.lv[t].op;
        const ApplyOp& k = c.lv[t + 1].op;
        o.band[t][0] = w;
        w += band_words(f.n0, k.n0);
        o.band[t][1] = w;
        w += band_words(f.n1, k.n1);
    }
    o.mask = w;
    w += mask_words(c.lv[0]);
    for (int l = 0; l < c.L; ++l) {
        o.level[l] = -1;
        if (l > 0 && ((smem_levels >> l) & 1u)) {
            o.level[l] = w;
            w += level_words(c.lv[l]);
        }
    }
    o.az0 = -1;
    if (az0) {
        o.az0 = w;
        w += round4(nodes(c.lv[0]));
    }
    o.words = w;
    return o;
}

// --------------------------------------------------------------- loads

__device__ __forceinline__ float4 ld4(const float* __restrict__ p, int i, bool vec, int cnt) {
    if (vec) return *reinterpret_cast<const float4*>(p + i);
    float4 v;
    v.x = p[i];
    v.y = cnt > 1 ? p[i + 1] : 0.f;
    v.z = cnt > 2 ? p[i + 2] : 0.f;
    v.w = cnt > 3 ? p[i + 3] : 0.f;
    return v;
}
__device__ __forceinline__ void st4(float* __restrict__ p, int i, bool vec, int cnt, float4 v) {
    if (vec) {
        *reinterpret_cast<float4*>(p + i) = v;
        return;
    }
    p[i] = v.x;
    if (cnt > 1) p[i + 1] = v.y;
    if (cnt > 2) p[i + 2] = v.z;
    if (cnt > 3) p[i + 3] = v.w;
}
__device__ __forceinline__ float& at(float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}
__device__ __forceinline__ float at(const float4& v, int k) {
    return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// ---------------------------------------------------------- dot products

// A dot product over level 0 sums in the order of a block of kVirt = 1024
// threads, whatever the block's T, so that a lane's bits do not depend on
// its geometry (nor on the batch's size, which picks it): run q belongs to
// virtual thread q % 1024, which adds its runs in turn, node by node; each
// virtual warp is one shuffle tree; the 32 warp sums are added in order.
// A thread of a narrower block takes runs t, t + T, ..., so its k-th run
// belongs to virtual thread t + T·(k % V): it keeps V = 1024 / T sums,
// rotated after each run so that the current one is always a[0].
constexpr int kVirt = 1024;

template <int T>
struct Dot {
    static constexpr int V = kVirt / T;
    float a[V];
    int n = 0;  // runs taken
    __device__ __forceinline__ Dot() {
#pragma unroll
        for (int v = 0; v < V; ++v) a[v] = 0.f;
    }
    __device__ __forceinline__ float& cur() { return a[0]; }
    __device__ __forceinline__ void next() {  // after each run
        const float first = a[0];
#pragma unroll
        for (int v = 0; v + 1 < V; ++v) a[v] = a[v + 1];
        a[V - 1] = first;
        ++n;
    }
    // The sum of virtual thread threadIdx.x + T·v: after n rotations a[i]
    // holds virtual thread (n + i) % V's.
    __device__ __forceinline__ float of(int v) const {
        float out = a[0];
#pragma unroll
        for (int i = 1; i < V; ++i)
            if (((n + i) & (V - 1)) == v) out = a[i];
        return out;
    }
};

// This thread's sums of a dot product into red[s] (one shuffle tree per
// virtual warp, lane 0 writes); every thread reads the total after the
// next barrier with total(), summing the 32 virtual warps in order.
template <int T>
__device__ __forceinline__ void put(Lane& L, int s, const Dot<T>& d) {
#pragma unroll
    for (int v = 0; v < Dot<T>::V; ++v) {
        float x = d.of(v);
        for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
        if ((threadIdx.x & 31) == 0) L.red[s][(threadIdx.x >> 5) + v * (T / 32)] = x;
    }
}
__device__ __forceinline__ float total(const Lane& L, int s) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kVirt / 32; ++w) t += L.red[s][w];
    return t;
}

// ------------------------------------------------------------- the runs

// f(i0, j, base, cnt, inner) for every run of the level: row i0, columns
// j..j+cnt-1 (base = i0·n1 + j); inner: the run's stencil of reach R stays
// in the grid (and j ≥ 4, j + 8 ≤ n1, so a 12-column window around it does).
template <int T, class F>
__device__ __forceinline__ void for_runs(const ApplyOp& op, int R, F f) {
    const int n0 = op.n0, n1 = op.n1;
    const int rpr = (n1 + kRun - 1) / kRun;
    const int runs = n0 * rpr;
    for (int q = threadIdx.x; q < runs; q += T) {
        const int i0 = q / rpr;
        const int j = (q - i0 * rpr) * kRun;
        const bool inner = i0 >= R && i0 + R < n0 && j >= 4 && j + 8 <= n1;
        f(i0, j, i0 * n1 + j, min(kRun, n1 - j), inner);
    }
}

// x at (i0 + d0, j + c) of a run's window, 0 outside the grid (a value the
// window bounds never use).
__device__ __forceinline__ float ld_in(const float* __restrict__ x, int base, int i0, int j,
                                       int d0, int c, int n0, int n1) {
    const int r = i0 + d0, col = j + c;
    return (r >= 0 && r < n0 && col >= 0 && col < n1) ? x[base + d0 * n1 + c] : 0.f;
}
__device__ __forceinline__ float4 ld4_in(const float* __restrict__ x, int base, int i0, int j,
                                         int d0, int n0, int n1) {
    return make_float4(ld_in(x, base, i0, j, d0, 0, n0, n1), ld_in(x, base, i0, j, d0, 1, n0, n1),
                       ld_in(x, base, i0, j, d0, 2, n0, n1), ld_in(x, base, i0, j, d0, 3, n0, n1));
}

// (A x) on the run at (i0, j..j+cnt-1) with reach R (the window's rows
// i0 ± R) and diagonal (D) or 9-channel data; xc gets x on the run. The
// window of x around the run is read first, every load independent:
// 16-byte loads on an inner run of an aligned level, loads guarded by the
// grid's bounds on the others. Then node by node normal_apply.cuh's
// apply_at arithmetic with x from the window: the smoothness order by order
// through axis_normal's windows, then + the data term in offset_list order,
// pairs that leave the grid skipped. With a run mask (level 0), a run whose
// bit is clear skips the data term: its coefficients are zeros, whose
// products would sum to +0 for a finite x, so the bits are the same.
template <int R, bool D>
__device__ __forceinline__ float4 apply_run(const ApplyOp& op, const float* __restrict__ x,
                                            int i0, int j, int base, int cnt, bool inner,
                                            bool vec, const unsigned* __restrict__ mask,
                                            float4& xc) {
    const int n0 = op.n0, n1 = op.n1;
    const float* w2 = op.w2;
    float row[12];  // row i0, columns j-4 .. j+7
    float4 u1, d1, u2{}, d2{}, u3{}, d3{};
    float ue0, ue5, de0, de5;  // rows i0 ± 1 at columns j-1 and j+4
    if (inner) {
        const bool v = vec;
        const float4 a = ld4(x, base - 4, v, 4), b = ld4(x, base, v, 4), c = ld4(x, base + 4, v, 4);
        row[0] = a.x, row[1] = a.y, row[2] = a.z, row[3] = a.w;
        row[4] = b.x, row[5] = b.y, row[6] = b.z, row[7] = b.w;
        row[8] = c.x, row[9] = c.y, row[10] = c.z, row[11] = c.w;
        u1 = ld4(x, base - n1, v, 4);
        d1 = ld4(x, base + n1, v, 4);
        if (R >= 2) {
            u2 = ld4(x, base - 2 * n1, v, 4);
            d2 = ld4(x, base + 2 * n1, v, 4);
        }
        if (R >= 3) {
            u3 = ld4(x, base - 3 * n1, v, 4);
            d3 = ld4(x, base + 3 * n1, v, 4);
        }
        ue0 = x[base - n1 - 1], ue5 = x[base - n1 + 4];
        de0 = x[base + n1 - 1], de5 = x[base + n1 + 4];
    } else {
#pragma unroll
        for (int c = 0; c < 12; ++c) row[c] = ld_in(x, base, i0, j, 0, c - 4, n0, n1);
        u1 = ld4_in(x, base, i0, j, -1, n0, n1);
        d1 = ld4_in(x, base, i0, j, 1, n0, n1);
        if (R >= 2) {
            u2 = ld4_in(x, base, i0, j, -2, n0, n1);
            d2 = ld4_in(x, base, i0, j, 2, n0, n1);
        }
        if (R >= 3) {
            u3 = ld4_in(x, base, i0, j, -3, n0, n1);
            d3 = ld4_in(x, base, i0, j, 3, n0, n1);
        }
        ue0 = ld_in(x, base, i0, j, -1, -1, n0, n1), ue5 = ld_in(x, base, i0, j, -1, 4, n0, n1);
        de0 = ld_in(x, base, i0, j, 1, -1, n0, n1), de5 = ld_in(x, base, i0, j, 1, 4, n0, n1);
    }
    xc = make_float4(row[4], row[5], row[6], row[7]);
    const float* __restrict__ cf = op.coeff + base;  // channel 0 at the run
    const int N = n0 * n1;
    float4 out;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const int i1 = j + k;
        const auto along0 = [&](int d) {
            return d == 0 ? row[4 + k]
                 : d == -1 ? at(u1, k) : d == 1 ? at(d1, k)
                 : d == -2 ? at(u2, k) : d == 2 ? at(d2, k)
                 : d == -3 ? at(u3, k) : at(d3, k);
        };
        const auto along1 = [&](int d) { return row[4 + k + d]; };
        float s = w2[0] != 0.f ? w2[0] * row[4 + k] : 0.f;
        if (w2[1] != 0.f)
            s += w2[1] * (axis_normal<2>(along0, i0, n0) + axis_normal<2>(along1, i1, n1));
        if (R >= 2 && w2[2] != 0.f)
            s += w2[2] * (axis_normal<3>(along0, i0, n0) + axis_normal<3>(along1, i1, n1));
        if (R >= 3 && w2[3] != 0.f)
            s += w2[3] * (axis_normal<4>(along0, i0, n0) + axis_normal<4>(along1, i1, n1));
        at(out, k) = s;
    }
    if (D) {
        const float4 c4 = ld4(cf, 0, vec, cnt);
#pragma unroll
        for (int k = 0; k < 4; ++k) at(out, k) += at(c4, k) * row[4 + k];
        return out;
    }
    const int q = i0 * runs_per_row(n1) + j / kRun;
    const bool has = mask == nullptr || ((mask[q >> 5] >> (q & 31)) & 1u);
    // Data rows i0 ± 1 over columns j-1 .. j+4.
    const float um[6] = {ue0, u1.x, u1.y, u1.z, u1.w, ue5};
    const float dm[6] = {de0, d1.x, d1.y, d1.z, d1.w, de5};
    float4 data = make_float4(0.f, 0.f, 0.f, 0.f);
    if (has) {
#pragma unroll
        for (int o = 0; o < 9; ++o) {
            const float4 co = ld4(cf, o * N, vec, cnt);
            const int d0 = o / 3 - 1, dd = o % 3 - 1;
#pragma unroll
            for (int k = 0; k < 4; ++k) {
                const int r0 = i0 + d0, r1 = j + k + dd;
                if (!inner && (r0 < 0 || r0 >= n0 || r1 < 0 || r1 >= n1)) continue;
                const float xv = d0 < 0 ? um[1 + k + dd]
                               : (d0 > 0 ? dm[1 + k + dd] : row[4 + k + dd]);
                at(data, k) += at(co, k) * xv;
            }
        }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) at(out, k) += at(data, k);
    return out;
}

// f(IC<R>, IC<D>) with the level's reach and data form as constants.
template <class F>
__device__ __forceinline__ void dispatch(int R, bool diag, F f) {
    if (diag) {
        if (R <= 1) f(IC<1>{}, IC<1>{});
        else if (R == 2) f(IC<2>{}, IC<1>{});
        else f(IC<3>{}, IC<1>{});
    } else {
        if (R <= 1) f(IC<1>{}, IC<0>{});
        else if (R == 2) f(IC<2>{}, IC<0>{});
        else f(IC<3>{}, IC<0>{});
    }
}

// ------------------------------------------------------------- the phases

// Sweep k on level l: z_out = z_in + sid·(r − A z_in) (Jacobi) or z_in +
// c1_k·(z_in − z_prev) + c2_k·sid·(r − A z_in) (Chebyshev); z_in == nullptr:
// z_out = c2_k·sid·r; z_prev == nullptr: 0 (it may be z_out). With want_dot,
// this thread's Σ r·z_out goes to red[kRZ].
template <int T>
__device__ void sweep(Lane& L, int l, const float* zin, const float* zprev, float* zout,
                      int k, bool want_dot) {
    const Level lv = L.cyc.lv[l];
    const bool vec = L.vec[l];
    const unsigned* mask = l == 0 ? L.mask : nullptr;
    const bool cheb = lv.cf != nullptr;
    const float c1 = cheb ? lv.cf[2 * k] : 0.f;
    const float c2 = cheb ? lv.cf[2 * k + 1] : 1.f;
    Dot<T> acc;
    dispatch(L.reach[l], lv.op.diag, [&](auto RR, auto DD) {
        constexpr int R = decltype(RR)::value;
        constexpr bool D = decltype(DD)::value;
        for_runs<T>(lv.op, R, [&](int i0, int j, int base, int cnt, bool inner) {
            const float4 r = ld4(lv.r, base, vec, cnt);
            const float4 sid = ld4(lv.sid, base, vec, cnt);
            float4 z;
            if (zin == nullptr) {
#pragma unroll
                for (int q = 0; q < 4; ++q) at(z, q) = c2 * (at(sid, q) * at(r, q));
            } else {
                const float4 zp = (cheb && zprev) ? ld4(zprev, base, vec, cnt)
                                                  : make_float4(0.f, 0.f, 0.f, 0.f);
                float4 zi;
                const float4 ax = apply_run<R, D>(lv.op, zin, i0, j, base, cnt, inner, vec,
                                                  mask, zi);
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    const float res = at(sid, q) * (at(r, q) - at(ax, q));
                    at(z, q) = cheb ? at(zi, q) + (c1 * (at(zi, q) - at(zp, q)) + c2 * res)
                                    : at(zi, q) + res;
                }
            }
            st4(zout, base, vec, cnt, z);
            if (want_dot) {
                for (int q = 0; q < cnt; ++q) acc.cur() += at(r, q) * at(z, q);
                acc.next();
            }
        });
    });
    if (want_dot) put<T>(L, kRZ, acc);
}

// The residual a restriction reads: az = r − A z on level l.
template <int T>
__device__ void residual(Lane& L, int l, const float* z) {
    const Level lv = L.cyc.lv[l];
    const bool vec = L.vec[l];
    const unsigned* mask = l == 0 ? L.mask : nullptr;
    dispatch(L.reach[l], lv.op.diag, [&](auto RR, auto DD) {
        constexpr int R = decltype(RR)::value;
        constexpr bool D = decltype(DD)::value;
        for_runs<T>(lv.op, R, [&](int i0, int j, int base, int cnt, bool inner) {
            const float4 r = ld4(lv.r, base, vec, cnt);
            float4 zc;
            const float4 ax = apply_run<R, D>(lv.op, z, i0, j, base, cnt, inner, vec, mask, zc);
            float4 res;
#pragma unroll
            for (int q = 0; q < 4; ++q) at(res, q) = at(r, q) - at(ax, q);
            st4(lv.az, base, vec, cnt, res);
        });
    });
}

// r −= A z on level l (the W step's residual update; r is not read by the
// apply, so no other thread needs the old value).
template <int T>
__device__ void residual_update(Lane& L, int l, const float* z) {
    const Level lv = L.cyc.lv[l];
    const bool vec = L.vec[l];
    const unsigned* mask = l == 0 ? L.mask : nullptr;
    dispatch(L.reach[l], lv.op.diag, [&](auto RR, auto DD) {
        constexpr int R = decltype(RR)::value;
        constexpr bool D = decltype(DD)::value;
        for_runs<T>(lv.op, R, [&](int i0, int j, int base, int cnt, bool inner) {
            const float4 r = ld4(lv.r, base, vec, cnt);
            float4 zc;
            const float4 ax = apply_run<R, D>(lv.op, z, i0, j, base, cnt, inner, vec, mask, zc);
            float4 out;
#pragma unroll
            for (int q = 0; q < 4; ++q) at(out, q) = at(r, q) - at(ax, q);
            st4(lv.r, base, vec, cnt, out);
        });
    });
}

template <int T>
__device__ void fill_zero(Lane& L, int l, float* z) {
    const Level lv = L.cyc.lv[l];
    const bool vec = L.vec[l];
    for_runs<T>(lv.op, 1, [&](int, int, int base, int cnt, bool) {
        st4(z, base, vec, cnt, make_float4(0.f, 0.f, 0.f, 0.f));
    });
}

// r_c = R0 · (r_f − A z_f) · R1ᵀ from level l's residual (its az) over the
// bands, one coarse node per work item.
template <int T>
__device__ void restrict_phase(Lane& L, int l) {
    const Level& f = L.cyc.lv[l];
    const float* __restrict__ res = f.az;
    float* __restrict__ rc = L.cyc.lv[l + 1].r;
    const Bands b0 = L.bands[l][0], b1 = L.bands[l][1];
    const int nf1 = f.op.n1, nc1 = L.cyc.lv[l + 1].op.n1;
    const int nc = nodes(L.cyc.lv[l + 1]);
    for (int jj = threadIdx.x; jj < nc; jj += T) {
        const int j0 = jj / nc1, j1 = jj - j0 * nc1;
        const int s0 = b0.rs[j0], c0 = b0.rc[j0];
        const int s1 = b1.rs[j1], c1 = b1.rc[j1];
        float acc = 0.f;
#pragma unroll
        for (int a = 0; a < kSpanR; ++a) {
            if (a >= c0) break;
            const float* rrow = res + (s0 + a) * nf1 + s1;
            float row = 0.f;
#pragma unroll
            for (int bb = 0; bb < kSpanR; ++bb) {
                if (bb >= c1) break;
                row += b1.rw[j1 * kSpanR + bb] * rrow[bb];
            }
            acc += b0.rw[j0 * kSpanR + a] * row;
        }
        rc[jj] = acc;
    }
}

// z_f += R0ᵀ · z_c · R1 over the bands on level l; with want_dot this
// thread's Σ r·z_f goes to red[kRZ].
template <int T>
__device__ void prolong_phase(Lane& L, int l, const float* zc, float* zf, bool want_dot) {
    const Level f = L.cyc.lv[l];
    const bool vec = L.vec[l];
    const Bands b0 = L.bands[l][0], b1 = L.bands[l][1];
    const int nc1 = L.cyc.lv[l + 1].op.n1;
    Dot<T> dot;
    for_runs<T>(f.op, 1, [&](int i0, int j, int base, int cnt, bool) {
        float4 z = ld4(zf, base, vec, cnt);
        const float4 r = want_dot ? ld4(f.r, base, vec, cnt) : make_float4(0.f, 0.f, 0.f, 0.f);
        const int s0 = b0.ps[i0], c0 = b0.pc[i0];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            if (q >= cnt) break;
            const int i1 = j + q;
            const int s1 = b1.ps[i1], c1 = b1.pc[i1];
            float acc = 0.f;
#pragma unroll
            for (int a = 0; a < kSpanP; ++a) {
                if (a >= c0) break;
                const float* zrow = zc + (s0 + a) * nc1 + s1;
                float row = 0.f;
#pragma unroll
                for (int bb = 0; bb < kSpanP; ++bb) {
                    if (bb >= c1) break;
                    row += b1.pw[i1 * kSpanP + bb] * zrow[bb];
                }
                acc += b0.pw[i0 * kSpanP + a] * row;
            }
            at(z, q) = at(z, q) + acc;
            if (want_dot) dot.cur() += at(r, q) * at(z, q);
        }
        if (want_dot) dot.next();
        st4(zf, base, vec, cnt, z);
    });
    if (want_dot) put<T>(L, kRZ, dot);
}

// z_c = inv · r_c into the coarsest level's za: a warp takes four rows at
// a time, its lanes striding the columns, so that a lane's loads of the
// four rows are in flight together; one shuffle tree per row.
template <int T>
__device__ void coarse_phase(Lane& L) {
    const Level& cl = L.cyc.lv[L.cyc.L - 1];
    const int Nc = nodes(cl);
    const float* __restrict__ inv = L.cyc.inv;
    const float* __restrict__ r = cl.r;
    const int lane = threadIdx.x & 31;
    for (int row = 4 * (threadIdx.x >> 5); row < Nc; row += 4 * (T / 32)) {
        const int rows = min(4, Nc - row);
        const float* irow = inv + static_cast<size_t>(row) * Nc;
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
        for (int k = lane; k < Nc; k += 32) {
            const float rk = r[k];
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (q < rows) acc[q] += irow[q * Nc + k] * rk;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            float v = acc[q];
            for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0 && q < rows) cl.za[row + q] = v;
        }
    }
}

// ν pre-sweeps on level l from zero; returns the buffer holding the
// result. first_done: sweep 0 (c2_0·sid·r, pointwise) is already in za.
template <int T>
__device__ float* pre_smooth(Lane& L, int l, int nu, bool first_done) {
    const Level& lv = L.cyc.lv[l];
    if (nu == 0) {
        fill_zero<T>(L, l, lv.za);
        __syncthreads();
        return lv.za;
    }
    float* cur = first_done ? lv.za : nullptr;
    const float* prev = nullptr;
    for (int k = first_done ? 1 : 0; k < nu; ++k) {
        float* nxt = cur ? other(lv, cur) : lv.za;
        sweep<T>(L, l, cur, prev, nxt, k, false);
        __syncthreads();
        prev = cur;
        cur = nxt;
    }
    return cur;
}

// One cycle on lv[0].r (mg_cycle2d.cuh:cycle's schedule); returns the buffer
// holding z_0, with this thread's share of Σ r·z_0 in red[kRZ] (read after
// the last barrier). z0_first: level 0's sweep 0 is already in its za.
template <int T>
__device__ const float* cycle(Lane& L, bool z0_first) {
    const Cycle& c = L.cyc;
    const int Lv = c.L;
    float* z[kMaxLevels];
    int visits[kMaxLevels];
    int l = 0;
    for (;;) {
        for (; l < Lv - 1; ++l) {                          // down: pre-smooth, restrict
            z[l] = pre_smooth<T>(L, l, c.nu_pre, l == 0 && z0_first);
            residual<T>(L, l, z[l]);
            __syncthreads();
            restrict_phase<T>(L, l);
            __syncthreads();
            visits[l] = 0;
        }
        coarse_phase<T>(L);                                // coarsest: dense solve
        __syncthreads();
        z[Lv - 1] = c.lv[Lv - 1].za;
        for (l = Lv - 2;; --l) {                           // up: prolong-add, post-smooth
            const bool again = visits[l] == 0 && l < c.wdepth && l + 1 < Lv - 1;
            ++visits[l];
            const bool last = l == 0 && c.nu_post == 0 && !again;
            prolong_phase<T>(L, l, z[l + 1], z[l], last);
            if (again) residual_update<T>(L, l + 1, z[l + 1]);
            __syncthreads();
            if (again) break;                              // W: visit level l+1 again
            const Level& lv = c.lv[l];
            float* cur = z[l];
            const float* prev = cur;  // Chebyshev from z: z_prev = z
            for (int k = 0; k < c.nu_post; ++k) {
                const bool want = l == 0 && k == c.nu_post - 1;
                float* nxt = other(lv, cur);
                sweep<T>(L, l, cur, prev, nxt, k, want);
                __syncthreads();
                prev = cur;
                cur = nxt;
            }
            z[l] = cur;
            if (l == 0) return z[0];
        }
        ++l;
    }
}

// Level 0's run mask: bit q of L.mask is set where run q holds a nonzero
// data coefficient (NaN included); a warp writes one word at a time, and
// L.runs counts the set bits.
template <int T>
__device__ void mark_runs(Lane& L) {
    const ApplyOp& op = L.cyc.lv[0].op;
    const bool vec = L.vec[0];
    const int n1 = op.n1, N = op.n0 * n1;
    const int rpr = runs_per_row(n1), runs = op.n0 * rpr;
    for (int w = threadIdx.x >> 5; 32 * w < runs; w += T / 32) {
        const int q = 32 * w + (threadIdx.x & 31);
        bool data = false;
        if (q < runs) {
            const int i0 = q / rpr, j = (q - i0 * rpr) * kRun;
            const int base = i0 * n1 + j, cnt = min(kRun, n1 - j);
#pragma unroll
            for (int o = 0; o < 9; ++o) {
                const float4 c = ld4(op.coeff, o * N + base, vec, cnt);
                data |= (c.x != 0.f) | (c.y != 0.f) | (c.z != 0.f) | (c.w != 0.f);
            }
        }
        const unsigned word = __ballot_sync(0xffffffffu, data);
        if ((threadIdx.x & 31) == 0) {
            L.mask[w] = word;
            atomicAdd(&L.runs, __popc(word));
        }
    }
}

// The segment on one lane (pcg_segment.cu:segment's loop and exits). Level
// 0's sweep 0 from zero is written by the phases that write r, so the
// cycle starts at sweep 1. A lane that runs a cycle marks its runs first.
template <int T>
__device__ void segment(Lane& L) {
    const Level l0 = L.cyc.lv[0];
    const bool vec = L.vec[0];
    const bool fuse = L.cyc.nu_pre > 0;
    const float c2 = l0.cf ? l0.cf[1] : 1.f;
    const float tol2 = L.tol2;
    const int budget = L.budget;
    Dot<T> acc;
    for_runs<T>(l0.op, 1, [&](int, int, int base, int cnt, bool) {
        st4(L.x, base, vec, cnt, ld4(L.x_in, base, vec, cnt));
        const float4 r = ld4(L.r_in, base, vec, cnt);
        st4(l0.r, base, vec, cnt, r);
        for (int q = 0; q < cnt; ++q) acc.cur() += at(r, q) * at(r, q);
        acc.next();
        if (fuse) {
            const float4 sid = ld4(l0.sid, base, vec, cnt);
            float4 z;
#pragma unroll
            for (int q = 0; q < 4; ++q) at(z, q) = c2 * (at(sid, q) * at(r, q));
            st4(l0.za, base, vec, cnt, z);
        }
    });
    put<T>(L, kRR, acc);
    __syncthreads();
    float rr = total(L, kRR);
    if (rr > tol2 && budget > 0) {
        mark_runs<T>(L);
        __syncthreads();
    }
    float rz = 0.f;
    int k = 0;
    for (;; ++k) {
        if (!(rr > tol2 && k < budget)) break;
        const float* z0 = cycle<T>(L, fuse);
        const float rz_new = total(L, kRZ);
        const float beta = (k > 0 && rz > 0.f) ? rz_new / rz : 0.f;
        const bool first = k == 0;
        for_runs<T>(l0.op, 1, [&](int, int, int base, int cnt, bool) {
            const float4 zv = ld4(z0, base, vec, cnt);
            float4 pv = zv;
            if (!first) {
                const float4 po = ld4(L.p, base, vec, cnt);
#pragma unroll
                for (int q = 0; q < 4; ++q) at(pv, q) = at(zv, q) + beta * at(po, q);
            }
            st4(L.p, base, vec, cnt, pv);
        });
        __syncthreads();
        rz = rz_new;
        Dot<T> pap_acc;
        dispatch(L.reach[0], false, [&](auto RR, auto) {
            constexpr int R = decltype(RR)::value;
            for_runs<T>(l0.op, R, [&](int i0, int j, int base, int cnt, bool inner) {
                float4 pv;
                const float4 ap = apply_run<R, false>(l0.op, L.p, i0, j, base, cnt,
                                                      inner, vec, L.mask, pv);
                st4(l0.az, base, vec, cnt, ap);
                for (int q = 0; q < cnt; ++q) pap_acc.cur() += at(pv, q) * at(ap, q);
                pap_acc.next();
            });
        });
        put<T>(L, kPAp, pap_acc);
        __syncthreads();
        const float pap = total(L, kPAp);
        const float alpha = pap > 0.f ? rz / pap : 0.f;
        Dot<T> rr_acc;
        for_runs<T>(l0.op, 1, [&](int, int, int base, int cnt, bool) {
            float4 xv = ld4(L.x, base, vec, cnt);
            const float4 pv = ld4(L.p, base, vec, cnt);
            float4 r = ld4(l0.r, base, vec, cnt);
            const float4 ap = ld4(l0.az, base, vec, cnt);
            const float4 sid = fuse ? ld4(l0.sid, base, vec, cnt)
                                    : make_float4(0.f, 0.f, 0.f, 0.f);
            float4 z;
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                at(xv, q) += alpha * at(pv, q);
                at(r, q) = at(r, q) - alpha * at(ap, q);
                at(z, q) = c2 * (at(sid, q) * at(r, q));
            }
            st4(L.x, base, vec, cnt, xv);
            st4(l0.r, base, vec, cnt, r);
            if (fuse) st4(l0.za, base, vec, cnt, z);
            for (int q = 0; q < cnt; ++q) rr_acc.cur() += at(r, q) * at(r, q);
            rr_acc.next();
        });
        put<T>(L, kRR, rr_acc);
        __syncthreads();
        rr = total(L, kRR);
    }
    if (threadIdx.x == 0) {
        *L.iters_out = k;
        *L.rr_out = rr;
        *L.runs_out = L.runs;
    }
}

// ------------------------------------------------------------ the set-up

__device__ __forceinline__ bool aligned16(const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}

// Thread 0: the lane's pointers in shared memory (level 0's run mask, and
// the levels and buffers the plan puts there), and per level its alignment
// and reach. `glob` gets the global data and D⁻¹ of each level moved to
// shared memory (for the copy).
__device__ inline void place(Lane& L, float* dyn, const Layout& lay, const float** glob) {
    Cycle& c = L.cyc;
    for (int t = 0; t < c.L - 1; ++t) {
        for (int d = 0; d < 2; ++d) {
            const int nf = d ? c.lv[t].op.n1 : c.lv[t].op.n0;
            const int nc = d ? c.lv[t + 1].op.n1 : c.lv[t + 1].op.n0;
            float* w = dyn + lay.band[t][d];
            Bands& b = L.bands[t][d];
            b.rs = reinterpret_cast<int*>(w);
            b.rc = reinterpret_cast<int*>(w + round4(nc));
            b.rw = w + 2 * round4(nc);
            w = b.rw + nc * kSpanR;
            b.ps = reinterpret_cast<int*>(w);
            b.pc = reinterpret_cast<int*>(w + round4(nf));
            b.pw = w + 2 * round4(nf);
        }
    }
    L.mask = reinterpret_cast<unsigned*>(dyn + lay.mask);
    L.runs = 0;
    for (int l = 0; l < c.L; ++l) {
        Level& lv = c.lv[l];
        const int n = nodes(lv);
        glob[2 * l] = glob[2 * l + 1] = nullptr;
        if (lay.level[l] >= 0) {
            float* w = dyn + lay.level[l];
            lv.r = w;
            lv.za = w + round4(n);
            lv.zb = w + 2 * round4(n);
            lv.az = w + 3 * round4(n);
            glob[2 * l] = lv.sid;
            glob[2 * l + 1] = lv.op.coeff;
            lv.sid = w + 4 * round4(n);
            lv.op.coeff = w + 5 * round4(n);
        }
        if (l == 0 && lay.az0 >= 0) lv.az = dyn + lay.az0;
        const float* w2 = lv.op.w2;
        L.reach[l] = w2[3] != 0.f ? 3 : (w2[2] != 0.f ? 2 : 1);
        bool v = lv.op.n1 % 4 == 0 && aligned16(lv.op.coeff) && aligned16(lv.sid)
                 && aligned16(lv.r) && aligned16(lv.za) && aligned16(lv.zb) && aligned16(lv.az);
        if (l == 0)
            v = v && aligned16(L.x_in) && aligned16(L.r_in) && aligned16(L.x) && aligned16(L.p);
        L.vec[l] = v;
    }
}

// Every thread: the bands from the host's tables and the dense Rs, and the
// planned levels' data and D⁻¹ copied in (`glob` from place()).
template <int T>
__device__ inline void fill_shared(Lane& L, const float* const* glob) {
    const Cycle& c = L.cyc;
    for (int t = 0; t < c.L - 1; ++t) {
        for (int d = 0; d < 2; ++d) {
            const int nf = d ? c.lv[t].op.n1 : c.lv[t].op.n0;
            const int nc = d ? c.lv[t + 1].op.n1 : c.lv[t + 1].op.n0;
            const float* R = d ? c.tr[t].R1 : c.tr[t].R0;   // [nc, nf]
            const int* rb = d ? c.tr[t].rb1 : c.tr[t].rb0;
            const int* pb = d ? c.tr[t].pb1 : c.tr[t].pb0;
            const Bands& b = L.bands[t][d];
            for (int jc = threadIdx.x; jc < nc; jc += T) {
                const int s = rb[2 * jc], cnt = rb[2 * jc + 1];
                b.rs[jc] = s;
                b.rc[jc] = cnt;
                for (int q = 0; q < kSpanR; ++q)
                    b.rw[jc * kSpanR + q] = q < cnt ? R[jc * nf + s + q] : 0.f;
            }
            for (int i = threadIdx.x; i < nf; i += T) {
                const int s = pb[2 * i], cnt = pb[2 * i + 1];
                b.ps[i] = s;
                b.pc[i] = cnt;
                for (int q = 0; q < kSpanP; ++q)
                    b.pw[i * kSpanP + q] = q < cnt ? R[(s + q) * nf + i] : 0.f;
            }
        }
    }
    for (int l = 1; l < c.L; ++l) {
        if (glob[2 * l] == nullptr) continue;
        const Level& lv = c.lv[l];
        const int n = nodes(lv);
        float* sid = const_cast<float*>(lv.sid);
        float* coeff = const_cast<float*>(lv.op.coeff);
        for (int i = threadIdx.x; i < n; i += T) sid[i] = glob[2 * l][i];
        const int m = lv.op.diag ? n : 9 * n;
        for (int i = threadIdx.x; i < m; i += T) coeff[i] = glob[2 * l + 1][i];
    }
}

}  // namespace lane2d
