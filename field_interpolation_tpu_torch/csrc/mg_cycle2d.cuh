// One symmetric multigrid cycle (V or W) on a 2-D hierarchy, damped-Jacobi
// or Chebyshev smoothing, run either by every block of a cooperative grid
// with grid barriers between dependent phases (GridSync: the single-field
// PCG segment kernel, pcg_segment.cu, which runs it as its preconditioner,
// and the whole-cycle kernel, mg_cycle2d.cu) or by one block with block
// barriers (BlockSync: one lane of the batched PCG segment kernel, which
// hands each block its lane's Cycle). The phases are the same code either
// way; the policy says which threads share a phase and how it ends.
//
// The cycle of field_interpolation_tpu/ops/pallas_stencil.py:_vcycle_refs
// (1439-1481) with _lvl_smooth (1037-1049: _smooth_inplace 1016-1027 or
// _cheb_inplace 483-507) and the in-kernel coarse solve (1426-1436); with
// wdepth = 0 it is also _vc_down_call (1052) + the dense coarsest matvec +
// _vc_up_call (1114) of fused_vcycle_2d (1172).
//
// Chebyshev (a level whose schedule pointer cf is set): sweep k is
// z⁺ = z + c1_k·(z − z_prev) + c2_k·sid·(r − A z) with sid = D⁻¹ and the
// [ν, 2] schedule read from device memory, the same row for every thread,
// so the mode branch is uniform. z_prev needs no third buffer: the sweep
// writes z⁺ into the ping-pong buffer that holds z_prev, each thread
// reading z_prev at its own node before writing there, neighbours reading z.
// Pre-smoothing starts from z = z_prev = 0, post-smoothing from z_prev = z.
//
// The W step (wdepth > 0): after level l's first child visit is prolonged
// and added into z_l, r_{l+1} −= A_{l+1} z_{l+1} and level l+1 is visited
// again from zero, then prolonged and added again; for l < wdepth and
// l + 1 < L − 1. It needs no extra buffers: the first result is added into
// z_l before the second visit reuses level l+1's buffers.
//
// The visits follow from L, ν and wdepth alone, so every block walks the
// same schedule and reaches the same barriers. The schedule is walked
// iteratively (a descent, then an ascent that may turn back down), with
// one small per-level table, not by device recursion.
#pragma once

#include <cooperative_groups.h>

#include <cstdint>

#include "normal_apply.cuh"

namespace mg2d {

namespace cg = cooperative_groups;

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;  // power of two: block_sum's tree needs it

struct Level {
    ApplyOp op;         // this level's operator (9-channel data or diagonal)
    const float* sid;   // τ_l · D_l⁻¹ (Jacobi) or D_l⁻¹ (Chebyshev)
    const float* cf;    // [ν, 2] Chebyshev schedule; null: damped Jacobi
    float* r;           // residual (level 0: the cycle's input, never written)
    float* za;          // ping-pong correction buffers
    float* zb;
    float* az;          // A z scratch
};

struct Transfer {       // level l (fine, nf0×nf1) ↔ level l+1 (coarse, nc0×nc1)
    const float* R0;    // [nc0, nf0] = _resize_matrix(nf0, nc0).T
    const float* R1;    // [nc1, nf1]
    const int* rb0;     // [nc0, 2] per coarse index: first fine index, span
    const int* rb1;     // [nc1, 2]
    const int* pb0;     // [nf0, 2] per fine index: first coarse index, span
    const int* pb1;     // [nf1, 2]
};

struct Cycle {
    int L, nu_pre, nu_post, wdepth;
    Level lv[kMaxLevels];
    Transfer tr[kMaxLevels - 1];
    const float* inv;   // [Nc, Nc] dense inverse of the coarsest operator
};

// Who runs a phase: tid()/stride() spread a level's nodes over the threads
// that share it, sync() ends the phase, and a dot product's share of the
// block goes to partials[part()] of parts() (total() sums them).
struct GridSync {       // every block of a cooperative grid
    static constexpr bool kOneBlock = false;
    cg::grid_group g;
    __device__ int tid() const { return blockIdx.x * blockDim.x + threadIdx.x; }
    __device__ int stride() const { return gridDim.x * blockDim.x; }
    __device__ void sync() { g.sync(); }
    __device__ int part() const { return blockIdx.x; }
    __device__ int parts() const { return gridDim.x; }
};

struct BlockSync {      // one block on its own (one lane of a batch)
    static constexpr bool kOneBlock = true;
    __device__ int tid() const { return threadIdx.x; }
    __device__ int stride() const { return blockDim.x; }
    __device__ void sync() { __syncthreads(); }
    __device__ int part() const { return 0; }
    __device__ int parts() const { return 1; }
};

__host__ __device__ __forceinline__ int nodes(const Level& lv) { return lv.op.n0 * lv.op.n1; }
// The ping-pong buffer that does not hold z.
__device__ __forceinline__ float* other(const Level& lv, const float* z) {
    return z == lv.za ? lv.zb : lv.za;
}

// Fixed-order tree sum over the block; every thread gets the result.
static __device__ float block_sum(float v, float* sh) {
    sh[threadIdx.x] = v;
    __syncthreads();
    for (int s = kThreads / 2; s > 0; s >>= 1) {
        if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
        __syncthreads();
    }
    const float r = sh[0];
    __syncthreads();
    return r;
}

// This block's share of a sum over the phase's threads, into
// partials[s.part()].
template <class S>
static __device__ void write_partial(const S& s, float* partials, float v, float* sh) {
    const float t = block_sum(v, sh);
    if (threadIdx.x == 0) partials[s.part()] = t;
}

// After the barrier that follows write_partial: every block sums the
// partials in the same order, so all blocks hold the same bits and take the
// same branch. One block's total is its one partial.
template <class S>
static __device__ float total(const S& s, const float* partials, float* sh) {
    if constexpr (S::kOneBlock) {
        return partials[0];
    } else {
        float v = 0.f;
        for (int i = threadIdx.x; i < s.parts(); i += kThreads) v += partials[i];
        return block_sum(v, sh);
    }
}

// Sweep k on level lv: z_out = z_in + sid·(r − A z_in) (Jacobi) or
// z_in + c1_k·(z_in − z_prev) + c2_k·sid·(r − A z_in) (Chebyshev). z_in ==
// nullptr means z_in = 0, so the first sweep from zero is z_out = sid·r
// (c2_0·sid·r; pallas_stencil.py:1019-1024, 491-497); z_prev == nullptr
// means z_prev = 0, and z_prev may be z_out. Returns this thread's share of
// Σ r·z_out when want_dot.
template <class S>
static __device__ float sweep(const S& s, const Level& lv, const float* zin,
                              const float* zprev, float* zout, int k, bool want_dot) {
    const int N = nodes(lv), n1 = lv.op.n1;
    const bool cheb = lv.cf != nullptr;
    const float c1 = cheb ? lv.cf[2 * k] : 0.f;
    const float c2 = cheb ? lv.cf[2 * k + 1] : 1.f;
    float acc = 0.f;
    for (int i = s.tid(); i < N; i += s.stride()) {
        const float r = lv.r[i];
        float z;
        if (zin == nullptr) {
            z = c2 * (lv.sid[i] * r);
        } else {
            const float zi = zin[i];
            const float res = lv.sid[i] * (r - apply_at(lv.op, zin, i / n1, i % n1));
            z = cheb ? zi + (c1 * (zi - (zprev ? zprev[i] : 0.f)) + c2 * res) : zi + res;
        }
        zout[i] = z;
        if (want_dot) acc += r * z;
    }
    return acc;
}

template <class S>
static __device__ void fill_zero(const S& s, const Level& lv, float* z) {
    for (int i = s.tid(); i < nodes(lv); i += s.stride()) z[i] = 0.f;
}

template <class S>
static __device__ void apply_phase(const S& s, const Level& lv, const float* z, float* az) {
    const int N = nodes(lv), n1 = lv.op.n1;
    for (int i = s.tid(); i < N; i += s.stride()) az[i] = apply_at(lv.op, z, i / n1, i % n1);
}

// r −= A z on one level (the W step's residual update; r is not read by
// the apply, so no other thread needs the old value).
template <class S>
static __device__ void residual_update(const S& s, const Level& lv, const float* z) {
    const int N = nodes(lv), n1 = lv.op.n1;
    for (int i = s.tid(); i < N; i += s.stride()) lv.r[i] -= apply_at(lv.op, z, i / n1, i % n1);
}

// r_c = R0 · (r_f − A z_f) · R1ᵀ over the bands of R0 and R1.
template <class S>
static __device__ void restrict_phase(const S& s, const Cycle& c, int l) {
    const Level& f = c.lv[l];
    const Level& cl = c.lv[l + 1];
    const Transfer& t = c.tr[l];
    const int nf0 = f.op.n0, nf1 = f.op.n1, nc1 = cl.op.n1;
    for (int jj = s.tid(); jj < nodes(cl); jj += s.stride()) {
        const int j0 = jj / nc1, j1 = jj % nc1;
        const int s0 = t.rb0[2 * j0], c0 = t.rb0[2 * j0 + 1];
        const int s1 = t.rb1[2 * j1], c1 = t.rb1[2 * j1 + 1];
        float acc = 0.f;
        for (int a = 0; a < c0; ++a) {
            const int i0 = s0 + a;
            float row = 0.f;
            for (int b = 0; b < c1; ++b) {
                const int i = i0 * nf1 + s1 + b;
                row += t.R1[j1 * nf1 + s1 + b] * (f.r[i] - f.az[i]);
            }
            acc += t.R0[j0 * nf0 + i0] * row;
        }
        cl.r[jj] = acc;
    }
}

// z_f += R0ᵀ · z_c · R1 over the bands; returns Σ r·z_f when want_dot.
template <class S>
static __device__ float prolong_phase(const S& s, const Cycle& c, int l, const float* zc,
                                      float* zf, bool want_dot) {
    const Level& f = c.lv[l];
    const Transfer& t = c.tr[l];
    const int nf0 = f.op.n0, nf1 = f.op.n1, nc1 = c.lv[l + 1].op.n1;
    float dot = 0.f;
    for (int ii = s.tid(); ii < nodes(f); ii += s.stride()) {
        const int i0 = ii / nf1, i1 = ii % nf1;
        const int s0 = t.pb0[2 * i0], c0 = t.pb0[2 * i0 + 1];
        const int s1 = t.pb1[2 * i1], c1 = t.pb1[2 * i1 + 1];
        float acc = 0.f;
        for (int a = 0; a < c0; ++a) {
            const int j0 = s0 + a;
            float row = 0.f;
            for (int b = 0; b < c1; ++b) {
                const int j1 = s1 + b;
                row += t.R1[j1 * nf1 + i1] * zc[j0 * nc1 + j1];
            }
            acc += t.R0[j0 * nf0 + i0] * row;
        }
        const float z = zf[ii] + acc;
        zf[ii] = z;
        if (want_dot) dot += f.r[ii] * z;
    }
    return dot;
}

// z_c = inv · r_c into the coarsest level's za, one warp per row, lanes
// striding the columns.
template <class S>
static __device__ void coarse_phase(const S& s, const Cycle& c) {
    const Level& cl = c.lv[c.L - 1];
    const int Nc = nodes(cl);
    const int lane = threadIdx.x & 31;
    for (int row = s.tid() >> 5; row < Nc; row += s.stride() >> 5) {
        float acc = 0.f;
        for (int k = lane; k < Nc; k += 32) acc += c.inv[row * Nc + k] * cl.r[k];
        for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
        if (lane == 0) cl.za[row] = acc;
    }
}

// ν pre-sweeps on level l from zero; returns the buffer holding the result.
template <class S>
static __device__ float* pre_smooth(S& s, const Level& lv, int nu) {
    if (nu == 0) {
        fill_zero(s, lv, lv.za);
        s.sync();
        return lv.za;
    }
    float* cur = nullptr;        // null: the first sweep reads no z
    const float* prev = nullptr;  // Chebyshev's z_prev, 0 from zero
    for (int k = 0; k < nu; ++k) {
        float* nxt = cur ? other(lv, cur) : lv.za;
        sweep(s, lv, cur, prev, nxt, k, false);
        s.sync();
        prev = cur;
        cur = nxt;
    }
    return cur;
}

// One cycle on lv[0].r; returns the buffer holding z_0. With rz_partials,
// also leaves each block's share of Σ r·z_0 (from the last phase that
// writes z_0) in rz_partials[s.part()].
template <class S>
static __device__ const float* cycle(S& s, const Cycle& c, float* sh, float* rz_partials) {
    const int L = c.L;
    float* z[kMaxLevels];
    int visits[kMaxLevels];  // child visits finished in level l's current visit
    int l = 0;
    for (;;) {
        for (; l < L - 1; ++l) {                          // down: pre-smooth, restrict
            const Level& lv = c.lv[l];
            z[l] = pre_smooth(s, lv, c.nu_pre);
            apply_phase(s, lv, z[l], lv.az);
            s.sync();
            restrict_phase(s, c, l);
            s.sync();
            visits[l] = 0;
        }
        coarse_phase(s, c);                               // coarsest: dense solve
        s.sync();
        z[L - 1] = c.lv[L - 1].za;
        for (l = L - 2;; --l) {                           // up: prolong-add, post-smooth
            const bool again = visits[l] == 0 && l < c.wdepth && l + 1 < L - 1;
            ++visits[l];
            const bool last = l == 0 && c.nu_post == 0 && !again && rz_partials;
            const float d = prolong_phase(s, c, l, z[l + 1], z[l], last);
            if (again) residual_update(s, c.lv[l + 1], z[l + 1]);
            if (last) write_partial(s, rz_partials, d, sh);
            s.sync();
            if (again) break;                             // W: visit level l+1 again
            const Level& lv = c.lv[l];
            float* cur = z[l];
            const float* prev = cur;  // Chebyshev from z: z_prev = z
            for (int k = 0; k < c.nu_post; ++k) {
                const bool want = l == 0 && k == c.nu_post - 1 && rz_partials;
                float* nxt = other(lv, cur);
                const float ds = sweep(s, lv, cur, prev, nxt, k, want);
                if (want) write_partial(s, rz_partials, ds, sh);
                s.sync();
                prev = cur;
                cur = nxt;
            }
            z[l] = cur;
            if (l == 0) return z[0];
        }
        ++l;
    }
}

// ---------------------------------------------------------------- host side

template <typename T>
T* as_ptr(long long v) { return reinterpret_cast<T*>(static_cast<uintptr_t>(v)); }

// Fills c from the tables both entry points share (ops/cycle.py builds them):
//   lp: 6 pointers per level (coeff, sid, r, za, zb, az; r of level 0 is 0,
//       set by the caller), then 6 per transfer (R0, R1, rb0, rb1, pb0, pb1),
//       then 1 per level: its [ν, 2] Chebyshev schedule (0: damped Jacobi);
//   li: L, nu_pre, nu_post, wdepth, then (n0, n1, diag) per level;
//   w2s: 4 per level (w_k² for orders 0..3).
// Returns false on counts the kernels do not take.
static inline bool fill_cycle(Cycle& c, const long long* lp, const int* li,
                              const float* w2s, const float* inv) {
    c.L = li[0];
    c.nu_pre = li[1];
    c.nu_post = li[2];
    c.wdepth = li[3];
    c.inv = inv;
    if (c.L < 2 || c.L > kMaxLevels || c.nu_pre < 0 || c.nu_post < 0 || c.wdepth < 0)
        return false;
    for (int l = 0; l < c.L; ++l) {
        const long long* q = lp + 6 * l;
        Level& lv = c.lv[l];
        lv.op.coeff = as_ptr<const float>(q[0]);
        lv.sid = as_ptr<const float>(q[1]);
        lv.r = as_ptr<float>(q[2]);
        lv.za = as_ptr<float>(q[3]);
        lv.zb = as_ptr<float>(q[4]);
        lv.az = as_ptr<float>(q[5]);
        lv.op.n0 = li[4 + 3 * l];
        lv.op.n1 = li[5 + 3 * l];
        lv.op.diag = li[6 + 3 * l];
        for (int o = 0; o < 4; ++o) lv.op.w2[o] = w2s[4 * l + o];
        lv.cf = as_ptr<const float>(lp[12 * c.L - 6 + l]);
    }
    for (int t = 0; t < c.L - 1; ++t) {
        const long long* q = lp + 6 * c.L + 6 * t;
        Transfer& tr = c.tr[t];
        tr.R0 = as_ptr<const float>(q[0]);
        tr.R1 = as_ptr<const float>(q[1]);
        tr.rb0 = as_ptr<const int>(q[2]);
        tr.rb1 = as_ptr<const int>(q[3]);
        tr.pb0 = as_ptr<const int>(q[4]);
        tr.pb1 = as_ptr<const int>(q[5]);
    }
    return true;
}

// A cooperative launch needs every block resident at once: the grid is
// sized from the kernel's occupancy, never above it, nor above `want`
// (one thread per fine node) or `cap`.
static inline cudaError_t launch_cooperative(const void* kernel, void** args, int want,
                                             int cap, void* stream) {
    int dev = 0, coop = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    int blocks = per_sm * sms;
    if (blocks > want) blocks = want;
    if (blocks > cap) blocks = cap;
    err = cudaLaunchCooperativeKernel(kernel, dim3(blocks), dim3(kThreads), args, 0,
                                      static_cast<cudaStream_t>(stream));
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace mg2d
